"""The host input pipeline's sustained throughput (counterpart of the root
bench_input_pipeline.py).

    python -m visper_lm_tpu_torch.tools.bench_input_pipeline [--n 192]
        [--batch 8] [--workers 8] [--step-ms MS] [--smoke] [--device cuda|cpu]

The PT step runs its teachers on the card, so what can hold the card back is
the host: per step it decodes images, builds the tower's pixels, tokenizes
and masks the labels, builds splice plans, collates, and runs the three
teachers' pixel pipelines (DAv2 at 336 BGR, unCLIP at 224 resize + crop,
OneFormer at 768): `SupervisedDataset` -> `BatchIterator` ->
`models/teachers.teacher_batch`, the composition train/cli.py feeds the
trainer through its `PrefetchIterator`. On a synthetic dataset of 640 x 480
images it reports:

  * the raw sustained rate (images/s): one warm batch, then the rest of the
    epoch, no consumer;
  * a paced consumer through the same `PrefetchIterator` the trainer uses:
    each batch is copied to `--device` (as the train step copies it) and a
    simulated device step of --step-ms follows; the consumer's achieved step
    time says whether the prefetch hides the host at that rate (a stall is
    achieved > simulated).

Differences from the JAX script: the images are PNG (`data/image_io.write_png`;
the port reads PNG and .npy without PIL), drawn from the same
np.random.default_rng(0); the tokenizer is train/cli.py's whitespace
`FakeTokenizer`; the record has no `demand_*` / `sustains_*` fields (the JAX
script's were TPU rates) and names the device (`"device"`).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from visper_lm_tpu_torch.tools import device_name

# the PT step (config #1, B4 x T1024, save_gate, teachers in the step) of
# `tools/bench.py` at its defaults on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6)
PT_STEP_MS = 741.1

WORDS = ["a", "photo", "of", "the", "scene", "with", "objects", "people", "standing", "near",
         "buildings", "trees", "under", "sky", "and"]


def make_dataset(root: str, n: int, rng: np.random.Generator) -> str:
    """n synthetic 640 x 480 PNGs and LLaVA-558K-shaped caption conversations
    under root; the data.json path."""
    from visper_lm_tpu_torch.data.image_io import write_png

    records = []
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i in range(n):
        arr = rng.integers(0, 255, (480, 640, 3), np.uint8)
        name = f"images/{i:05d}.png"
        write_png(os.path.join(root, name), arr)
        caption = " ".join(rng.choice(WORDS, size=40))
        records.append({
            "id": str(i),
            "image": name,
            "conversations": [
                {"from": "human", "value": "<image>\nDescribe the image."},
                {"from": "gpt", "value": caption},
            ],
        })
    path = os.path.join(root, "data.json")
    with open(path, "w") as f:
        json.dump(records, f)
    return path


def measure(cfg, data_path: str, image_folder: str, n: int, batch: int, workers: int,
            step_ms: float, device: torch.device) -> Dict[str, Any]:
    """The raw and the paced phase over the dataset at data_path; the record."""
    from visper_lm_tpu_torch import native
    from visper_lm_tpu_torch.data.dataset import (
        RAW_IMAGES, BatchIterator, DataConfig, SupervisedDataset,
    )
    from visper_lm_tpu_torch.data.prefetch import PrefetchIterator
    from visper_lm_tpu_torch.models.teachers import teacher_batch
    from visper_lm_tpu_torch.train.cli import FakeTokenizer

    native.load()                                 # built here, not inside the timed phases
    ds = SupervisedDataset(DataConfig(data_path=data_path, image_folder=image_folder,
                                      image_size=cfg.vision.image_size), FakeTokenizer(), cfg)
    tasks = [t.task for t in cfg.distill.tasks]

    def batches(epoch: int):
        for b in BatchIterator(ds, batch, seed=epoch, distill_tasks=tasks, num_workers=workers):
            b.update(teacher_batch(cfg, b.pop(RAW_IMAGES), workers=workers))
            yield b

    # phase 1: the raw sustained rate, one warm batch then the rest of the epoch
    it = batches(0)
    first = next(it)
    if not {"depth_images", "gen_images", "seg_images"} <= set(first):
        raise RuntimeError(f"a PT batch without the teachers' pixels: {sorted(first)}")
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in it)
    raw_s = time.perf_counter() - t0
    raw_img_per_s = n_batches * batch / raw_s

    # phase 2: the paced consumer through the trainer's prefetch
    step_s = step_ms / 1000.0
    pf = PrefetchIterator(batches(1), depth=2)
    times = []
    t_prev = time.perf_counter()
    for b in pf:
        on_device = {k: torch.as_tensor(v).to(device) for k, v in b.items()}   # the step's copy
        time.sleep(step_s)                                          # the simulated device step
        del on_device
        now = time.perf_counter()
        times.append(now - t_prev)
        t_prev = now
    achieved = float(np.mean(times[1:])) if len(times) > 1 else float("nan")
    stall_ms = max(0.0, (achieved - step_s) * 1000)
    cores = os.cpu_count() or 1
    return {
        "metric": "input_pipeline_images_per_sec",
        "value": round(raw_img_per_s, 2),
        "unit": "images/s",
        "vs_baseline": None,
        "native_preprocess": True,                # the port has no other path
        "host_cores": cores,
        "host_ms_per_image_per_core": round(1000 * cores / raw_img_per_s, 1),
        "batch": batch,
        "workers": workers,
        "n_images": n,
        "image_px": "640x480 png",
        "paced_step_ms": step_ms,
        "paced_achieved_ms": round(achieved * 1000, 1),
        "paced_stall_ms_per_step": round(stall_ms, 1),
        "device": device_name(device),
    }


def build_argparser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults (--step-ms from this card), plus
    --device."""
    p = argparse.ArgumentParser(prog="python -m visper_lm_tpu_torch.tools.bench_input_pipeline")
    p.add_argument("--n", type=int, default=192, help="dataset images")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--step-ms", type=float, default=PT_STEP_MS,
                   help="simulated device step for the paced-consumer phase (default: "
                        "tools/bench.py's PT step on an NVIDIA H100 80GB HBM3 at 700 W)")
    p.add_argument("--smoke", action="store_true", help="24 images, batch 4, 2 workers")
    p.add_argument("--device", default="cuda", help="where the paced consumer copies each batch")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    from visper_lm_tpu_torch.config import phi3_clip_vlm, tiny_test_vlm
    from visper_lm_tpu_torch.device import resolve_device

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        args.n, args.batch, args.workers = 24, 4, 2
    cfg = tiny_test_vlm(distill=True) if args.smoke else phi3_clip_vlm(distill=True)
    with tempfile.TemporaryDirectory() as root:
        data_path = make_dataset(root, args.n, np.random.default_rng(0))
        record = measure(cfg, data_path, root, args.n, args.batch, args.workers, args.step_ms,
                         device)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
