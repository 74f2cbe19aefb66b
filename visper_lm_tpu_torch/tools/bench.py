"""PT-stage (distillation) train-step throughput on one card, examples/s
(counterpart of the root bench.py).

    python -m visper_lm_tpu_torch.tools.bench [--smoke] [--steps N] [--batch B]
        [--seq T] [--no-teachers] [--stage ...] [--device cuda|cpu]

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., ...}.

Workload: one complete PT-stage training step on config #1 (Phi3-mini-4k +
CLIP-ViT-L/14-336 + mlp2x projector + task tokens + the three distillation
heads + the frozen DINOv2-L, Swin-L@768 and CLIP-H teachers computing their
targets inside the step + NTP + smooth-L1 + contrastive losses + AdamW on the
trainable subset), bf16, through `train_step.make_train_step`, B4 x T1024 by
default. The batch is built in numpy from the JAX script's seeds.

Differences from the JAX script:
  * the record also names the device (`"device"`);
  * `mfu` / `mfu_student` are against the H100's dense bf16 peak (989
    TFLOP/s) on CUDA, None on the CPU;
  * there is no self-baseline file: `vs_baseline` is 1.0 and `baseline_kind`
    "none" (the JAX script's no-baseline form);
  * `--cost-analysis` reads XLA's cost model and raises here;
  * `--xla-attention` runs the decoder's attention on the plain path
    (`use_kernel=False`);
  * `--sweep` skips a batch that runs out of card memory
    (`torch.OutOfMemoryError`); any other failure propagates.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from visper_lm_tpu_torch.tools import device_name, sync

# the dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet)
H100_BF16_PEAK = 989e12
STAGE_TAGS = {"pretrain": "pt", "finetune": "ift", "lora": "lora_ift", "vision_tower": "vt"}


def build_bench_cfg(smoke: bool, stage: str = "pretrain", tower: str = "clip"):
    """The tiny config (smoke), else config #1; LoRA r 64 for the lora stage,
    the ConvNeXt-XXL trunk at 768 px for tower "convnext"."""
    from visper_lm_tpu_torch.config import (
        LoraConfig, phi3_clip_vlm, tiny_test_vlm, with_convnext_tower,
    )

    if smoke:
        return tiny_test_vlm(distill=stage == "pretrain")
    cfg = phi3_clip_vlm(distill=stage == "pretrain")
    if stage == "lora":
        cfg = dataclasses.replace(cfg, lora=LoraConfig())
    if tower == "convnext":
        cfg = with_convnext_tower(cfg)
    return cfg


def build_batch(cfg, batch_size: int, seq_len: int, anyres_tiles: int = 0,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """Right-padded splice plans of random text around one image, the
    images, and each task's mask, from np.random.default_rng(seed) (the JAX
    script's seed 0; another seed gives another batch of the same kind).
    anyres_tiles > 0: a base image + that many tiles per sample through the
    tower, with a flat gather plan over all tile rows."""
    from visper_lm_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from visper_lm_tpu_torch.data.collate import build_splice_plan, collate_plans

    rng = np.random.default_rng(seed)
    n_tasks = len(cfg.distill.task_order()) if cfg.distill else 0
    ntt = cfg.distill.num_task_tokens if cfg.distill else 0
    img_size = cfg.convnext.image_size if cfg.use_convnext_tower else cfg.vision.image_size
    num_image_tokens = cfg.num_image_tokens
    feature_indices = None
    if anyres_tiles:
        num_image_tokens = (1 + anyres_tiles) * cfg.num_image_tokens
        feature_indices = [np.arange(num_image_tokens, dtype=np.int32)] * batch_size
    vocab, ns = cfg.decoder.vocab_size, cfg.num_sys_tokens
    plans = []
    for b in range(batch_size):
        text_len = int(rng.integers(24, 48))
        ids = (list(rng.integers(3, vocab - 10, size=ns)) + [IMAGE_TOKEN_INDEX]
               + list(rng.integers(3, vocab - 10, size=text_len)))
        labels = [IGNORE_INDEX] * (ns + 1) + ids[ns + 1:]
        plans.append(build_splice_plan(
            ids, labels, seq_len, num_image_tokens=num_image_tokens, num_task_tokens=ntt,
            num_tasks=n_tasks,
            image_feature_indices=[feature_indices[b]] if feature_indices else None,
        ))
    if anyres_tiles:
        img = rng.normal(size=(batch_size, 1 + anyres_tiles, img_size, img_size, 3))
    else:
        img = rng.normal(size=(batch_size, img_size, img_size, 3))
    batch = collate_plans(plans, images=img.astype(np.float32))
    if cfg.distill:
        for tcfg in cfg.distill.tasks:
            batch[f"{tcfg.task}_mask"] = np.ones((batch_size,), np.float32)
    return batch


def add_teacher_inputs(cfg, batch: Dict[str, Any], batch_size: int, seed: int = 0):
    """Each teacher's pixel tensor (its own preprocessing's size), from
    np.random.default_rng(seed + 1)."""
    rng = np.random.default_rng(seed + 1)
    for key, size in (("depth_images", 336), ("gen_images", 224), ("seg_images", 768)):
        batch[key] = rng.normal(size=(batch_size, size, size, 3)).astype(np.float32)
    return batch


def add_random_targets(cfg, batch: Dict[str, Any], batch_size: int, seed: int = 0):
    """Precomputed random targets in place of the teachers, from
    np.random.default_rng(seed + 1)."""
    rng = np.random.default_rng(seed + 1)
    for tcfg in cfg.distill.tasks:
        batch[f"{tcfg.task}_target"] = rng.normal(
            size=(batch_size, tcfg.target_tokens, tcfg.target_dim)).astype(np.float32)
    return batch


def bench_batch(cfg, batch_size: int, seq_len: int, with_teachers: bool,
                anyres_tiles: int = 0, seed: int = 0) -> Dict[str, np.ndarray]:
    """The measured step's batch: `build_batch`, then the teachers' pixels
    (with_teachers) or, for a distillation config without them, random
    targets."""
    batch = build_batch(cfg, batch_size, seq_len, anyres_tiles=anyres_tiles, seed=seed)
    if with_teachers:
        return add_teacher_inputs(cfg, batch, batch_size, seed=seed)
    if cfg.distill is not None:
        return add_random_targets(cfg, batch, batch_size, seed=seed)
    return batch


def time_steps(step: Callable[[Dict[str, Any]], Dict[str, float]], batch: Dict[str, Any],
               steps: int, device: torch.device,
               each: Optional[Callable[[int, Dict[str, float]], None]] = None,
               ) -> Tuple[float, Dict[str, float]]:
    """Seconds per step of `steps` steps on `batch` after one warm-up step,
    on the host clock between two synchronizes; and the last step's
    metrics. each(i, metrics), if given, runs after step i (0 the warm-up,
    outside the timed window; 1..steps inside it, so host work only)."""
    metrics = step(batch)                         # warm-up
    if each is not None:
        each(0, metrics)
    sync(device)
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        metrics = step(batch)
        if each is not None:
            each(i, metrics)
    sync(device)
    return (time.perf_counter() - t0) / steps, metrics


def step_flops(cfg, batch_size: int, seq_len: int, anyres_tiles: int,
               with_teachers: bool) -> Tuple[float, float]:
    """(the student's, all the step's) analytic FLOPs: `train_step_flops`,
    the tower again for every anyres tile, and the teachers' forward."""
    from visper_lm_tpu_torch.utils.diagnostics import teacher_flops, train_step_flops, vision_flops

    flops = train_step_flops(cfg, batch_size, seq_len)
    if anyres_tiles:
        flops += anyres_tiles * batch_size * vision_flops(cfg)
    return flops, flops + (teacher_flops(batch_size) if with_teachers else 0.0)


def measure(args: argparse.Namespace, batch_size: int) -> Tuple[float, Dict[str, Any]]:
    """One measured configuration -> (examples/s, the record's other fields)."""
    from visper_lm_tpu_torch.device import resolve_device
    from visper_lm_tpu_torch.models.teachers import init_teachers, make_teacher_fn
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.train.optimizer import OptimizerConfig
    from visper_lm_tpu_torch.train.train_step import make_train_step

    device = resolve_device(args.device)
    cfg = build_bench_cfg(args.smoke, stage=args.stage, tower=args.tower)
    seq_len = 64 if args.smoke else args.seq
    with_teachers = cfg.distill is not None and not (args.smoke or args.no_teachers)

    model = init_vlm(cfg, device=device, seed=0)
    teacher_fn = teachers = None
    if with_teachers:
        teachers = init_teachers(cfg, device=device, seed=7)
        teacher_fn = make_teacher_fn(cfg, microbatch=args.teacher_microbatch)
    batch = bench_batch(cfg, batch_size, seq_len, with_teachers, anyres_tiles=args.anyres_tiles)
    opt_cfg = OptimizerConfig(
        learning_rate=1e-3 if args.stage == "pretrain" else 2e-5, total_steps=1000,
        stage=args.stage, master_weights=args.master_weights,
    )
    step = make_train_step(
        cfg, opt_cfg, model, teacher_fn=teacher_fn, teacher_params=teachers,
        remat_policy=args.remat_policy, offload_opt_state=args.offload_opt,
        stream_grads=args.stream_grads, use_kernel=False if args.xla_attention else None,
    )
    batch = step.to_device(batch)
    dt, metrics = time_steps(step, batch, args.steps, device)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    flops, total_flops = step_flops(cfg, batch_size, seq_len, args.anyres_tiles, with_teachers)
    on_card = device.type == "cuda"
    extras = {
        "step_time_s": round(dt, 4),
        "tokens_per_sec": round(batch_size * seq_len / dt, 1),
        "model_tflops_per_step": round(total_flops / 1e12, 2),
        "achieved_tflops_per_sec": round(total_flops / dt / 1e12, 2),
        # student-math MFU (excl. teachers) and all-executed-math MFU
        "mfu_student": round(flops / dt / H100_BF16_PEAK, 4) if on_card else None,
        "mfu": round(total_flops / dt / H100_BF16_PEAK, 4) if on_card else None,
        "batch": batch_size,
        "seq": seq_len,
        "device": device_name(device),
    }
    return batch_size / dt, extras


def build_argparser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults, plus --device."""
    p = argparse.ArgumentParser(prog="python -m visper_lm_tpu_torch.tools.bench")
    p.add_argument("--smoke", action="store_true", help="the tiny config (T64, no teachers)")
    p.add_argument("--stage", default="pretrain",
                   choices=["pretrain", "finetune", "lora", "vision_tower"],
                   help="pretrain = PT distill step (the tracked metric); finetune = IFT "
                        "full-model step (lr 2e-5, no distill heads); lora = the reference "
                        "lora_enable IFT regime (r=64 alpha=16); vision_tower = only "
                        "tower+projector train")
    p.add_argument("--tower", default="clip", choices=["clip", "convnext"],
                   help="convnext = config #3's ConvNeXt-XXL trunk @768px")
    p.add_argument("--anyres-tiles", type=int, default=0,
                   help="N>0: base image + N anyres tiles per sample through the tower")
    p.add_argument("--master-weights", action="store_true",
                   help="f32 master weights in the optimizer")
    p.add_argument("--stream-grads", type=int, default=0,
                   help="N>0: decoder blocks in N segments whose weight gradients leave for "
                        "pinned host memory during the backward; requires --offload-opt")
    p.add_argument("--offload-opt", action="store_true",
                   help="pinned-host AdamW moments with the blockwise staged update "
                        "(train/staged_update.py)")
    p.add_argument("--cost-analysis", action="store_true",
                   help="XLA's cost model of the compiled step: raises here (no compiler "
                        "cost model in PyTorch eager)")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--sweep", default=None,
                   help="comma-separated batch sizes; reports the best (a batch that runs "
                        "out of card memory is skipped)")
    p.add_argument("--no-teachers", action="store_true",
                   help="precomputed random targets instead of the teachers in the step")
    p.add_argument("--teacher-microbatch", type=int, default=2,
                   help="teacher chunk size (0 disables chunking)")
    p.add_argument("--remat-policy", default="save_gate",
                   help="remat save set (models/decoder.REMAT_POLICIES); 'none' for full "
                        "per-block remat")
    p.add_argument("--xla-attention", action="store_true",
                   help="run the decoder's attention on the plain path instead of the "
                        "flash kernels (use_kernel=False)")
    p.add_argument("--device", default="cuda", help="where the model and the step run")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_argparser().parse_args(argv)
    if args.cost_analysis:
        raise ValueError("--cost-analysis reads XLA's cost model of the compiled step; the "
                         "port runs PyTorch eager, which has none (profile the step instead)")
    batch_sizes = ([int(b) for b in args.sweep.split(",")] if args.sweep
                   else [4 if args.smoke else args.batch])
    best_value, best_extras = -1.0, {}
    for bs in batch_sizes:
        try:
            value, extras = measure(args, bs)
        except torch.OutOfMemoryError as e:       # a batch too large for the card
            print(f"# batch {bs} failed: {type(e).__name__}: {e}", file=sys.stderr)
            gc.collect()
            torch.cuda.empty_cache()
            continue
        print(f"# batch {bs}: {value:.3f} ex/s | {extras}", file=sys.stderr)
        if value > best_value:
            best_value, best_extras = value, extras
    if best_value <= 0:
        raise RuntimeError("no benchmark configuration succeeded")
    tower_tag = "" if args.tower == "clip" else "_convnext"
    record = {
        "metric": f"{STAGE_TAGS[args.stage]}{tower_tag}_train_step_examples_per_sec_per_chip",
        "value": round(best_value, 3),
        "unit": "examples/s/chip",
        "vs_baseline": 1.0,
        "baseline_kind": "none",
    }
    record.update(best_extras)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
