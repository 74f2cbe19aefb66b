"""The reference's per-image teacher featurization against the batched one
(counterpart of the root bench_teacher_pattern.py).

    python -m visper_lm_tpu_torch.tools.bench_teacher_pattern [--batch 8]
        [--iters 2] [--smoke] [--device cuda|cpu]

The reference computes the distillation targets inside the training step
with per-image Python loops that interleave host preprocessing and batch-1
model calls (SHI-Labs/VisPer-LM `base_ola_vlm.py:322-404`). This system
preprocesses on the host in the input pipeline and runs each teacher once
over the batch. On one backend this measures:

  * host_prep_s: the host's resize + normalize of every image at the three
    teacher resolutions, the share the reference serializes with the device;
  * per_image_s against batched_s: the same three teachers, batch-1 calls
    against one batched call each, with the host preparation inside the
    loop as the reference has it.

The teachers are the port's own, the models the PT step runs
(`models/teachers`: DINOv2-L at 336 for the depth target, CLIP-H at 224 for
the gen target, Swin-L at 768 for the seg target, through B4 on the card);
the JAX script builds transformers' models on a CPU, which the card has not.
Host preparation is the native bicubic resize with ImageNet normalize
(`native.resize_normalize`) in place of `PIL.Image.resize`. The per-image
rows must equal the batched rows (`max_rel_diff`, the largest relative
Frobenius difference of a teacher's rows) within `ROW_BOUND`, else `main`
raises. The record's `"backend"` names the device.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from visper_lm_tpu_torch.tools import device_name, sync

# how far a teacher's per-image rows may lie from its batched rows (relative
# Frobenius): batch-1 and batched GEMMs round differently, f32 at the CPU's
# float sums, bf16 after 24-32 layers of bf16 rounding
ROW_BOUND = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def smoke_teacher_configs():
    """Tiny teachers at 28 / 28 / 64 px: DINOv2 24 wide, CLIP-H 32 wide with a
    24-wide projection, a four-stage Swin 2 wide (the seg target reads the
    fourth stage), 2 layers or 1 block a stage each; f32."""
    from visper_lm_tpu_torch.config import VisionConfig
    from visper_lm_tpu_torch.models.teachers import TeacherConfigs
    from visper_lm_tpu_torch.models.teachers.swin import SwinConfig

    dino = VisionConfig(image_size=28, patch_size=14, hidden_size=24, num_layers=2, num_heads=2,
                        mlp_dim=48, norm_eps=1e-6, hidden_act="gelu", use_pre_norm=False,
                        dtype="float32")
    clip_h = VisionConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
                          num_heads=2, mlp_dim=64, hidden_act="gelu", dtype="float32")
    swin = SwinConfig(embed_dim=2, depths=(1, 1, 1, 1), num_heads=(1, 1, 1, 2), window_size=2)
    return TeacherConfigs(dinov2=dino, clip_h=clip_h, swin=swin, gen_embed_dim=24), (28, 28, 64)


def teacher_calls() -> List[Tuple[str, Any]]:
    """(name, target function) for each teacher, in the script's order:
    depth (DINOv2), gen (CLIP-H), seg (Swin)."""
    from visper_lm_tpu_torch.models.teachers import dinov2, swin, unclip

    return [("dinov2", dinov2.dav2_depth_target), ("clip_h", unclip.gen_target),
            ("swin", swin.seg_target)]


def prep(img: np.ndarray, size: int) -> np.ndarray:
    """One uint8 image to a teacher's f32 (size, size, 3) pixels: bicubic
    resize, ImageNet normalize."""
    from visper_lm_tpu_torch import native
    from visper_lm_tpu_torch.data.mm_utils import IMAGENET_MEAN, IMAGENET_STD

    return native.resize_normalize(img, size, IMAGENET_MEAN, IMAGENET_STD, native.BICUBIC)


def per_image_pass(teachers, images: Sequence[np.ndarray], sizes: Sequence[int]):
    """The reference pattern: host preparation inside the loop, batch-1
    forwards, the rows stacked at the end. One (B, ...) f32 tensor a teacher."""
    param = next(teachers.parameters())
    feats = []
    with torch.no_grad():
        for (name, target), size in zip(teacher_calls(), sizes):
            outs = [target(teachers[name], torch.from_numpy(prep(img, size))[None].to(
                device=param.device, dtype=param.dtype)) for img in images]
            feats.append(torch.cat(outs))
    return feats


def batched_pass(teachers, images: Sequence[np.ndarray], sizes: Sequence[int]):
    """This system's pattern: batched host preparation, one batched forward a
    teacher."""
    param = next(teachers.parameters())
    feats = []
    with torch.no_grad():
        for (name, target), size in zip(teacher_calls(), sizes):
            px = torch.from_numpy(np.stack([prep(img, size) for img in images]))
            feats.append(target(teachers[name], px.to(device=param.device, dtype=param.dtype)))
    return feats


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """The relative Frobenius distance of a from b."""
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


def measure(teachers, images: Sequence[np.ndarray], sizes: Sequence[int], iters: int,
            ) -> Dict[str, Any]:
    """The script's record for `teachers` on `images`, and `max_rel_diff`:
    the largest relative Frobenius distance of a teacher's per-image rows
    from its batched rows."""
    device = next(teachers.parameters()).device
    for img in images:                            # host preparation alone
        for s in sizes:
            prep(img, s)
    reps = max(iters, 3)
    t0 = time.perf_counter()
    for _ in range(reps):
        for img in images:
            for s in sizes:
                prep(img, s)
    t_prep = (time.perf_counter() - t0) / reps

    loop = per_image_pass(teachers, images, sizes)            # warm-up
    batched = batched_pass(teachers, images, sizes)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        per_image_pass(teachers, images, sizes)
    sync(device)
    t_loop = (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        batched_pass(teachers, images, sizes)
    sync(device)
    t_batched = (time.perf_counter() - t0) / iters
    return {
        "host_prep_s": round(t_prep, 3),
        "per_image_s": round(t_loop, 3),
        "batched_s": round(t_batched, 3),
        "batch": len(images),
        "backend": f"torch-{device.type} ({device_name(device)})",
        "max_rel_diff": max(rel_diff(a, b) for a, b in zip(loop, batched)),
    }


def noise_images(batch: int) -> List[np.ndarray]:
    """The script's images from np.random.default_rng(0): uint8 640 x 480
    (H x W) noise."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, size=(640, 480, 3), dtype=np.uint8) for _ in range(batch)]


def build_argparser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults, plus --device."""
    p = argparse.ArgumentParser(prog="python -m visper_lm_tpu_torch.tools.bench_teacher_pattern")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=2)
    p.add_argument("--smoke", action="store_true", help="tiny teachers at 28 / 28 / 64 px")
    p.add_argument("--device", default="cuda", help="where the teachers run")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    from visper_lm_tpu_torch.config import tiny_test_vlm
    from visper_lm_tpu_torch.device import resolve_device
    from visper_lm_tpu_torch.models.teachers import init_teachers

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    if args.smoke:
        tcfgs, sizes = smoke_teacher_configs()
        teachers = init_teachers(tiny_test_vlm(distill=True), tcfgs, device=device,
                                 dtype=torch.float32, seed=0)
    else:
        # the PT step's teachers (config #1's tasks: all three), bf16
        from visper_lm_tpu_torch.config import phi3_clip_vlm

        teachers, sizes = init_teachers(phi3_clip_vlm(distill=True), device=device, seed=0), (
            336, 224, 768)
    record = measure(teachers, noise_images(args.batch), sizes, args.iters)
    print(json.dumps(record), flush=True)
    bound = ROW_BOUND[next(teachers.parameters()).dtype]
    if not record["max_rel_diff"] <= bound:
        raise RuntimeError(f"per-image rows differ from the batched rows by "
                           f"{record['max_rel_diff']:.3g} > {bound}")
    return record


if __name__ == "__main__":
    main()
