"""Timing, profiling, FLOP counts and numerical-safety checks (counterpart of
visper_lm_tpu/utils/diagnostics.py).

  * StepTimer: steady-state wall time per step, examples/s, tokens/s and
    achieved FLOP/s against an analytic count (the caller synchronises the
    device before each `step()`);
  * trace(): a torch.profiler trace of the enclosed work, written to log_dir
    as a Chrome trace;
  * train_step_flops / vision_flops / teacher_flops: the JAX package's
    analytic counts (matmul terms); decoder_params: the decoder parameters
    train_step_flops charges 6 FLOPs per token;
  * finite_check(): per-group (all finite?, abs-max) of named tensors, with
    one host read;
  * nan_guard(): autograd anomaly detection (a NaN made in a backward op
    raises there).

`convnext_flops` waits for the ConvNeXt tower.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch

from visper_lm_tpu_torch.utils.param import (
    jax_path,
)


class StepTimer:
    """Track steady-state step timing; call .step() after each synced step."""

    def __init__(self, warmup: int = 2, flops_per_step: Optional[float] = None):
        self.warmup = warmup
        self.flops_per_step = flops_per_step
        self.count = 0
        self._t0: Optional[float] = None

    def step(self) -> None:
        self.count += 1
        if self.count == self.warmup:
            self._t0 = time.perf_counter()

    @property
    def measured_steps(self) -> int:
        return max(self.count - self.warmup, 0)

    def summary(self, batch_size: int, seq_len: int) -> Dict[str, float]:
        if self._t0 is None or self.measured_steps == 0:
            return {}
        dt = (time.perf_counter() - self._t0) / self.measured_steps
        out = {
            "step_time_s": dt,
            "steps_per_sec": 1.0 / dt,
            "examples_per_sec": batch_size / dt,
            "tokens_per_sec": batch_size * seq_len / dt,
        }
        if self.flops_per_step:
            out["tflops_per_sec"] = self.flops_per_step / dt / 1e12
        return out


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed work (CPU, and CUDA when present) and write a
    Chrome trace to log_dir/trace.json."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def train_step_flops(cfg, batch_size: int, seq_len: int) -> float:
    """Analytic FLOPs for one PT-stage fwd+bwd step (matmul-dominated terms).

    Decoder: 6 * P_active * tokens (fwd 2x, bwd 4x) + causal attention
    (6 * B * L * T^2 * H_dim * N / 2). Vision tower fwd only (frozen):
    2 * P_vis * patches. Recomputation under remat is not counted (MFU
    counts the model's math, not the math a policy repeats)."""
    d = cfg.decoder
    tokens = batch_size * seq_len
    flops = 6.0 * decoder_params(cfg) * tokens
    flops += 6.0 * batch_size * d.num_layers * seq_len * seq_len * d.num_heads * d.head_dim / 2
    flops += vision_flops(cfg) * batch_size
    return flops


def decoder_params(cfg) -> int:
    """The decoder's matmul parameters as train_step_flops counts them: the
    blocks' linears, the embedding and the lm_head."""
    d = cfg.decoder
    return (
        d.num_layers
        * (
            d.hidden_size * (d.num_heads + 2 * d.num_kv_heads) * d.head_dim
            + d.num_heads * d.head_dim * d.hidden_size
            + 3 * d.hidden_size * d.mlp_dim
        )
        + 2 * d.vocab_size * d.hidden_size
    )


def vision_flops(cfg) -> float:
    """Analytic forward FLOPs per image through the CLIP tower."""
    if getattr(cfg, "use_convnext_tower", False):
        raise NotImplementedError("the ConvNeXt tower is not ported yet")
    v = cfg.vision
    p_vis = v.num_layers * (4 * v.hidden_size ** 2 + 2 * v.hidden_size * v.mlp_dim)
    return 2.0 * p_vis * (v.num_patches + 1)


def teacher_flops(batch_size: int) -> float:
    """Analytic forward FLOPs of the three frozen teachers per step:
    DINOv2-L @336/14, CLIP-H @224/14 and Swin-L @768 (matmul terms, as
    train_step_flops), so an MFU counts all the math the step runs."""
    vit = 2 * 577 * 24 * (4 * 1024 ** 2 + 2 * 1024 * 4096)
    vit += 2 * 2 * 24 * 577 ** 2 * 1024  # attention scores+values fwd
    clip = 2 * 257 * 32 * (4 * 1280 ** 2 + 2 * 1280 * 5120)
    clip += 2 * 2 * 32 * 257 ** 2 * 1280
    # Swin-L stages: tokens 36864/9216/2304/576, dims 192/384/768/1536,
    # depths 2/2/18/2; 12*d^2 per token per layer (qkvo + mlp(4x))
    swin = 0.0
    for tok, dim, depth in ((36864, 192, 2), (9216, 384, 2),
                            (2304, 768, 18), (576, 1536, 2)):
        swin += 2 * tok * depth * 12 * dim ** 2
    return batch_size * float(vit + clip + swin)


def finite_check(
    named: Mapping[str, torch.Tensor], group_depth: int = 2
) -> Dict[str, Tuple[bool, float]]:
    """{group: (every element finite?, largest |x|)} over named tensors
    (port names, grouped by their JAX path cut to group_depth segments),
    read to the host once."""
    groups: Dict[str, list] = {}
    for name, t in named.items():
        key = "/".join(jax_path(name).split("/")[:group_depth])
        groups.setdefault(key, []).append(t)
    stats = torch.stack([
        torch.stack([
            torch.stack([torch.isfinite(t.float()).all().float() for t in ts]).min(),
            torch.stack([t.detach().float().abs().max() for t in ts]).max(),
        ])
        for ts in groups.values()
    ]).cpu().tolist()
    return {k: (bool(f), float(m)) for k, (f, m) in zip(groups, stats)}


@contextlib.contextmanager
def nan_guard() -> Iterator[None]:
    """Autograd anomaly detection inside the context: a backward op that
    makes a NaN raises, with the forward op's trace."""
    with torch.autograd.detect_anomaly(check_nan=True):
        yield
