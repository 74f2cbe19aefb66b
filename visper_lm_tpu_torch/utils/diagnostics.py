"""Program spans, FLOP counts and numerical-safety checks (counterpart of
visper_lm_tpu/utils/diagnostics.py).

  * span(name, **args): a named region of the program in a torch.profiler
    trace, on the trace's clock beside the device operations it launched;
    off (the default) it is one shared no-op, switched by enable();
  * train_step_flops / vision_flops / convnext_flops / teacher_flops: the
    JAX package's analytic counts (matmul terms); decoder_params: the decoder
    parameters train_step_flops charges 6 FLOPs per token;
  * finite_check(): per-group (all finite?, abs-max) of named tensors, with
    one host read;
  * nan_guard(): autograd anomaly detection (a NaN made in a backward op
    raises there).

The spans (where, and per what):

  train.data_wait                  trainer._Prefetcher: the loop waiting
                                   for its next device batch
  teacher.dinov2 / .clip_h / .swin make_teacher_fn: each teacher on one
                                   chunk of the micro-batch
  heads                            train_step's loss: the task heads and
                                   the distillation losses (the teachers
                                   outside it)
  vlm.tower                        vlm.tower_features, [images=B]
  decoder.block                    DecoderBlock.forward (a remat's
                                   recompute too)
  engine.step                      Engine.step, around:
    engine.admit                   its admissions, [requests=N]
    engine.decode                  its decode quantum, [n=Q,slots=S]
    engine.sync                    the host's read of a device value
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Mapping, Tuple

import torch

from visper_lm_tpu_torch.utils.param import (
    jax_path,
)


_ON = False
_OFF = contextlib.nullcontext()


def enable(flag: bool) -> None:
    """Switch every span on or off (off at import)."""
    global _ON
    _ON = bool(flag)


def span(name: str, **args):
    """A context manager for the named region. Off, the one shared no-op.
    On, a `torch.profiler.record_function` whose name carries the args
    (`engine.admit[requests=2]`): the profiler keeps a record_function's own
    args string nowhere a trace reader sees."""
    if not _ON:
        return _OFF
    if args:
        name = f"{name}[{','.join(f'{k}={v}' for k, v in args.items())}]"
    return torch.profiler.record_function(name)


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
    """Analytic forward FLOPs per image through the configured tower."""
    if getattr(cfg, "use_convnext_tower", False) and cfg.convnext is not None:
        return convnext_flops(cfg.convnext)
    v = cfg.vision
    p_vis = v.num_layers * (4 * v.hidden_size ** 2 + 2 * v.hidden_size * v.mlp_dim)
    return 2.0 * p_vis * (v.num_patches + 1)


def convnext_flops(ccfg) -> float:
    """Analytic forward FLOPs per image through the ConvNeXt trunk (stem /4,
    then stages at /4, /8, /16, /32). Per block at dim d over N tokens: the
    7x7 depthwise conv (2 * 49 * d) and the two 4x MLP matmuls (16 d^2)."""
    side = ccfg.image_size // 4
    total = 2.0 * side * side * ccfg.dims[0] * 3 * 16            # stem 4x4 conv
    for s, (depth, d) in enumerate(zip(ccfg.depths, ccfg.dims)):
        n = (ccfg.image_size // (4 * 2 ** s)) ** 2
        if s > 0:
            total += 2.0 * n * ccfg.dims[s - 1] * d * 4             # 2x2 downsample conv
        total += depth * n * (2.0 * 49 * d + 16.0 * d * d)
    return total


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
