"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of visper_lm_tpu/ops/flash_attention.py `flash_attention` (:630),
whose Pallas forward `_fwd_kernel` (:97, pallas_call :234) becomes the
hand-written Hopper kernel csrc/flash_fwd.cu. The wrapper launches the kernel
for CUDA tensors (or raises) and uses `flash_attention_reference` only for
tensors on the CPU. Forward only: the backward kernels belong to the
training slice.

Fully masked rows (left padding before kv_starts): the kernel gives 0 and
lse = NEG_INF, the plain version a uniform average of v. Compare the two on
rows >= kv_starts only; decode masks slots < kv_starts, so pad rows never
reach a valid output.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from visper_lm_tpu_torch.ops.attention import masked_logits, mha_plain

NEG_INF = -2.3819763e38
SUPPORTED_HEAD_DIMS = (64, 96, 128)
SUPPORTED_DTYPES = (torch.bfloat16, torch.float32)

# Kernel launches since the last reset; a caller sets it to 0 and reads it
# to show that a run went through the kernel.
launches = 0


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,
    kv_starts: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (out (B,T,Nq,H), lse (B,Nq,T) f32) from `mha_plain`."""
    kw = dict(causal=causal, kv_lengths=kv_lengths, kv_starts=kv_starts, scale=scale)
    out = mha_plain(q, k, v, **kw)
    logits, mask = masked_logits(q, k, **kw)
    lse = torch.logsumexp(logits, dim=-1)
    if mask is not None:
        any_valid = mask.any(dim=-1).expand(lse.shape)
        lse = lse.masked_fill(~any_valid, NEG_INF)
    return out, lse


def _check(q, k, v, kv_lengths, kv_starts) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"flash_attention: {name} is on {x.device}, expected CUDA")
        if x.device != q.device:
            raise ValueError("flash_attention: q, k, v on different devices")
        if x.dtype != q.dtype:
            raise ValueError(f"flash_attention: dtypes differ ({q.dtype}, {x.dtype})")
        if x.ndim != 4 or x.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be 4-D BTNH with unit head stride")
        if x.requires_grad:
            raise NotImplementedError(
                "flash_attention: forward only; the backward kernels are not ported yet"
            )
        if x.dtype == torch.bfloat16 and (
            x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3])
        ):
            raise ValueError(f"flash_attention: bf16 {name} needs 16-byte aligned rows")
    if q.dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported")
    b, _, nq, h = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != h:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if nq % k.shape[2]:
        raise ValueError("flash_attention: query heads must be a multiple of kv heads")
    if h not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {h} not in {SUPPORTED_HEAD_DIMS}")
    for name, x in (("kv_lengths", kv_lengths), ("kv_starts", kv_starts)):
        if x is not None and tuple(x.shape) != (b,):
            raise ValueError(f"flash_attention: {name} must have shape ({b},)")


def _int32_on(x: Optional[torch.Tensor], device: torch.device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return x.to(device=device, dtype=torch.int32).contiguous()


def flash_attention_fwd(
    q: torch.Tensor,                  # (B, T, Nq, H)
    k: torch.Tensor,                  # (B, S, Nkv, H)
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,
    kv_starts: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, T, Nq, H) in q's dtype, lse (B, Nq, T) f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream or raise."""
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, kv_lengths=kv_lengths, kv_starts=kv_starts,
            scale=scale,
        )
    _check(q, k, v, kv_lengths, kv_starts)
    from visper_lm_tpu_torch.ops import _build

    global launches
    lib = _build.load("flash_fwd")
    b, t, nq, h = q.shape
    s, nkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = h ** -0.5
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, nq, t), dtype=torch.float32, device=q.device)
    lens = _int32_on(kv_lengths, q.device)
    starts = _int32_on(kv_starts, q.device)
    rc = lib.visper_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        None if lens is None else lens.data_ptr(),
        None if starts is None else starts.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, t, s, nq, nkv, h, float(scale), int(causal),
        int(q.dtype == torch.float32),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {rc}")
    launches += 1
    return out, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,
    kv_starts: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention in the BTNH convention; returns out (B, T, Nq, H).

    kv_starts masks columns before a per-batch start (left padding, generation
    prefill); kv_lengths masks columns at/after a per-batch length."""
    return flash_attention_fwd(
        q, k, v, causal=causal, kv_lengths=kv_lengths, kv_starts=kv_starts,
        scale=scale,
    )[0]
