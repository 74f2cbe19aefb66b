"""Fused Swin window attention: the CUDA kernel's wrapper, its plain version
and the dispatch (counterpart of visper_lm_tpu/ops/window_attention.py).

  * `window_attention_plain` — JAX `window_attention_xla` (:33-54): the CPU
    path and the kernel's oracle;
  * `window_attention_kernel` — wraps csrc/window_attn.cu (B4), which replaces
    the Pallas `window_attention_pallas` (:82, pallas_call :112). Forward only,
    bf16, (N, D) in `SUPPORTED_SHAPES`; a CUDA tensor launches the kernel or
    raises, an input that requires grad raises;
  * `window_attention` — JAX `window_attention` (:134): the kernel for tensors
    on CUDA, the plain version elsewhere or when use_kernel=False.

q, k, v are (W, heads, N, D) with W = batch * windows flattened batch-major;
bias (heads, N, N) is added to the scores; mask (nW, N, N) tiles W with
period nW. The mesh (shard_map) routing of the JAX dispatch is not carried
over (one card).
"""

from __future__ import annotations

from typing import Optional

import torch

SUPPORTED_SHAPES = ((144, 32), (64, 16))   # (N, D): Swin-L window 12, a test shape

# Kernel launches since the last reset (see ops/flash_attention.py).
launches = 0


def window_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """Plain version (JAX `window_attention_xla`): q scaled in f32 and rounded
    to its dtype, f32 scores + bias (+ mask tiled over W), f32 softmax, P
    rounded to the input dtype for the second product."""
    w, h, n, _ = q.shape
    qf = (q.float() * scale).to(q.dtype)
    s = torch.einsum("whnd,whmd->whnm", qf.float(), k.float())
    s = s + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        s = s.reshape(w // nw, nw, h, n, n) + mask.float()[None, :, None]
        s = s.reshape(w, h, n, n)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("whnm,whmd->whnd", p.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def _check(q, k, v, bias, mask) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"window_attention: {name} is on {x.device}, expected {q.device} (CUDA)")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"window_attention: the kernel takes bf16, {name} is {x.dtype}")
        if x.requires_grad:
            raise ValueError("window_attention: the kernel is forward only (frozen teacher)")
        if x.shape != q.shape or x.ndim != 4 or x.stride(-1) != 1:
            raise ValueError(f"window_attention: {name} must be (W, heads, N, D) with unit D stride")
        if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
            raise ValueError(f"window_attention: {name} needs 16-byte aligned rows")
    w, h, n, d = q.shape
    if (n, d) not in SUPPORTED_SHAPES:
        raise ValueError(f"window_attention: (N, D) = ({n}, {d}) not in {SUPPORTED_SHAPES}")
    if tuple(bias.shape) != (h, n, n):
        raise ValueError(f"window_attention: bias must be ({h}, {n}, {n})")
    if mask is not None and (mask.ndim != 3 or mask.shape[1:] != (n, n) or w % mask.shape[0]):
        raise ValueError(f"window_attention: mask must be (nW, {n}, {n}) with W % nW == 0")


def window_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """Launch B4 on the current stream. The result is a (W, heads, N, D) view
    of a (W, N, heads, D) buffer, so the Swin block's merge of the heads back
    into (W, N, C) is free."""
    _check(q, k, v, bias, mask)
    from visper_lm_tpu_torch.ops import _build

    global launches
    lib = _build.load("window_attn")
    w, h, n, d = q.shape
    bias32 = bias.to(device=q.device, dtype=torch.float32).contiguous()
    mask32 = None
    if mask is not None:
        mask32 = mask.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty((w, n, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    rc = lib.visper_window_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bias32.data_ptr(),
        None if mask32 is None else mask32.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        w, h, n, d, 0 if mask32 is None else mask32.shape[0], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"window_attention: kernel launch failed with CUDA error {rc}")
    launches += 1
    return out


def window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    use_kernel: Optional[bool] = None,
) -> torch.Tensor:
    """Dispatch: the kernel for CUDA tensors (use_kernel=None), the plain
    version for CPU tensors or use_kernel=False."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if use_kernel is None:
        use_kernel = q.is_cuda
    if not use_kernel or q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, mask, scale)
    return window_attention_kernel(q, k, v, bias, mask, scale)
