"""Fused Swin window attention: the CUDA kernels' wrapper, their plain version
and the dispatch (counterpart of visper_lm_tpu/ops/window_attention.py).

  * `window_attention_plain` — JAX `window_attention_xla` (:33-54): the CPU
    path and the kernels' oracle;
  * `window_attention_kernel` — wraps csrc/window_attn.cu (B4), which replaces
    the Pallas `window_attention_pallas` (:82, pallas_call :112). Forward only,
    bf16, (N, D) in `SUPPORTED_SHAPES`; a CUDA tensor launches the kernel or
    raises, an input that requires grad raises;
  * `window_attention` — JAX `window_attention` (:134): the kernel for tensors
    on CUDA, the plain version elsewhere or when use_kernel=False.

csrc/window_attn.cu holds one kernel, which `window_attn_kernel_for` names:
"streamed" (a CTA takes a run of windows that share one head and, in a
shifted launch, one mask index, reads their bias and mask once into shared
memory and streams the windows' q, k, v through a ring; `window_attn_plan`
sets the run length, the grid and the ring, `window_attn_ctas` lists what
each CTA takes).

q, k, v are (W, heads, N, D) with W = batch * windows flattened batch-major;
bias (heads, N, N) is added to the scores; mask (nW, N, N) tiles W with
period nW. The mesh (shard_map) routing of the JAX dispatch is not carried
over (one card).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

SUPPORTED_SHAPES = ((144, 32), (64, 16))   # (N, D): Swin-L window 12, a test shape
SMEM_PER_CTA = 232_448   # dynamic shared memory a CTA may ask for on sm_90 (227 KB)
MAX_STAGES = 5           # ring stages of q, k, v
ARRAY_COST = 0.5         # loading one N x N f32 array (bias or mask) ~ half a window's time
H100_SMS = 132

# Kernel launches since the last reset (see ops/flash_attention.py).
launches = 0


class WindowPlan(NamedTuple):
    windows_per_cta: int      # the longest run of windows a CTA takes
    grid: Tuple[int, int]     # (mask indices x runs, heads)
    stages: int               # ring stages of q, k, v
    smem_bytes: int           # dynamic shared memory of a CTA (one CTA an SM)


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


def window_attn_kernel_for(n: int, d: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """The hand-written kernel a (N, D, dtype) call takes on CUDA; raises for
    what no kernel runs. Never the plain version: "streamed" takes every
    supported shape."""
    if dtype != torch.bfloat16:
        raise ValueError(f"window_attention: the kernel takes bf16, not {dtype}")
    if (n, d) not in SUPPORTED_SHAPES:
        raise ValueError(f"window_attention: (N, D) = ({n}, {d}) not in {SUPPORTED_SHAPES}")
    return "streamed"


def window_attn_smem_bytes(n: int, d: int, masked: bool, stages: int) -> int:
    """Dynamic shared memory of a streamed CTA (`StreamCfg::smem` in
    csrc/window_attn.cu): the ring of q, k, v tiles, bias (and mask) in N x N
    floats, the mbarriers, 1 KB to align the swizzled tiles."""
    return stages * 3 * n * d * 2 + (2 if masked else 1) * n * n * 4 + 8 * (1 + 2 * stages) + 1024


@functools.lru_cache(maxsize=None)
def window_attn_plan(w: int, heads: int, n: int, d: int, nw: int, sms: int = H100_SMS) -> WindowPlan:
    """The streamed kernel's grid for W windows of `heads` heads, nW mask
    indices (0: unshifted) on `sms` SMs; a function of shapes only.

    The windows that share a head and a mask index (W / nW of them; all W
    when unshifted) are cut into runs of `windows_per_cta`, one CTA each, so
    that each CTA reads its bias and mask once. A CTA fills its SM (bias and
    mask take most of its shared memory), so the run length minimises the
    estimated time of waves of CTAs over the SMs, each as long as its run
    plus the loads of its N x N arrays (ARRAY_COST windows each); on a tie
    the fewer CTAs (the more reuse)."""
    if (n, d) not in SUPPORTED_SHAPES:
        raise ValueError(f"window_attn_plan: (N, D) = ({n}, {d}) not in {SUPPORTED_SHAPES}")
    period = nw if nw > 0 else 1
    if w < 1 or heads < 1 or w % period:
        raise ValueError(f"window_attn_plan: W {w} is not a positive multiple of nW {nw}")
    masked = nw > 0
    group = w // period
    fit = [s for s in range(1, MAX_STAGES + 1) if window_attn_smem_bytes(n, d, masked, s) <= SMEM_PER_CTA]
    if not fit:
        raise ValueError(f"window_attn_plan: bias and mask at N {n} exceed a CTA's shared memory")
    best = None
    for run in range(1, group + 1):
        stages = min(fit[-1], run)
        smem = window_attn_smem_bytes(n, d, masked, stages)
        ctas = heads * period * -(-group // run)
        cost = -(-ctas // sms) * (run + ARRAY_COST * (2 if masked else 1))
        if best is None or (cost, ctas) < best[0]:
            grid = (period * -(-group // run), heads)
            best = ((cost, ctas), WindowPlan(run, grid, stages, smem))
    return best[1]


def window_attn_ctas(w: int, heads: int, nw: int, plan: WindowPlan) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
    """(head, windows) of each streamed CTA in grid order (blockIdx.x fastest):
    a copy of the kernel's index arithmetic (`window_attn_stream_kernel`:
    `runs`, `m`, `first`, `count`), kept for the CPU tests; a change to either
    must be made to both."""
    period = nw if nw > 0 else 1
    group = w // period
    runs = -(-group // plan.windows_per_cta)
    out = []
    for head in range(plan.grid[1]):
        for x in range(plan.grid[0]):
            m, first = x // runs, (x % runs) * plan.windows_per_cta
            count = min(plan.windows_per_cta, group - first)
            out.append((head, tuple(m + (first + j) * period for j in range(count))))
    return tuple(out)


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
    window_attn_kernel_for(n, d, q.dtype)
    if tuple(bias.shape) != (h, n, n):
        raise ValueError(f"window_attention: bias must be ({h}, {n}, {n})")
    if mask is not None and (mask.ndim != 3 or mask.shape[1:] != (n, n) or w % mask.shape[0]):
        raise ValueError(f"window_attention: mask must be (nW, {n}, {n}) with W % nW == 0")


def _f32_rows(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """x as contiguous f32 on `device` starting on a 16-byte boundary (the
    kernel copies its rows with the copy engine)."""
    x = x.to(device=device, dtype=torch.float32).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def window_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """Launch B4 on the current stream: the kernel `window_attn_kernel_for`
    names, with `window_attn_plan`'s plan for this card. The result is a
    (W, heads, N, D) view of a (W, N, heads, D) buffer, so the Swin block's
    merge of the heads back into (W, N, C) is free."""
    _check(q, k, v, bias, mask)
    w, h, n, d = q.shape
    kernel = window_attn_kernel_for(n, d, q.dtype)
    from visper_lm_tpu_torch.ops import _build

    global launches
    lib = _build.load("window_attn")
    bias32 = _f32_rows(bias, q.device)
    mask32 = None if mask is None else _f32_rows(mask, q.device)
    nw = 0 if mask32 is None else mask32.shape[0]
    plan = window_attn_plan(w, h, n, d, nw, torch.cuda.get_device_properties(q.device).multi_processor_count)
    out = torch.empty((w, n, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    rc = lib.visper_window_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bias32.data_ptr(),
        None if mask32 is None else mask32.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        w, h, n, d, nw, float(scale), plan.windows_per_cta, plan.stages,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"window_attention: {kernel} kernel launch failed with CUDA error {rc}")
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
