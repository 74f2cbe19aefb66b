"""Flash attention: the CUDA kernels' wrappers, their plain versions, and the
autograd Function that joins them.

Counterpart of visper_lm_tpu/ops/flash_attention.py `flash_attention` (:630)
and its custom VJP `_flash_bhtd` (:604-627):

  * forward: the Pallas `_fwd_kernel` (:97, pallas_call :234) becomes
    csrc/flash_fwd.cu (B1); plain version `flash_attention_reference`;
  * backward: `_bwd_dq_kernel` (:321, pallas_call :497) and `_bwd_dkv_kernel`
    (:373, pallas_call :562) become csrc/flash_bwd.cu (B2, B3); plain version
    `flash_attention_bwd_reference`. delta = rowsum(dO o O) is a plain torch
    op, as the JAX package leaves it to XLA (:457).

Each wrapper launches its kernel for CUDA tensors (or raises) and uses the
plain version only for tensors on the CPU. Each kernel has its own launch
counter (`launches`, `dq_launches`, `dkv_launches`). The forward takes bf16
and f32; the backward kernels take bf16 only (the training path's dtype), so
backward() of f32 CUDA tensors raises; `flash_remainder` names what no
kernel takes, and `ops.attention.multi_head_attention` raises for it before
the forward runs.

csrc/flash_fwd.cu holds three forward kernels and `flash_fwd_kernel_for`
names the one a call takes: "wgmma" (bf16, every supported shape: 128 query
rows per CTA, K/V tiles through a TMA ring, two consumer warpgroups on
`wgmma`), "simt" (f32, for checking) and "mma_sync" (the bf16 kernel before
"wgmma": it keeps the calls whose scale is not positive, and
`kernel="mma_sync"` forces it to be timed beside the other).

csrc/flash_bwd.cu holds the backward pair, which `flash_bwd_kernel_for`
names "wgmma" for every call: dq over CTAs of 128 query rows with K/V tiles
of 64 keys through a TMA ring, dk/dv over CTAs of 128 keys with Q/dO tiles
of 64 rows and their lse/delta through it; `flash_bwd_dq_visits` /
`flash_bwd_dkv_visits` are their loops and `flash_bwd_tile_order` their
grids.

Fully masked rows (left padding before kv_starts): the kernel gives 0 and
lse = NEG_INF, the plain forward a uniform average of v. Compare the two on
rows >= kv_starts only; decode masks slots < kv_starts, so pad rows never
reach a valid output. Both backward versions give such rows dq = 0 and no
share of dk/dv, as `_recompute_p` (:273-284) does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from visper_lm_tpu_torch.ops.attention import (
    _attention_mask,
    _broadcast_kv,
    masked_logits,
    mha_plain,
)

NEG_INF = -2.3819763e38
SUPPORTED_HEAD_DIMS = (64, 96, 128)
SUPPORTED_DTYPES = (torch.bfloat16, torch.float32)
KERNEL_IDS = {"simt": 0, "wgmma": 1, "mma_sync": 2}
KERNEL_DTYPES = {"simt": torch.float32, "wgmma": torch.bfloat16, "mma_sync": torch.bfloat16}
WGMMA_Q_TILE = 128      # query rows per CTA of the wgmma kernel
BWD_DQ_ROWS = 128       # wgmma dq: query rows per CTA, 64 per warpgroup
BWD_DQ_KEYS = 64        # wgmma dq: keys per streamed K/V tile
BWD_DKV_KEYS = 128      # wgmma dk/dv: keys per CTA, 64 per warpgroup
BWD_DKV_ROWS = 64       # wgmma dk/dv: query rows per streamed Q/dO tile
WARPGROUP_ROWS = 64     # rows of a wgmma product: one warpgroup's share of a CTA

# Kernel launches since the last reset, one counter per kernel; a caller sets
# them to 0 and reads them to show that a run went through the kernels.
launches = 0        # B1, forward
dq_launches = 0     # B2, dq
dkv_launches = 0    # B3, dk/dv


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
    """Plain forward: (out (B,T,Nq,H), lse (B,Nq,T) f32) from `mha_plain`."""
    kw = dict(causal=causal, kv_lengths=kv_lengths, kv_starts=kv_starts, scale=scale)
    out = mha_plain(q, k, v, **kw)
    logits, mask = masked_logits(q, k, **kw)
    lse = torch.logsumexp(logits, dim=-1)
    if mask is not None:
        any_valid = mask.any(dim=-1).expand(lse.shape)
        lse = lse.masked_fill(~any_valid, NEG_INF)
    return out, lse


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,
    kv_starts: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of both backward kernels, in f32: (dq, dk, dv) in the
    input dtypes. P is recomputed from the saved lse as `_recompute_p` does:
    exp(s * scale - lse) on unmasked pairs, 0 elsewhere and on rows whose lse
    is NEG_INF. dk and dv are summed over the G query heads of each kv head."""
    b, t, nq, h = q.shape
    s, nkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = h ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    kb, vb = _broadcast_kv(kf, nq), _broadcast_kv(vf, nq)
    logits = torch.einsum("btnh,bsnh->bnts", qf, kb) * scale
    lse_col = lse.float()[..., None]                       # (B, Nq, T, 1)
    dead = lse_col == NEG_INF
    p = torch.exp(logits - torch.where(dead, torch.zeros_like(lse_col), lse_col))
    mask = _attention_mask(
        b, t, s, q.device, causal=causal, q_offset=0, kv_lengths=kv_lengths,
        kv_starts=kv_starts,
    )
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    p = p.masked_fill(dead, 0.0)
    delta = (dof * out.float()).sum(-1).transpose(1, 2)    # (B, Nq, T)
    dp = torch.einsum("btnh,bsnh->bnts", dof, vb)
    ds = p * (dp - delta[..., None])
    dq = scale * torch.einsum("bnts,bsnh->btnh", ds, kb)
    g = nq // nkv
    dk = scale * torch.einsum("bnts,btnh->bsnh", ds, qf).reshape(b, s, nkv, g, h).sum(3)
    dv = torch.einsum("bnts,btnh->bsnh", p, dof).reshape(b, s, nkv, g, h).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_fwd_kernel_for(
    dtype: torch.dtype, h: int, t: int, causal: bool, scale: Optional[float] = None,
) -> str:
    """The name of the hand-written forward kernel a (dtype, head dim, length,
    causal, scale) call takes on CUDA; raises for what no kernel runs. Never
    the plain version. bf16 takes "wgmma" at every supported shape; the one
    remainder left to "mma_sync" is a scale that is not positive (`wgmma`
    takes the row max before it scales); f32 takes "simt"."""
    if dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"flash_attention: dtype {dtype} not supported")
    if h not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {h} not in {SUPPORTED_HEAD_DIMS}")
    if t < 1:
        raise ValueError(f"flash_attention: sequence length {t}")
    if dtype == torch.float32:
        return "simt"
    return "wgmma" if scale is None or scale > 0 else "mma_sync"


def flash_fwd_tile_order(t: int) -> Tuple[int, ...]:
    """The order in which the wgmma kernel's grid visits the query tiles of
    one (batch, head): every tile of ceil(T / 128) exactly once, the last
    (for causal attention the longest) first. The tiles of one (batch, head)
    are neighbours in the grid, so their K/V reads meet in L2."""
    ntiles = -(-t // WGMMA_Q_TILE)
    return tuple(ntiles - 1 - i for i in range(ntiles))


def flash_remainder(dtype: torch.dtype, h: int, needs_grad: bool) -> Optional[str]:
    """Why no hand-written kernel takes a (dtype, head dim, needs a gradient)
    call on CUDA, or None when the kernels take it: the forward takes bf16 and
    f32 at head dims 64/96/128, the backward bf16 only. The dispatcher raises
    for the remainder; the plain version runs only for CPU tensors or when
    the caller asks for it (`use_kernel=False`)."""
    if dtype not in SUPPORTED_DTYPES:
        return f"dtype {dtype}"
    if h not in SUPPORTED_HEAD_DIMS:
        return f"head_dim {h} not in {SUPPORTED_HEAD_DIMS}"
    if needs_grad and dtype != torch.bfloat16:
        return f"the backward kernels take bf16, not {dtype}"
    return None


def flash_bwd_kernel_for(dtype: torch.dtype, h: int, t: int, s: int) -> str:
    """The name of the hand-written backward pair a (dtype, head dim, query
    length, key length) call takes on CUDA; raises for what no kernel runs.
    Never the plain version: "wgmma" takes every bf16 call at H 64/96/128
    (causal or not, any lengths, masks and strides)."""
    if dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_bwd: the backward kernels take bf16, not {dtype}")
    if h not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {h} not in {SUPPORTED_HEAD_DIMS}")
    if t < 1 or s < 1:
        raise ValueError(f"flash_attention_bwd: lengths T {t}, S {s}")
    return "wgmma"


def flash_bwd_tile_order(which: str, n: int) -> Tuple[int, ...]:
    """The order in which a wgmma backward kernel's grid visits the tiles of
    one (batch, head): "dq" the ceil(T / 128) query tiles, the last (for
    causal attention the longest) first; "dkv" the ceil(S / 128) key tiles,
    the first (under causal masking they see the most rows) first. The tiles
    of one (batch, head) are neighbours in the grid, so re-reads meet in L2."""
    if which == "dq":
        ntiles = -(-n // BWD_DQ_ROWS)
        return tuple(ntiles - 1 - i for i in range(ntiles))
    if which == "dkv":
        return tuple(range(-(-n // BWD_DKV_KEYS)))
    raise ValueError(f"flash_bwd_tile_order: no kernel {which!r}")


def flash_bwd_dq_visits(
    s: int, causal: bool, kv_length: Optional[int], kv_start: Optional[int], q0: int,
) -> Tuple[Tuple[int, Tuple[int, ...]], ...]:
    """The loop of the wgmma dq kernel's CTA of query rows [q0, q0 + 128) of
    one batch row: for each warpgroup, (its first row, the first
    keys of the 64-key tiles whose products it runs). Tiles run from the one
    holding kv_start to the diagonal / kv length; a warpgroup skips those
    above its own diagonal. A copy of the bounds in `flash_bwd_dq_wgmma_kernel`
    (csrc/flash_bwd.cu: `hi`, `k_begin`, `ntk`, `wg_hi`), kept for the CPU
    coverage tests: a change to either must be made to both."""
    length = s if kv_length is None else min(kv_length, s)
    lo = 0 if kv_start is None else max(kv_start, 0)
    hi = min(length, q0 + BWD_DQ_ROWS) if causal else length
    tiles = range((lo // BWD_DQ_KEYS) * BWD_DQ_KEYS, hi, BWD_DQ_KEYS)
    out = []
    for row0 in range(q0, q0 + BWD_DQ_ROWS, WARPGROUP_ROWS):
        wg_hi = min(length, row0 + WARPGROUP_ROWS) if causal else length
        out.append((row0, tuple(k0 for k0 in tiles if k0 < wg_hi)))
    return tuple(out)


def flash_bwd_dkv_visits(
    t: int, s: int, g: int, causal: bool, kv_length: Optional[int], kv_start: Optional[int],
    k0: int,
) -> Tuple[Tuple[int, Tuple[Tuple[int, int], ...]], ...]:
    """The loop of the wgmma dk/dv kernel's CTA of keys [k0, k0 + 128) of one
    (batch row, kv head): for each warpgroup, (its first key, the
    (query head in the group, first row) of the 64-row tiles whose products
    it runs), in the kernel's order: the group's heads in turn, for each the
    q tiles from the causal diagonal on. A warpgroup whose keys all lie
    outside [kv_start, kv_length) runs none; one whose keys all lie after a
    tile's rows skips it. A copy of the bounds in `flash_bwd_dkv_wgmma_kernel`
    (csrc/flash_bwd.cu: `active`, `q_first`, `nqt`, `wg_active`,
    `wg_first_key`), kept for the CPU coverage tests: a change to either must
    be made to both."""
    length = s if kv_length is None else min(kv_length, s)
    lo = 0 if kv_start is None else max(kv_start, 0)
    active = k0 < length and k0 + BWD_DKV_KEYS > lo
    q_first = (max(k0, lo) // BWD_DKV_ROWS) * BWD_DKV_ROWS if causal else 0
    tiles = [(gi, q0) for gi in range(g) for q0 in range(q_first, t, BWD_DKV_ROWS)] if active else []
    out = []
    for key0 in range(k0, k0 + BWD_DKV_KEYS, WARPGROUP_ROWS):
        first_key = max(key0, lo)
        if not (key0 < length and key0 + WARPGROUP_ROWS > lo):
            out.append((key0, ()))
            continue
        out.append((key0, tuple(
            (gi, q0) for gi, q0 in tiles if not (causal and q0 + BWD_DKV_ROWS - 1 < first_key)
        )))
    return tuple(out)


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


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def flash_attention_fwd(
    q: torch.Tensor,                  # (B, T, Nq, H)
    k: torch.Tensor,                  # (B, S, Nkv, H)
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,
    kv_starts: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, T, Nq, H) in q's dtype, lse (B, Nq, T) f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    `flash_fwd_kernel_for` names on the current stream, or raise. `kernel`
    forces one of KERNEL_IDS instead (to time or test one against another); a
    dtype that kernel does not take raises."""
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
    if kernel is None:
        kernel = flash_fwd_kernel_for(q.dtype, h, t, causal, scale)
    elif kernel not in KERNEL_IDS:
        raise ValueError(f"flash_attention: no kernel named {kernel!r} (one of {sorted(KERNEL_IDS)})")
    if KERNEL_DTYPES[kernel] != q.dtype:
        raise ValueError(f"flash_attention: the {kernel} kernel takes {KERNEL_DTYPES[kernel]}, not {q.dtype}")
    if kernel == "wgmma" and not scale > 0:
        raise ValueError(f"flash_attention: the wgmma kernel takes a positive scale, not {scale}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, nq, t), dtype=torch.float32, device=q.device)
    lens = _int32_on(kv_lengths, q.device)
    starts = _int32_on(kv_starts, q.device)
    rc = lib.visper_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _ptr(lens), _ptr(starts),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, t, s, nq, nkv, h, float(scale), int(causal),
        KERNEL_IDS[kernel],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention: {kernel} kernel launch failed with CUDA error {rc}")
    launches += 1
    return out, lse


def _bwd_launch(
    fn: str, q, k, v, dout, lse, delta, kv_lengths, kv_starts, causal, scale,
) -> Tuple[torch.Tensor, ...]:
    """Launch the dq (B2) or dk/dv (B3) kernel on the current stream (bf16
    only): the one `flash_bwd_kernel_for` names."""
    _check(q, k, v, kv_lengths, kv_starts)
    b, t, nq, h = q.shape
    s, nkv = k.shape[1], k.shape[2]
    kernel = flash_bwd_kernel_for(q.dtype, h, t, s)    # raises for what no kernel takes
    if dout.shape != q.shape or lse.shape != (b, nq, t) or delta.shape != (b, nq, t):
        raise ValueError("flash_attention_bwd: dout/lse/delta shapes do not match q")
    from visper_lm_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    if scale is None:
        scale = h ** -0.5
    dout = dout.to(q.dtype)
    if dout.stride(-1) != 1 or dout.data_ptr() % 16 or any(st % 8 for st in dout.stride()[:3]):
        dout = dout.clone(memory_format=torch.contiguous_format)   # rows 16-byte aligned
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    if fn == "dq":
        outs = (torch.empty(q.shape, dtype=q.dtype, device=q.device),)
        dq, dk, dv = outs[0], k, v        # dk/dv unused by the dq kernel
    else:
        outs = (torch.empty(k.shape, dtype=k.dtype, device=q.device),
                torch.empty(v.shape, dtype=v.dtype, device=q.device))
        dq, (dk, dv) = q, outs            # dq unused by the dk/dv kernel
    lens = _int32_on(kv_lengths, q.device)
    starts = _int32_on(kv_starts, q.device)
    strides = (ctypes.c_longlong * 21)(*(
        st for x in (q, k, v, dout, dq, dk, dv) for st in x.stride()[:3]
    ))
    rc = getattr(lib, f"visper_flash_bwd_{fn}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _ptr(lens), _ptr(starts), strides,
        b, t, s, nq, nkv, h, float(scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention: {kernel} {fn} kernel launch failed with CUDA error {rc}")
    return outs


def flash_attention_bwd_dq(
    q, k, v, dout, lse, delta, *, causal=True, kv_lengths=None, kv_starts=None, scale=None,
) -> torch.Tensor:
    """B2: dq (B, T, Nq, H) in q's dtype, from dout, the forward's lse and
    delta = rowsum(dout o out) (B, Nq, T) f32. bf16 CUDA tensors only."""
    global dq_launches
    (dq,) = _bwd_launch("dq", q, k, v, dout, lse, delta, kv_lengths, kv_starts, causal, scale)
    dq_launches += 1
    return dq


def flash_attention_bwd_dkv(
    q, k, v, dout, lse, delta, *, causal=True, kv_lengths=None, kv_starts=None, scale=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3: (dk, dv) (B, S, Nkv, H) in the input dtypes, summed over each kv
    head's query group. bf16 CUDA tensors only."""
    global dkv_launches
    dk, dv = _bwd_launch("dkv", q, k, v, dout, lse, delta, kv_lengths, kv_starts, causal, scale)
    dkv_launches += 1
    return dk, dv


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,                # (B, T, Nq, H) the forward's output
    lse: torch.Tensor,                # (B, Nq, T) f32 the forward's lse
    dout: torch.Tensor,               # (B, T, Nq, H)
    *,
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,
    kv_starts: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtypes and shapes.

    CPU tensors take the plain version; bf16 CUDA tensors get delta from a
    plain torch reduction and launch the dq kernel (B2) and the dk/dv kernel
    (B3) on the current stream; other CUDA tensors raise."""
    kw = dict(causal=causal, kv_lengths=kv_lengths, kv_starts=kv_starts, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, dout, **kw)
    if out.shape != q.shape:
        raise ValueError("flash_attention_bwd: out shape does not match q")
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """JAX `_flash_bhtd`'s custom VJP: the forward saves q, k, v, out, lse and
    the masks; the backward runs the two backward kernels. It returns dq, dk
    and dv whenever q, k or v need a gradient (a frozen decoder's inputs
    still do).

    `saved` (a list, or None) keeps the forward across a rematerialised
    block's recompute (the save_flash remat policies): an empty list gets
    (out, lse) appended, a list that holds them is used instead of running
    the forward again, so the recompute launches no kernel."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, kv_starts, causal, scale, saved):
        if saved:
            out, lse = saved[0].detach(), saved[1]
        else:
            out, lse = flash_attention_fwd(
                q, k, v, causal=causal, kv_lengths=kv_lengths, kv_starts=kv_starts,
                scale=scale,
            )
            if saved is not None:
                saved.extend((out.detach(), lse))
        ctx.save_for_backward(q, k, v, out, lse, kv_lengths, kv_starts)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_lengths, kv_starts = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout, causal=ctx.causal, kv_lengths=kv_lengths,
            kv_starts=kv_starts, scale=ctx.scale,
        )
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,
    kv_starts: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    saved: Optional[list] = None,
) -> torch.Tensor:
    """Flash attention in the BTNH convention, differentiable; returns out
    (B, T, Nq, H).

    kv_starts masks columns before a per-batch start (left padding, generation
    prefill); kv_lengths masks columns at/after a per-batch length. `saved`:
    see `FlashAttention`."""
    return FlashAttention.apply(q, k, v, kv_lengths, kv_starts, causal, scale, saved)
