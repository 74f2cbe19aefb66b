"""Single-token decode attention over a head-major cache: the CUDA kernel's
wrapper and its plain version.

Counterpart of visper_lm_tpu/ops/decode_attention.py `decode_attention`
(:126; the Pallas `_decode_kernel` :67, pallas_call :188) as csrc/decode_attn.cu
(B6). Same function: q (B, 1, Nq, H) is the newest token, the cache
(B, Nkv, S, H) is bf16, or int8 with per-vector f32 scales (B, Nkv, S) folded
into the scores (k) and the probabilities (v), never dequantized; positions
outside [kv_starts, kv_lengths) are masked; a row with no valid position gives
0; GQA maps query head h to kv head h // G.

Like the JAX op, this is a standalone op: no decode path calls it. Decode
attends through ops/attention.mha_plain_cache over the slot-major
(S, B, Nkv, H) cache with the current chunk as extras, as the JAX package's
decode does through `mha_xla_cache`. Routing decode through this kernel would
need a head-major cache.

`decode_attention` launches a kernel for CUDA tensors or raises; CPU
tensors take the plain version. csrc/decode_attn.cu holds two kernels:
"split" (every supported shape: S cut by `decode_split_plan` into spans, one
CTA each, the CTAs of a (batch, kv head) one thread block cluster that merges
its partial softmaxes in split order through distributed shared memory, so a
launch gives the same bits run after run) and "serial" (the kernel before it,
one CTA per (batch, kv head); kept to be timed beside the other, forced with
`kernel="serial"`). The plan depends on shapes only: the wrapper never reads
`kv_lengths` or `kv_starts` on the host. `launches` counts kernel launches.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

SUPPORTED_HEAD_DIMS = (64, 96, 128)
MAX_GROUP = 4      # query heads per kv head the kernel keeps in registers

KERNEL_IDS = {"serial": 0, "split": 1}

SPLIT_POS_STEP = 16          # positions a CTA of 128 threads handles per step (8 threads each)
SPLIT_MAX_SPLITS = 8         # the splits of a (batch, kv head) are one cluster (portable size 8)
SPLIT_TARGET_CTAS = 2112     # sixteen CTAs for each of an H100's 132 SMs: two waves of eight
SPLIT_SLAB_BYTES = 12 * 1024  # K rows (and as many V rows) a CTA holds in shared memory at once
SPLIT_MIN_SPAN = 32          # no span shorter than this unless S is

# Kernel launches since the last reset; a caller sets it to 0 and reads it.
launches = 0


@functools.lru_cache(maxsize=None)
def decode_split_plan(b: int, nkv: int, s: int, h: int, elem_bytes: int) -> Tuple[int, int, int]:
    """(span, splits, round) of the split kernel for a (B, Nkv, S, H) cache of
    `elem_bytes`-byte elements: split i takes positions [i * span, (i + 1) *
    span) of S, so every position lies in exactly one split; `round` <= span
    is how many of them a CTA holds in shared memory at once (a longer span
    takes several rounds). A pure function of the shapes, never of
    kv_lengths or kv_starts: each CTA clips its span on the device. As many
    splits, up to SPLIT_MAX_SPLITS, as it takes to reach SPLIT_TARGET_CTAS
    CTAs and, where the cluster allows, to fit a span into one round."""
    cap = max(SPLIT_POS_STEP,
              SPLIT_SLAB_BYTES // (h * elem_bytes) // SPLIT_POS_STEP * SPLIT_POS_STEP)
    for_ctas = min(-(-SPLIT_TARGET_CTAS // (b * nkv)), max(1, s // SPLIT_MIN_SPAN))
    want = max(1, min(SPLIT_MAX_SPLITS, max(for_ctas, -(-s // cap))))
    span = -(-(-(-s // want)) // SPLIT_POS_STEP) * SPLIT_POS_STEP
    return span, -(-s // span), min(span, cap)


def decode_split_smem_bytes(round_positions: int, h: int, elem_bytes: int, group: int) -> int:
    """Dynamic shared memory of a split-kernel CTA: the K and V slabs, both
    scale rows and the scores of the query heads the registers hold (1, 2 or 4)."""
    held = 1 if group == 1 else 2 if group == 2 else 4
    return 2 * round_positions * h * elem_bytes + (2 + held) * round_positions * 4


def decode_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    *,
    kv_lengths: torch.Tensor,
    kv_starts: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version, in f32 (the JAX kernel's arithmetic): scores
    (q . k) * scale [* k_scale], masked outside [start, length); p = exp(s - max)
    [* v_scale] against v; divided by the sum of p, or 0 with no valid
    position. Returns (B, 1, Nq, H) in q's dtype."""
    b, _, nq, h = q.shape
    nkv, s_len = k.shape[1], k.shape[2]
    if scale is None:
        scale = h ** -0.5
    qf = q.float().reshape(b, nkv, nq // nkv, h)
    s = torch.einsum("bkgh,bksh->bkgs", qf, k.float()) * scale
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]
    pos = torch.arange(s_len, device=q.device)
    valid = pos[None, :] < kv_lengths.to(q.device)[:, None]
    if kv_starts is not None:
        valid = valid & (pos[None, :] >= kv_starts.to(q.device)[:, None])
    valid = valid[:, None, None, :]
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    p = p.masked_fill(~valid, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, :]
    acc = torch.einsum("bkgs,bksh->bkgh", p, v.float())
    out = torch.where(l > 0, acc / l.clamp(min=1e-30), torch.zeros_like(acc))
    return out.reshape(b, 1, nq, h).to(q.dtype)


def _check(q, k, v, k_scale, v_scale, kv_lengths, kv_starts) -> None:
    tensors = [("q", q), ("k", k), ("v", v), ("kv_lengths", kv_lengths)]
    tensors += [(n, x) for n, x in (("k_scale", k_scale), ("v_scale", v_scale),
                                    ("kv_starts", kv_starts)) if x is not None]
    for name, x in tensors:
        if not x.is_cuda:
            raise ValueError(f"decode_attention: {name} is on {x.device}, expected CUDA")
        if x.device != q.device:
            raise ValueError("decode_attention: inputs on different devices")
        if x.is_contiguous() and x.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte aligned")
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention: q must be (B, 1, Nq, H), got {tuple(q.shape)}")
    b, _, nq, h = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != h:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"decode_attention: the kernel takes bf16 q, not {q.dtype}")
    if k.dtype != v.dtype or k.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"decode_attention: the cache must be bf16 or int8, not {k.dtype}/{v.dtype}")
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None and v_scale is not None):
        raise ValueError("decode_attention: an int8 cache needs k_scale and v_scale, bf16 none")
    if quant:
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if x.dtype != torch.float32 or tuple(x.shape) != tuple(k.shape[:3]):
                raise ValueError(f"decode_attention: {name} must be f32 {tuple(k.shape[:3])}")
    if h not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {h} not in {SUPPORTED_HEAD_DIMS}")
    nkv = k.shape[1]
    if nq % nkv or nq // nkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {nq} query heads over {nkv} kv heads (group <= {MAX_GROUP})")
    for name, x in (("kv_lengths", kv_lengths), ("kv_starts", kv_starts)):
        if x is not None and tuple(x.shape) != (b,):
            raise ValueError(f"decode_attention: {name} must have shape ({b},)")


def decode_attention(
    q: torch.Tensor,                        # (B, 1, Nq, H) the newest token
    k: torch.Tensor,                        # (B, Nkv, S, H) bf16 or int8
    v: torch.Tensor,                        # (B, Nkv, S, H)
    k_scale: Optional[torch.Tensor] = None,  # (B, Nkv, S) f32 when int8
    v_scale: Optional[torch.Tensor] = None,
    *,
    kv_lengths: torch.Tensor,               # (B,) valid length incl. this token
    kv_starts: Optional[torch.Tensor] = None,  # (B,) first valid slot (left pad)
    scale: Optional[float] = None,
    kernel: Optional[str] = None,
) -> torch.Tensor:
    """(B, 1, Nq, H) in q's dtype. CPU tensors take the plain version (any
    float q); CUDA tensors (bf16 q) launch the split kernel on the current
    stream or raise. `kernel` forces one of KERNEL_IDS instead (to time or
    test one against the other)."""
    kw = dict(kv_lengths=kv_lengths, kv_starts=kv_starts, scale=scale)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, k_scale, v_scale, **kw)
    _check(q, k, v, k_scale, v_scale, kv_lengths, kv_starts)
    if kernel is None:
        kernel = "split"
    elif kernel not in KERNEL_IDS:
        raise ValueError(f"decode_attention: no kernel named {kernel!r} (one of {sorted(KERNEL_IDS)})")
    from visper_lm_tpu_torch.ops import _build

    global launches
    lib = _build.load("decode_attn")
    b, _, nq, h = q.shape
    nkv, s_len = k.shape[1], k.shape[2]
    if scale is None:
        scale = h ** -0.5
    quant = k.dtype == torch.int8
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    ks = k_scale.contiguous() if quant else None
    vs = v_scale.contiguous() if quant else None
    lens = kv_lengths.to(device=q.device, dtype=torch.int32).contiguous()
    starts = None if kv_starts is None else kv_starts.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    span, splits, round_positions = decode_split_plan(b, nkv, s_len, h, k.element_size())
    rc = lib.visper_decode_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(),
        out.data_ptr(), lens.data_ptr(), None if starts is None else starts.data_ptr(),
        b, nq, nkv, s_len, h, float(scale), int(quant),
        KERNEL_IDS[kernel], span, splits, round_positions,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode_attention: {kernel} kernel launch failed with CUDA error {rc}")
    launches += 1
    return out
