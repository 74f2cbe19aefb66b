"""Attention dispatch (counterpart of visper_lm_tpu/ops/attention.py).

  * `mha_plain` — plain PyTorch attention (JAX `mha_xla`): the CPU path and the
    numerical reference of the flash kernel.
  * `mha_plain_cache` — decode attention over the slot-major (S, B, Nkv, H)
    cache (bf16 / f32, or int8 with per-vector scales folded into scores and
    probabilities) plus the current chunk as extras (JAX `mha_xla_cache`).
  * `multi_head_attention` — sends eligible self-attention on CUDA tensors to
    the hand-written flash kernel (ops/flash_attention.py), everything else
    to `mha_plain`, with the JAX package's eligibility predicate; an eligible
    CUDA call that the kernels do not take (`flash_remainder`) raises.

Shapes follow the "BTNH" convention: q (B, T, Nq, H), k/v (B, S, Nkv, H).
Dot products run on operands rounded to the working dtype and accumulate in
f32, as the JAX code's `preferred_element_type=f32` does; bf16 products are
exact in f32, so upcasting the rounded operands gives the same sums. Mesh,
Ulysses and ring routing are not carried over (one card).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

_NEG_INF = -2.3819763e38  # finite mask value, as in the JAX package

Offset = Union[int, torch.Tensor]


def _broadcast_kv(k: torch.Tensor, q_heads: int) -> torch.Tensor:
    """(B, S, Nkv, H) -> (B, S, Nq, H) by repeating each KV head G times."""
    nkv = k.shape[2]
    if nkv == q_heads:
        return k
    return k.repeat_interleave(q_heads // nkv, dim=2)


def _attention_mask(
    b: int, t: int, s: int, device: torch.device, *, causal: bool, q_offset: Offset,
    kv_lengths: Optional[torch.Tensor], kv_starts: Optional[torch.Tensor],
) -> Optional[torch.Tensor]:
    """Boolean (B or 1, 1, T, S) mask of the attended pairs, None = all."""
    mask = None
    cols = torch.arange(s, device=device)
    if causal:
        off = torch.as_tensor(q_offset, device=device).reshape(-1, 1, 1)
        q_pos = off + torch.arange(t, device=device)[None, :, None]
        mask = (q_pos >= cols[None, None, :])[:, None]
    if kv_lengths is not None:
        valid = (cols[None, :] < kv_lengths.to(device)[:, None])[:, None, None, :]
        mask = valid if mask is None else mask & valid
    if kv_starts is not None:
        valid = (cols[None, :] >= kv_starts.to(device)[:, None])[:, None, None, :]
        mask = valid if mask is None else mask & valid
    return mask


def masked_logits(
    q: torch.Tensor, k: torch.Tensor, *, causal: bool = True, q_offset: Offset = 0,
    kv_lengths: Optional[torch.Tensor] = None, kv_starts: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """f32 scores (B, Nq, T, S) with masked pairs at _NEG_INF, and the mask."""
    b, t, nq, h = q.shape
    s = k.shape[1]
    if scale is None:
        scale = h ** -0.5
    k = _broadcast_kv(k, nq)
    # q is scaled in f32 and rounded to its dtype before the dot, as in JAX
    qf = (q.float() * scale).to(q.dtype)
    logits = torch.einsum("btnh,bsnh->bnts", qf.float(), k.float())
    mask = _attention_mask(
        b, t, s, q.device, causal=causal, q_offset=q_offset,
        kv_lengths=kv_lengths, kv_starts=kv_starts,
    )
    if mask is not None:
        logits = logits.masked_fill(~mask, _NEG_INF)
    return logits, mask


def mha_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: Offset = 0,
    kv_lengths: Optional[torch.Tensor] = None,
    kv_starts: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain multi-head attention (JAX `mha_xla`).

    q (B, T, Nq, H); k, v (B, S, Nkv, H) with Nq % Nkv == 0. Causal masking
    puts query t at position q_offset + t (int or per-batch (B,) tensor).
    kv_lengths masks columns >= length, kv_starts columns < start. A row with
    no valid column averages all of v uniformly (the flash kernel gives 0).
    Returns (B, T, Nq, H) in q's dtype.
    """
    logits, _ = masked_logits(
        q, k, causal=causal, q_offset=q_offset, kv_lengths=kv_lengths,
        kv_starts=kv_starts, scale=scale,
    )
    probs = torch.softmax(logits, dim=-1)
    v = _broadcast_kv(v, q.shape[2])
    out = torch.einsum("bnts,bsnh->btnh", probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: Offset = 0,
    kv_lengths: Optional[torch.Tensor] = None,
    kv_starts: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    use_kernel: Optional[bool] = None,
    saved: Optional[list] = None,
) -> torch.Tensor:
    """Flash kernel for eligible self-attention on CUDA tensors, plain elsewhere.

    use_kernel=None means "the tensors are on CUDA" (JAX: "running on TPU");
    False forces the plain path. Eligibility is the JAX predicate: T == S,
    T >= 128, T % 128 == 0, head_dim 96 or a multiple of 64, q_offset == 0.
    An eligible call on CUDA that no hand-written kernel takes (head dims
    other than 64/96/128, dtypes other than bf16/f32, f32 inputs that need a
    gradient: `flash_remainder`) raises ValueError before the forward runs;
    on the CPU the flash Function runs the plain versions, which take every
    call.

    `saved` (a list, or None) keeps the flash kernel's output across a
    rematerialised block's recompute (the save_flash remat policies): the
    first call fills it, a later call with the same list returns what it
    holds and launches no forward (`FlashAttention`). The plain path ignores
    it and recomputes.
    """
    if use_kernel is None:
        use_kernel = q.is_cuda
    t, s, head_dim = q.shape[1], k.shape[1], q.shape[-1]
    eligible = (
        use_kernel
        and t == s
        and t >= 128
        and t % 128 == 0
        and (head_dim % 64 == 0 or head_dim in (96,))
        and isinstance(q_offset, int)
        and q_offset == 0
    )
    if not eligible:
        return mha_plain(
            q, k, v, causal=causal, q_offset=q_offset, kv_lengths=kv_lengths,
            kv_starts=kv_starts, scale=scale,
        )
    from visper_lm_tpu_torch.ops.flash_attention import flash_attention, flash_remainder

    if q.is_cuda:
        needs_grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
        why = flash_remainder(q.dtype, head_dim, needs_grad)
        if why is not None:
            raise ValueError(
                f"multi_head_attention: no hand-written kernel takes this call ({why}); "
                "pass use_kernel=False for the plain path"
            )
    return flash_attention(
        q, k, v, causal=causal, kv_lengths=kv_lengths, kv_starts=kv_starts, scale=scale,
        saved=saved,
    )


def mha_plain_cache(
    q: torch.Tensor,                 # (B, T, Nq, H)
    k: torch.Tensor,                 # (S, B, Nkv, H) slot-major cache (read only), float or int8
    v: torch.Tensor,                 # (S, B, Nkv, H)
    k_scale: Optional[torch.Tensor] = None,  # (S, B, Nkv) f32 when k is int8
    v_scale: Optional[torch.Tensor] = None,
    *,
    extra_k: torch.Tensor,           # (B, T, Nkv, H) current chunk K
    extra_v: torch.Tensor,           # (B, T, Nkv, H) current chunk V
    cache_len: Offset,               # the cache holds tokens [0, cache_len)
    kv_starts: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over the slot-major cache + the current chunk as extras
    (JAX `mha_xla_cache`).

    The cache is read only; the caller writes the chunk's K/V into it after
    this call. Dot operands are rounded to the wider of q's and the cache's
    dtype for a float cache (bf16 for a bf16 model and cache; f32 for an f32
    model over the bf16 cache the serving engine keeps, as JAX's f32 dots on
    the CPU) and to q's dtype for an int8 cache (bf16 on the card, f32 for an
    f32 model), and accumulate in f32. cache_len is an int, a 0-d tensor or
    a (B,) tensor (a length per sample), never read on the host. The int8 cache's
    per-vector scales are folded in, not dequantized: k scales multiply the
    cache scores after the dot, v scales the cache probabilities before the
    PV dot. GQA is a grouped query reshape: K/V are never repeated.
    """
    b, t, nq, h = q.shape
    s_len, nkv = k.shape[0], k.shape[2]
    g = nq // nkv
    if scale is None:
        scale = h ** -0.5
    dot_t = q.dtype if k_scale is not None else torch.promote_types(q.dtype, k.dtype)
    qd = (q.float() * scale).reshape(b, t, nkv, g, h).to(dot_t).float()

    logits_c = torch.einsum("btkgh,sbkh->bkgts", qd, k.to(dot_t).float())
    if k_scale is not None:
        logits_c = logits_c * k_scale.permute(1, 2, 0)[:, :, None, None, :]
    pos = torch.arange(s_len, device=q.device)
    limit = torch.as_tensor(cache_len, device=q.device).reshape(-1).expand(b)
    valid = pos[None, :] < limit[:, None]
    if kv_starts is not None:
        valid = valid & (pos[None, :] >= kv_starts.to(q.device)[:, None])
    logits_c = logits_c.masked_fill(~valid[:, None, None, None, :], _NEG_INF)

    logits_e = torch.einsum("btkgh,bukh->bkgtu", qd, extra_k.to(dot_t).float())
    tri = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    logits_e = logits_e.masked_fill(~tri, _NEG_INF)

    probs = torch.softmax(torch.cat([logits_c, logits_e], dim=-1), dim=-1)
    pc, pe = probs[..., :s_len], probs[..., s_len:]
    if v_scale is not None:
        pc = pc * v_scale.permute(1, 2, 0)[:, :, None, None, :]
    out = torch.einsum("bkgts,sbkh->btkgh", pc.to(dot_t).float(), v.to(dot_t).float())
    out = out + torch.einsum(
        "bkgtu,bukh->btkgh", pe.to(dot_t).float(), extra_v.to(dot_t).float()
    )
    return out.reshape(b, t, nq, h).to(q.dtype)
