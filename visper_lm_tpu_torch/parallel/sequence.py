"""Sequence parallelism: Ulysses all-to-all attention and ring attention over
a 'seq' axis (counterpart of visper_lm_tpu/parallel/sequence.py).

The activations flow through the decoder as each rank's rows: a rank of a
sequence-parallel group of sp holds rows [r T/sp, (r+1) T/sp) of every
(B, T, ...) activation (JAX shards the global arrays (B, T/sp, N, H) along
'seq' the same way). Everything but attention is per row; attention needs
every row of a head:

  * `ulysses_attention` (DeepSpeed-Ulysses, arXiv:2309.14509): an
    all-to-all turns the rank's rows of every head into every row of
    N/sp heads, the single-device attention runs on them
    (`ops/attention.multi_head_attention`: the flash kernel B1 on CUDA,
    B2/B3 in its backward, the plain version on the CPU), and a second
    all-to-all gives the rows back. The exchange's backward is the inverse
    exchange (`distributed.all_to_all_autograd`). Under tensor parallelism
    the rank's heads are nq/tp, so the heads Ulysses splits are nq/(tp sp).
  * `ring_attention` (arXiv:2310.01889): every rank keeps all its heads and
    rows, and the K/V blocks travel around the ring one hop a stage
    (`distributed.ring_shift_autograd`, whose backward is the shift the
    other way), with the flash recurrence (running max m, normalizer l,
    weighted sum acc) in f32 in stock torch ops, as JAX leaves it to XLA.
    It takes any head count: the route sends a call whose heads do not
    divide sp (GQA with few kv heads) here.

Both keep JAX's guards and its fall-through to plain attention at sp = 1,
and hold `kv_lengths` / `kv_starts` global. JAX's `b % dp` guard has no
twin: each process is handed its data rank's rows already.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from visper_lm_tpu_torch.parallel import distributed
from visper_lm_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class SequenceParallel:
    """One rank's sequence-parallel group: the process group, the rank's
    seq coordinate and the group's size."""

    group: Any
    rank: int
    size: int

    def rows(self, t: int) -> slice:
        """This rank's rows of a sequence of `t` (t must divide by the size)."""
        if t % self.size:
            raise ValueError(
                f"sequence parallelism: T ({t}) % sp ({self.size}) != 0; the port cannot attend "
                "over a remainder of rows")
        n = t // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def positions(self, t_local: int, device) -> torch.Tensor:
        """The global positions of this rank's `t_local` rows."""
        return self.rank * t_local + torch.arange(t_local, device=device)


def sequence_parallel(mesh: Optional[Mesh]) -> Optional[SequenceParallel]:
    """This process's `SequenceParallel` on the mesh's seq axis (collective:
    every process makes every group), None when the axis is 1 wide."""
    if mesh is None or mesh.seq_size == 1:
        return None
    group, rank, size = distributed.seq_group(mesh)
    return SequenceParallel(group, rank, size)


def local_rows(x: torch.Tensor, seq: Optional[SequenceParallel], dim: int = 1) -> torch.Tensor:
    """This rank's rows of a whole (.., T, ..) tensor along `dim` (a
    differentiable slice: the other rows get no gradient here)."""
    if seq is None:
        return x
    r = seq.rows(x.shape[dim])
    return x.narrow(dim, r.start, r.stop - r.start)


def gather_rows(x: torch.Tensor, seq: Optional[SequenceParallel], dim: int = 1) -> torch.Tensor:
    """Every rank's rows along `dim`, whole, with gradients summed back to
    each rank's rows (`all_gather_autograd`)."""
    if seq is None:
        return x
    return distributed.all_gather_autograd(x.contiguous(), dim, seq.group)


def ulysses_attention(
    q: torch.Tensor,                       # (B, T/sp, Nq, H): this rank's rows
    k: torch.Tensor,                       # (B, T/sp, Nkv, H)
    v: torch.Tensor,
    *,
    seq: Optional[SequenceParallel],
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,   # (B,) valid kv length, global
    kv_starts: Optional[torch.Tensor] = None,    # (B,) first valid kv slot, global
    scale: Optional[float] = None,
    use_kernel: Optional[bool] = None,
    saved: Optional[list] = None,
) -> torch.Tensor:
    """Sequence-parallel self-attention on this rank's rows; differentiable
    (the all-to-all's backward is the inverse all-to-all). Returns the
    rank's rows (B, T/sp, Nq, H). `saved` is the inner attention's
    (`multi_head_attention`: the flash output a remat policy keeps)."""
    from visper_lm_tpu_torch.ops.attention import multi_head_attention

    sp = 1 if seq is None else seq.size
    if sp == 1:
        return multi_head_attention(
            q, k, v, causal=causal, kv_lengths=kv_lengths, kv_starts=kv_starts, scale=scale,
            use_kernel=use_kernel, saved=saved,
        )
    nq, nkv = q.shape[2], k.shape[2]
    if nq % sp or nkv % sp:
        raise ValueError(f"heads ({nq} q / {nkv} kv) must divide the 'seq' axis ({sp})")

    def a2a(x, split_dim, concat_dim):
        return distributed.all_to_all_autograd(x, split_dim, concat_dim, seq.group)

    # rows -> heads: (B, T/sp, N, H) -> (B, T, N/sp, H)
    q, k, v = a2a(q, 2, 1), a2a(k, 2, 1), a2a(v, 2, 1)
    # every row of the rank's heads is here: global causality and padding are exact
    out = multi_head_attention(
        q, k, v, causal=causal, kv_lengths=kv_lengths, kv_starts=kv_starts, scale=scale,
        use_kernel=use_kernel, saved=saved,
    )
    # heads -> rows
    return a2a(out, 1, 2)


def ring_attention(
    q: torch.Tensor,                       # (B, T/sp, Nq, H): this rank's rows
    k: torch.Tensor,                       # (B, T/sp, Nkv, H)
    v: torch.Tensor,
    *,
    seq: Optional[SequenceParallel],
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,
    kv_starts: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ring (context-parallel) self-attention on this rank's rows: sp
    stages, each attending to one rank's K/V block, which then moves one
    hop around the ring. The recurrence is f32; masked logits take the
    finite `_NEG_INF` (a row with no valid key degrades to a uniform
    average, as `mha_plain`'s, never NaN). The running max takes no
    gradient (the result does not depend on it). Differentiable; GQA
    repeats each kv head inside the stage."""
    from visper_lm_tpu_torch.ops.attention import _NEG_INF, mha_plain

    sp = 1 if seq is None else seq.size
    b, tl, nq, h = q.shape
    nkv = k.shape[2]
    if sp == 1:
        return mha_plain(q, k, v, causal=causal, kv_lengths=kv_lengths, kv_starts=kv_starts,
                         scale=scale)
    if nq % nkv:
        raise ValueError(f"Nq ({nq}) % Nkv ({nkv}) != 0")
    if scale is None:
        scale = h ** -0.5
    g = nq // nkv
    dev = q.device
    if kv_lengths is None:
        kv_lengths = torch.full((b,), tl * sp, dtype=torch.long, device=dev)
    if kv_starts is None:
        kv_starts = torch.zeros((b,), dtype=torch.long, device=dev)
    kv_lengths, kv_starts = kv_lengths.to(dev), kv_starts.to(dev)
    my = seq.rank

    acc = torch.zeros((b, nq, tl, h), dtype=torch.float32, device=dev)
    m = torch.full((b, nq, tl, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, nq, tl, 1), dtype=torch.float32, device=dev)
    # q scaled in f32 and rounded to its dtype before the dot, as in JAX
    qf = (q.float() * scale).to(q.dtype).float()
    q_pos = my * tl + torch.arange(tl, device=dev)              # (Tl,) global
    kv = torch.stack([k, v])                                     # one exchange a stage
    for step in range(sp):
        src = (my - step) % sp                                   # owner of this K/V
        kb, vb = kv[0], kv[1]
        if g > 1:
            kb, vb = kb.repeat_interleave(g, dim=2), vb.repeat_interleave(g, dim=2)
        s = torch.einsum("btnh,bsnh->bnts", qf, kb.float())
        kv_pos = src * tl + torch.arange(tl, device=dev)        # (Sl,) global
        valid = (kv_pos[None, :] >= kv_starts[:, None]) & (kv_pos[None, :] < kv_lengths[:, None])
        mask = valid[:, None, None, :]                           # (B, 1, 1, Sl)
        if causal:
            mask = mask & (q_pos[:, None] >= kv_pos[None, :])[None, None]
        s = s.masked_fill(~mask, _NEG_INF)
        m_new = torch.maximum(m, s.detach().amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bnts,bsnh->bnth", p.to(vb.dtype).float(), vb.float())
        acc = acc * corr + pv
        m = m_new
        if step != sp - 1:
            kv = distributed.ring_shift_autograd(kv, seq.group)
    # l >= exp(m_global - m_global) = 1 after the last stage: no zero guard
    return (acc / l).transpose(1, 2).to(q.dtype)                 # (B, Tl, Nq, H)
