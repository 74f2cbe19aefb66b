"""Decoder-only transformer (counterpart of visper_lm_tpu/models/decoder.py).

Covers Phi3-mini-4k and Llama-style decoders: pre-norm blocks with GQA
attention, rope and a SiLU-gated MLP, a slot-major KV cache for serving (bf16
/ f32, or int8 with per-vector scales) written at one offset for the batch or
one per sample (`write_cache_chunk`), quantized serving weights
(`quantize_decoder`: w8a16 or w4a16 `QuantLinear`s), per-channel activation
statistics for AWQ calibration, and layer taps for the distillation heads in
training. The JAX layer `lax.scan` over stacked blocks becomes a Python loop
over an `nn.ModuleList`.

Mixture of experts (cfg.moe_experts > 0, JAX's sparse block): the block's
MLP is ops/moe.py's `moe_mlp` (a router `moe_router`, f32, and the expert
banks `moe_gate` / `moe_up` / `moe_down` in JAX's (E, din, dout) layout, a
rank's E/ep of them under expert parallelism, `Decoder.ep`). Each MoE block
also returns its aux losses, and the decoder returns their mean over the
layers as `moe_aux` (JAX's, which the train loss adds); the cache path
returns them too (JAX drops them there). With `moe_data` (the routing
group, `distributed.routing_group`: the data x seq ranks, which the train
step's loss passes under data or sequence parallelism, and the data group
the Generator passes) capacity, priority and the aux are the global
batch's; every other call routes over its own tokens. Under sequence
parallelism a rank holds T/sp rows, so a MoE forward there needs the
routing group over its seq axis (else it raises), as JAX's layer sees the
global arrays. Under pipeline parallelism a MoE stack is not pipelined
(JAX's `_maybe_pipelined_stack` takes no MoE): it runs the plain loop, each
foreign block gathered from its owner (under ep the owner's E/ep slice of
the banks, the rank's own experts). A remat policy saves nothing inside the
MoE block (JAX names no site there); the streamed layout raises (JAX's
assert). Under tensor parallelism the banks are replicated over the group
and each rank runs the whole MoE MLP on the full hidden state after the
row-parallel all-reduce (JAX's rules put no 'model' dim on them).

LoRA (`Decoder.forward(lora=...)`, JAX `_lora_linear`): the factors of each
targeted linear, (A, B scaled) stacked over the layers (models/lora.py),
add the rank-r side path y = x W + (x A) B in every block, with A and B cast
to x's dtype; dA and dB come from rank-r intermediates only. Under tensor
parallelism the factors stay whole (`lora_side`): a column-parallel target
adds (x A) B_r with the rank's columns of B, a row-parallel one adds
all-reduce(x_r A_r) B after its output's all-reduce; the gradients of A and
B come out whole and equal on every rank.

Rematerialisation (`Decoder.forward(remat=True, remat_policy=...)`, JAX
`jax.checkpoint` with `_remat_policy`) wraps each block in
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`: the forward keeps
the block's input, the backward runs the block again to rebuild what it
needs. A policy names tensors the recompute does not rebuild (JAX's
`checkpoint_name` sites, `REMAT_POLICIES`): the block's first run keeps
them in a `_Stash`, and its recompute takes them from there without running
the op that made them. A kept linear output (`qkv` post-rope, `mlp_gate`,
`mlp_up`) is a `_StashedLinear`, whose backward is the linear's (and rope's)
vector-Jacobian product, so the gradient still reaches the block's input
and, when it trains, the weight; a kept attention output (`flash_out`, with
the flash forward's lse) goes through the `saved` list of
`multi_head_attention`, so the recompute launches no flash forward.

Tensor parallelism (parallel/tensor.py `shard_model`: `Decoder.tp`, as it
carries `zero3`): each block runs nh/tp query and nkv/tp kv heads (the
flash kernel on the local heads, once a layer) and mlp_dim/tp columns; the
column-parallel inputs pass `copy_to_group`, o_proj's and down_proj's
outputs `reduce_from_group`. The lookup is `Decoder.embed` (vocab-parallel
under tp), `Decoder.logits` gathers the vocabulary unless the loss asks for
the rank's block, and a cache holds the local kv heads (`init_kv_cache(...,
tp=)`). `quantize_decoder` quantizes each rank's slices into the slices of
the one-device quantized decoder.

Sequence parallelism (`Decoder.seq`, parallel/sequence.py, carried as `tp`
is): the rank holds its T/sp rows of `inputs_embeds` through the whole
stack, rope takes the rows' global positions, `kv_lengths` / `kv_starts`
stay global, and attention goes through Ulysses or the ring
(`multi_head_attention(seq=)`); the taps, `hidden` and the logits are the
rank's rows. A cache raises: serving is not sequence parallel.

Pipeline parallelism (`Decoder.pipe`, parallel/pipeline.py): the rank owns
its stage's blocks. A call JAX pipelines (no taps, no cache, an int
q_offset, B and L dividing by the stages: `_maybe_pipelined_stack`) runs
`pipeline_scan` over microbatches (JAX's `n_micro` rule), each block
rematerialised as the plain loop's is; any other call runs the plain loop,
each foreign block gathered from its owner around its use. The LoRA
factors stay whole on every stage: the pipeline hands them to its stages
(`pipeline_scan(shared=)`), each stage's microbatches give the rows of its
own layers their gradient, and the stages' shares are summed over the pipe
group, so every stage ends with the whole gradient, as the plain loop
gives it (every stage runs every block there).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from visper_lm_tpu_torch.config import DecoderConfig
from visper_lm_tpu_torch.models.rope import apply_rope, apply_rope_transpose, rope_cos_sin
from visper_lm_tpu_torch.ops.attention import Offset, mha_plain_cache, multi_head_attention
from visper_lm_tpu_torch.ops.moe import ExpertBank, Router, moe_mlp
from visper_lm_tpu_torch.parallel.distributed import all_reduce, copy_to_group, reduce_from_group
from visper_lm_tpu_torch.parallel.tensor import (
    gather_vocab,
    quant_plan,
    set_tensor_parallel,
    slice_of_group,
    split_kind,
    vocab_embed,
)
from visper_lm_tpu_torch.utils.param import (
    QuantLinear,
    RMSNorm,
    apply_linear,
    quantize_linear_int4,
    quantize_linear_int8,
)

# the seven linears of a block, in JAX's param names
LINEAR_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
# a MoE block's router and expert banks (ops/moe.py), in JAX's param names
MOE_NAMES = ("moe_router", "moe_gate", "moe_up", "moe_down")
# the aux losses a MoE block returns, in this order (JAX `_AUX_KEYS`)
MOE_AUX_KEYS = ("lb_loss", "z_loss", "dropped_frac")


def block_linears(cfg: DecoderConfig) -> Tuple[str, ...]:
    """The dense linears of a block: all seven, or the four attention
    projections of a MoE block (its MLP is the router and the banks)."""
    return LINEAR_NAMES[:4] if cfg.moe_experts else LINEAR_NAMES


@dataclasses.dataclass
class KVCache:
    """Slot-major cache (L, S_max, B, Nkv, H), the JAX package's layout: one
    decode step writes one contiguous (B, Nkv, H) slab per layer."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[1]

    def layer(self, i: int) -> Tuple[torch.Tensor, ...]:
        return self.k[i], self.v[i]


@dataclasses.dataclass
class QuantKVCache:
    """int8 slot-major cache (L, S_max, B, Nkv, H) with one f32 scale per
    (layer, slot, batch, kv head) vector over H (JAX `QuantKVCache`)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor             # (L, S_max, B, Nkv) f32
    v_scale: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[1]

    def layer(self, i: int) -> Tuple[torch.Tensor, ...]:
        return self.k[i], self.v[i], self.k_scale[i], self.v_scale[i]


def init_kv_cache(
    cfg: DecoderConfig, batch: int, max_len: int, *, dtype: torch.dtype = torch.bfloat16,
    device: Union[str, torch.device], tp: int = 1,
) -> KVCache:
    """Zeros (L, S_max, B, Nkv / tp, H): a tensor-parallel rank's kv heads."""
    shape = (cfg.num_layers, max_len, batch, cfg.num_kv_heads // tp, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def init_quant_kv_cache(
    cfg: DecoderConfig, batch: int, max_len: int, *, device: Union[str, torch.device],
    tp: int = 1,
) -> QuantKVCache:
    """int8 values at 0 and scales at 1, as JAX `init_quant_kv_cache`."""
    shape = (cfg.num_layers, max_len, batch, cfg.num_kv_heads // tp, cfg.head_dim)
    return QuantKVCache(
        k=torch.zeros(shape, dtype=torch.int8, device=device),
        v=torch.zeros(shape, dtype=torch.int8, device=device),
        k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
        v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
    )


def write_cache_chunk(cache: torch.Tensor, new: torch.Tensor, q_offset: Offset) -> None:
    """Write a chunk `new` (T, B, ...) into one layer's slot-major cache
    (S, B, ...) in place at slots q_offset + arange(T), with no host sync.

    q_offset is a Python int or a 0-d tensor (one position for the whole
    batch: JAX's dynamic_update_slice), or a (B,) tensor (a position per
    sample: JAX's scatter with mode="drop"), where slots at or past S are
    dropped: nothing is written for them and nothing wraps around. A
    dropped row is sent to slot p - T < start, which this chunk does not
    write, and writes back the value it finds there."""
    t = new.shape[0]
    new = new.to(cache.dtype)
    if isinstance(q_offset, int):
        cache[q_offset:q_offset + t].copy_(new)
        return
    rows = torch.arange(t, device=cache.device)
    if q_offset.ndim == 0:
        cache.index_copy_(0, q_offset + rows, new)
        return
    s, b = cache.shape[0], cache.shape[1]
    pos = q_offset.to(cache.device)[None, :] + rows[:, None]          # (T, B)
    keep = pos < s
    dst = torch.where(keep, pos, pos - t)
    col = torch.arange(b, device=cache.device)[None, :].expand(t, b)
    keep = keep.reshape(t, b, *([1] * (new.ndim - 2)))
    cache.index_put_((dst, col), torch.where(keep, new, cache[dst, col]))


def quantize_head_vectors(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (..., H) vector: (int8, f32 scale (..., 1)), scale
    amax / 127 with floor 1e-6 (JAX `_quantize_head_vectors`)."""
    xf = x.float()
    # amax / 127 as amax * f32(1 / 127), the form XLA folds it into
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-6) * (1.0 / 127.0)
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


# JAX `_remat_policy`: the checkpoint names each policy keeps across a
# block's recompute. save_mlp_q8 keeps none: JAX's int8 cast passes no
# gradient, so gate/up reach the input only through the scale's amax, whose
# backward needs the unquantized product: JAX recomputes it, as the port does.
REMAT_POLICIES: Dict[str, FrozenSet[str]] = {
    "none": frozenset(),
    "save_flash": frozenset({"flash_out"}),
    "save_mlp": frozenset({"mlp_gate", "mlp_up"}),
    "save_qkv_mlp": frozenset({"mlp_gate", "mlp_up", "qkv"}),
    "save_gate": frozenset({"mlp_gate"}),
    "save_gate_flash": frozenset({"mlp_gate", "flash_out"}),
    "save_mlp_q8": frozenset(),
}


def remat_saves(policy: Optional[str]) -> FrozenSet[str]:
    """The names `policy` keeps (None is "none"); raises for an unknown name."""
    name = "none" if policy is None else policy
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}")
    return REMAT_POLICIES[name]


def quant_saved(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX `_quant_saved`: per-token symmetric int8 of a saved residual,
    (int8 values, f32 scale (..., 1)); scale amax / 127, or 1 where amax is 0."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # amax / 127 as amax * f32(1 / 127), the form XLA folds the division into
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def dequant_saved(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """JAX `_dequant_saved`: q x scale in f32, rounded to bf16 (its default)."""
    return (q.float() * scale).to(torch.bfloat16)


def silu_per_op(x: torch.Tensor) -> torch.Tensor:
    """silu as jax.nn.silu lowers it, x * (1 / (1 + exp(-x))), each op
    rounded to x's dtype: bit-equal to JAX's in bf16, where F.silu (one
    rounding) differs in the last bit of about 40 % of the values."""
    return x * (1 / (1 + torch.exp(-x)))


class _Stash:
    """The tensors one block call keeps across its recompute: the names of
    a remat policy, and their values, stored by the block's first run and
    read by its recompute."""

    def __init__(self, names: FrozenSet[str]):
        self.names = names
        self.values: Dict[str, object] = {}


class _ColumnSide(torch.autograd.Function):
    """The LoRA side path (x A) B_r of a column-parallel target under tensor
    parallelism: x the whole input (after `copy_to_group`), A whole, B_r the
    rank's columns of B. The backward's dx = (g B_r^T) A^T is the rank's
    share (the input's `copy_to_group` sums the shares), dB_r = (x A)^T g,
    and dA = x^T (g B^T) with g B^T = the ranks' g B_r^T all-reduced: whole
    and the same on every rank."""

    @staticmethod
    def forward(ctx, x, a, b, group):
        u = x @ a
        ctx.group = group
        ctx.save_for_backward(x, a, b, u)
        return u @ b

    @staticmethod
    def backward(ctx, g):
        x, a, b, u = ctx.saved_tensors
        return _column_side_grads(g, x, a, b, u, ctx.group) + (None,)


def _column_side_grads(g, x, a, b, u, group):
    """(dx's share, dA, dB_r) of `_ColumnSide` (u = x A, or None to recompute)."""
    gb = g @ b.T                                                   # (B, T, r): the rank's share
    x2 = x.reshape(-1, x.shape[-1])
    u2 = (x2 @ a) if u is None else u.reshape(-1, u.shape[-1])
    da = x2.T @ all_reduce(gb.reshape(-1, gb.shape[-1]).clone(), group)
    db = u2.T @ g.reshape(-1, g.shape[-1])
    return gb @ a.T, da, db


def lora_side(x: torch.Tensor, ab: Tuple[torch.Tensor, torch.Tensor], tp=None,
              kind: str = "column") -> torch.Tensor:
    """The LoRA side path (x A) B of one block linear, A (din, r) and B
    scaled (r, dout) in x's dtype (JAX `_lora_linear`). Under tensor
    parallelism the factors are whole on every rank: a column-parallel
    target takes the rank's columns of B (`_ColumnSide`), a row-parallel
    one the rank's rows of A, (x A) all-reduced, then B whole (so it joins
    after the linear's all-reduce)."""
    a, b = ab[0].to(x.dtype), ab[1].to(x.dtype)
    if tp is None:
        return (x @ a) @ b
    if kind == "column":
        return _ColumnSide.apply(x, a, slice_of_group(b, 1, tp), tp.group)
    return reduce_from_group(x @ slice_of_group(a, 0, tp), tp.group) @ b


def lora_linear(layer: nn.Module, x: torch.Tensor, ab: Optional[Tuple[torch.Tensor, torch.Tensor]],
                use_kernel: Optional[bool] = None, tp=None, kind: str = "column") -> torch.Tensor:
    """A block linear plus, with factors ab = (A (din, r), B scaled (r, dout)),
    the LoRA side path (x A) B (`lora_side`). Under tensor parallelism a
    row-parallel linear's output is all-reduced before the side path joins."""
    y = apply_linear(layer, x, use_kernel)
    if tp is not None and kind == "row":
        y = reduce_from_group(y, tp.group)
    if ab is None:
        return y
    return y + lora_side(x, ab, tp, kind)


class _StashedLinear(torch.autograd.Function):
    """y = x @ W.T (+ the LoRA side path (x A) B when a and b are given),
    split to heads by `shape` and rotated when cos/sin are given, whose value
    a remat policy keeps under `key`: the first run computes and stores it
    (the LoRA term included), the recompute returns it without the products.
    The backward is the vector-Jacobian product of rope and the linear:
    dx = g W (+ (g B^T) A^T), dW = g^T x when W trains, and with LoRA
    dA = x^T (g B^T), dB = (x A)^T g; under tensor parallelism (`tp`, the
    block's group) b is the rank's columns of B and dA is `_ColumnSide`'s."""

    @staticmethod
    def forward(ctx, x, weight, a, b, cos, sin, shape, stash, key, tp=None):
        y = stash.values.get(key)
        if y is None:
            y = F.linear(x, weight)
            if a is not None:
                y = y + (x @ a) @ b
            if shape is not None:
                y = y.reshape(shape)
            if cos is not None:
                y = apply_rope(y, cos, sin)
            stash.values[key] = y.detach()
        else:
            y = y.detach()
        needs_x = weight.requires_grad or a is not None
        ctx.tp = tp
        ctx.save_for_backward(x if needs_x else None, weight, a, b, cos, sin)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, a, b, cos, sin = ctx.saved_tensors
        if cos is not None:
            g = apply_rope_transpose(g, cos, sin)
        g = g.reshape(*g.shape[:2], -1)
        dx = g @ weight
        dw = da = db = None
        if ctx.needs_input_grad[1]:
            dw = g.reshape(-1, g.shape[-1]).T @ x.reshape(-1, x.shape[-1])
        if a is not None and ctx.tp is not None:
            dx_side, da, db = _column_side_grads(g, x, a, b, None, ctx.tp.group)
            dx = dx + dx_side
        elif a is not None:
            gb = g @ b.T                                           # (B, T, r)
            dx = dx + gb @ a.T
            x2 = x.reshape(-1, x.shape[-1])
            if ctx.needs_input_grad[2]:
                da = x2.T @ gb.reshape(-1, gb.shape[-1])
            if ctx.needs_input_grad[3]:
                db = (x2 @ a).T @ g.reshape(-1, g.shape[-1])
        return dx, dw, da, db, None, None, None, None, None, None


def _mean_square(x: torch.Tensor) -> torch.Tensor:
    """Per-channel mean square over (B, T) in f32: (D,)."""
    return x.float().square().mean(dim=(0, 1))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None, dtype=None, ep=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, bias=False)
        h, nh, nkv, hd, m = (
            cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.mlp_dim
        )
        self.cfg = cfg
        self.attn_norm = RMSNorm(h, cfg.norm_eps, device=device, dtype=dtype)
        self.q_proj = nn.Linear(h, nh * hd, **kw)
        self.k_proj = nn.Linear(h, nkv * hd, **kw)
        self.v_proj = nn.Linear(h, nkv * hd, **kw)
        self.o_proj = nn.Linear(nh * hd, h, **kw)
        self.mlp_norm = RMSNorm(h, cfg.norm_eps, device=device, dtype=dtype)
        # the expert-parallel group (parallel/distributed.AxisGroup): this rank's share of the experts
        self.ep = ep
        self.moe = cfg.moe_experts > 0
        if self.moe:
            e = cfg.moe_experts
            bank = dict(parts=1 if ep is None else ep.size, rank=0 if ep is None else ep.rank,
                        device=device, dtype=dtype)
            self.moe_router = Router(h, e, device=device)
            self.moe_gate = ExpertBank(e, h, m, **bank)
            self.moe_up = ExpertBank(e, h, m, **bank)
            self.moe_down = ExpertBank(e, m, h, **bank)
        else:
            self.gate_proj = nn.Linear(h, m, **kw)
            self.up_proj = nn.Linear(h, m, **kw)
            self.down_proj = nn.Linear(m, h, **kw)
        # set by parallel/tensor.shard_model: the block's tensor-parallel group
        self.tp = None

    def forward(
        self,
        h: torch.Tensor,                     # (B, T, D)
        cos: torch.Tensor,
        sin: torch.Tensor,
        *,
        kv_lengths: Optional[torch.Tensor],
        kv_starts: Optional[torch.Tensor],
        q_offset: Offset,
        cache_kv: Optional[Tuple[torch.Tensor, ...]],  # this layer's (S, B, Nkv, H) k, v [, scales]
        use_kernel: Optional[bool],
        stats_out: Optional[List[Dict[str, torch.Tensor]]] = None,
        stash: Optional[_Stash] = None,
        quant_saves: bool = False,
        lora: Optional[Mapping[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
        seq=None,
        moe_data=None,
    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """JAX `_block_forward`. With a cache, the chunk's K/V are written into
        the cache IN PLACE at slots [q_offset, q_offset + T) (per sample for a
        (B,) offset: `write_cache_chunk`), after attention, which saw them
        unquantized, as extras (decode) or as the whole sequence (prefill). A
        4-tuple cache_kv is int8 + scales: the chunk is
        stored quantized per (token, head) vector. stats_out, when given, gets
        the per-input-channel mean square at each linear's input (calibration).
        stash: the remat policy's kept tensors (see the module docstring);
        quant_saves: gate and up pass through `quant_saved` /
        `dequant_saved` (the save_mlp_q8 policy); lora: this layer's
        {target: (A (din, r), B scaled (r, dout))}; seq: the decoder's
        sequence-parallel group (h is the rank's rows); moe_data: the
        routing group a MoE block's routing spans (ops/moe.py).

        A MoE block returns (h, its aux losses (3,) f32 in `MOE_AUX_KEYS`
        order), a dense block h."""
        cfg = self.cfg
        b, t, _ = h.shape
        tp = self.tp
        split = 1 if tp is None else tp.size
        nh, nkv, hd = cfg.num_heads // split, cfg.num_kv_heads // split, cfg.head_dim
        keeps = stash.names if stash is not None else frozenset()

        def record(**sites):
            if stats_out is not None:
                stats_out.append({k: _mean_square(v) for k, v in sites.items()})

        def side(name):
            return None if lora is None else lora.get(name)

        def kept(name, key, x, shape=None, rope=False):
            layer = getattr(self, name)
            ab = side(name)
            if key.split(".")[0] in keeps:
                a, b_ = (None, None) if ab is None else (ab[0].to(x.dtype), ab[1].to(x.dtype))
                if b_ is not None and tp is not None:
                    b_ = slice_of_group(b_, 1, tp)
                return _StashedLinear.apply(
                    x, layer.weight, a, b_, cos if rope else None, sin if rope else None,
                    shape, stash, key, tp,
                )
            y = lora_linear(layer, x, ab, use_kernel, tp)
            y = y if shape is None else y.reshape(shape)
            return apply_rope(y, cos, sin) if rope else y

        x = self.attn_norm(h)
        if tp is not None:
            x = copy_to_group(x, tp.group)
        record(q_proj=x, k_proj=x, v_proj=x)
        q = kept("q_proj", "qkv.q", x, (b, t, nh, hd), rope=True)
        k = kept("k_proj", "qkv.k", x, (b, t, nkv, hd), rope=True)
        v = kept("v_proj", "qkv.v", x, (b, t, nkv, hd))

        quant = cache_kv is not None and len(cache_kv) == 4
        # only a Python int 0 with T > 1 is a prefill over an empty cache (JAX's
        # routing): a tensor offset, even 0, takes the cache route
        prefill = isinstance(q_offset, int) and q_offset == 0 and t > 1
        if cache_kv is not None and not prefill:
            attn = mha_plain_cache(
                q, cache_kv[0], cache_kv[1],
                k_scale=cache_kv[2] if quant else None, v_scale=cache_kv[3] if quant else None,
                extra_k=k, extra_v=v, cache_len=q_offset, kv_starts=kv_starts,
            )
        else:
            # prefill (empty cache) or cacheless: attention over the chunk itself,
            # eligible for the flash kernel incl. the left-pad kv_starts mask
            attn = multi_head_attention(
                q, k, v, causal=True, q_offset=q_offset, kv_lengths=kv_lengths,
                kv_starts=kv_starts, use_kernel=use_kernel,
                saved=stash.values.setdefault("flash_out", []) if "flash_out" in keeps else None,
                seq=seq,
            )
        if cache_kv is not None:
            kt, vt = k.transpose(0, 1), v.transpose(0, 1)     # slot-major (T, B, Nkv, H)
            if quant:
                for new, values, scales in ((kt, cache_kv[0], cache_kv[2]),
                                            (vt, cache_kv[1], cache_kv[3])):
                    qv, sc = quantize_head_vectors(new)
                    write_cache_chunk(values, qv, q_offset)
                    write_cache_chunk(scales, sc[..., 0], q_offset)
            else:
                write_cache_chunk(cache_kv[0], kt, q_offset)
                write_cache_chunk(cache_kv[1], vt, q_offset)

        attn = attn.reshape(b, t, nh * hd)
        record(o_proj=attn)
        h = h + lora_linear(self.o_proj, attn, side("o_proj"), use_kernel, tp, "row")
        x = self.mlp_norm(h)
        if self.moe:
            # every tp rank runs the whole MoE MLP on the full hidden state:
            # its banks are replicated over the group, so is dx
            mlp_out, aux = moe_mlp(
                {"router": self.moe_router.weight.t(), "gate": self.moe_gate.kernel,
                 "up": self.moe_up.kernel, "down": self.moe_down.kernel},
                x, top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
                ep=self.ep, data=moe_data,
            )
            return h + mlp_out, torch.stack([aux[k].float() for k in MOE_AUX_KEYS])
        if tp is not None:
            x = copy_to_group(x, tp.group)
        record(gate_proj=x, up_proj=x)
        gate_pre = kept("gate_proj", "mlp_gate", x)
        up = kept("up_proj", "mlp_up", x)
        if quant_saves:
            # fwd and bwd both see the dequantized bf16 values, as in JAX
            gate_pre = dequant_saved(*quant_saved(gate_pre))
            up = dequant_saved(*quant_saved(up))
            # the product in down_proj's dtype: JAX's dot promotes the bf16
            # product to an f32 kernel's dtype, and XLA folds the rounding
            # between them away (a bf16 x bf16 product is exact in f32)
            wdt = self.down_proj.weight.dtype
            gu = silu_per_op(gate_pre).to(wdt) * up.to(wdt)
        else:
            gu = F.silu(gate_pre) * up
        record(down_proj=gu)
        return h + lora_linear(self.down_proj, gu, side("down_proj"), use_kernel, tp, "row")


class Decoder(nn.Module):
    """Token embedding, blocks, final norm and lm head (JAX `init_decoder` params)."""

    def __init__(self, cfg: DecoderConfig, device=None, dtype=None, ep=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.blocks = nn.ModuleList(DecoderBlock(cfg, **kw, ep=ep) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, **kw)
        self.lm_head = (
            None if cfg.tie_embeddings
            else nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **kw)
        )
        # set by GradStream: the blocks' gradients leave for the host per segment
        self.grad_stream: Optional["GradStream"] = None
        # set by a ZeRO-3 step (parallel/sharding.ShardedParams): each block's
        # parameters are gathered around its forward and its backward
        self.zero3 = None
        # set by parallel/tensor.shard_model: the tensor-parallel group, and
        # the 'model' placement of each split parameter and quantized buffer
        # (by name in the decoder)
        self.tp = None
        self.tp_plan: Dict[str, Any] = {}
        self.tp_buffers: Dict[str, Any] = {}
        # the sequence-parallel group (parallel/sequence.SequenceParallel):
        # inputs_embeds are the rank's rows
        self.seq = None
        # set by parallel/pipeline.shard_pipeline: the rank's pipeline stage
        self.pipe = None
        # a MoE decoder's expert-parallel group (parallel/distributed.AxisGroup;
        # fixed at construction: the banks hold the rank's experts)
        self.ep = ep

    @property
    def tp_size(self) -> int:
        """The tensor-parallel group's size (1 without one): a cache of this
        decoder holds num_kv_heads / tp_size kv heads."""
        return 1 if self.tp is None else self.tp.size

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        """The token embeddings of `ids` (vocab-parallel under tp)."""
        if self.tp is not None:
            return vocab_embed(self.embed_tokens.weight, ids, self.tp)
        return F.embedding(ids, self.embed_tokens.weight)

    def logits(self, hidden: torch.Tensor, use_kernel: Optional[bool] = None,
               gather: bool = True) -> torch.Tensor:
        """Output projection in the model dtype (a quantized lm_head goes
        through its QuantLinear), returned as f32. Under tp the rank's block
        of the vocabulary, gathered into the whole (collective) unless
        gather=False (the loss reads the block: train/losses.py)."""
        tp = self.tp
        if tp is not None:
            hidden = copy_to_group(hidden, tp.group)
        if self.lm_head is None:
            out = (hidden @ self.embed_tokens.weight.T).float()
        else:
            out = apply_linear(self.lm_head, hidden, use_kernel).float()
        if tp is not None and gather:
            return gather_vocab(out, tp)
        return out

    def forward(
        self,
        inputs_embeds: torch.Tensor,                  # (B, T, D)
        *,
        positions: Optional[torch.Tensor] = None,     # (B, T) or (T,); default arange
        kv_lengths: Optional[torch.Tensor] = None,    # (B,) valid kv length incl. this chunk
        kv_starts: Optional[torch.Tensor] = None,     # (B,) first valid kv slot (left pad)
        cache: Optional[Union[KVCache, QuantKVCache]] = None,
        q_offset: Offset = 0,
        use_kernel: Optional[bool] = None,
        compute_logits: bool = True,
        tap_layers: Tuple[int, ...] = (),            # 0-indexed block outputs to keep
        remat: bool = False,
        remat_policy: Optional[str] = None,
        lora: Optional[Mapping[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
        moe_data=None,
    ) -> Dict[str, object]:
        """JAX `decoder_forward`: {'hidden' (final-normed), 'logits' (f32, when
        compute_logits), 'taps' (tuple of the raw block outputs at tap_layers,
        before the final norm), 'cache' (the same cache object, updated in
        place, when one was passed), 'moe_aux' (a MoE decoder's
        {lb_loss, z_loss, dropped_frac}, each the mean over the layers; None
        for a dense one)}. remat: each block is checkpointed while
        autograd records, keeping what `remat_policy` names (`REMAT_POLICIES`).
        lora: {target: (A (L, din, r), B scaled (L, r, dout))}, the side path
        of every targeted linear (models/lora.py `lora_side_factors`; whole
        under tp, `lora_side`, and under pp). moe_data (a
        parallel/distributed.AxisGroup over the data x seq ranks,
        `routing_group`, or None): the group a MoE block's routing spans,
        so that capacity, priority and the aux are the global batch's (the
        train step's loss under data or sequence parallelism); None routes
        over this call's tokens (under sp a MoE decoder raises without it).

        q_offset is the chunk's first slot: a Python int, a 0-d tensor (one
        position for the whole batch) or a (B,) tensor (a position per
        sample; the serving engine's slots). Only an int 0 with T > 1 runs
        attention over the chunk itself (the flash kernel on CUDA); with a
        cache every other offset, a tensor 0 included, attends through
        `mha_plain_cache`, as JAX routes a traced offset. Tensor offsets stay
        on the device: nothing here reads them on the host."""
        cfg = self.cfg
        saves = remat_saves(remat_policy) if remat else None
        quant_saves = remat and remat_policy == "save_mlp_q8"
        if remat and cache is not None:
            raise ValueError("remat is a training feature (no cache)")
        t = inputs_embeds.shape[1]
        stream = self.grad_stream
        if stream is not None and stream.armed:
            stream.check_forward(tap_layers, cache)
        if tap_layers:
            if max(tap_layers) >= cfg.num_layers:
                raise ValueError(f"tap layers {tap_layers} out of range for {cfg.num_layers} layers")
            if cache is not None:
                raise ValueError("layer taps are a training/prefill feature (no cache)")
        seq, pipe = self.seq, self.pipe
        moe = cfg.moe_experts > 0
        if moe and seq is not None and (moe_data is None or moe_data.inner != seq.size):
            raise ValueError("a MoE decoder under sequence parallelism routes over the data x seq "
                             "group: pass moe_data=distributed.routing_group(mesh) (a rank's rows "
                             "alone would give the slice's capacity and priority)")
        if seq is not None and cache is not None:
            raise ValueError("a cache under sequence parallelism: serving runs whole sequences "
                             "on each rank, not the rank's rows")
        if positions is None:
            rows = (torch.arange(t, device=inputs_embeds.device) if seq is None
                    else seq.positions(t, inputs_embeds.device))
            positions = rows + (q_offset if isinstance(q_offset, int) else q_offset.reshape(-1, 1))
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        if cos.ndim == 2:
            cos, sin = cos[None], sin[None]
        zero3 = self.zero3

        def run(i: int, h: torch.Tensor, kv_lengths, kv_starts, cos, sin, cache_kv=None,
                factors=lora):
            """Block i, its parameters whole around it: ZeRO-3's gathered
            first, then (a plain loop under a pipeline) a foreign block's
            from its owner; the backward gathers them in the same order.
            factors: the LoRA factors stacked over the layers (layer i's
            taken)."""
            block = self.blocks[i]
            kw = dict(kv_lengths=kv_lengths, kv_starts=kv_starts, q_offset=q_offset,
                      cache_kv=cache_kv, use_kernel=use_kernel, quant_saves=quant_saves,
                      lora=None if factors is None else {n: (a[i], b[i])
                                                         for n, (a, b) in factors.items()},
                      seq=seq, moe_data=moe_data)
            gathers = [g for g in (zero3, None if pipelined else pipe) if g is not None]
            for g in gathers:
                h = g.enter(i, h)
            if remat and torch.is_grad_enabled():
                h = checkpoint(block, h, cos, sin, stash=_Stash(saves), **kw,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                h = block(h, cos, sin, **kw)
            if moe:
                h, aux = h
                aux_sum.append(aux)
            for g in reversed(gathers):
                h = g.leave(i, h)
            return h

        h = inputs_embeds
        taps = {}
        aux_sum: List[torch.Tensor] = []
        b = inputs_embeds.shape[0]
        # JAX `_maybe_pipelined_stack`'s predicate (a MoE stack takes the plain loop)
        pipelined = (pipe is not None and pipe.size > 1 and not tap_layers and cache is None
                     and not moe and cfg.num_layers % pipe.size == 0 and b % pipe.size == 0
                     and isinstance(q_offset, int))
        if pipelined:
            from visper_lm_tpu_torch.parallel.pipeline import n_micro_for, pipeline_scan

            # the LoRA factors enter the schedule whole: each stage's
            # microbatches reach them as leaves of their own graphs, and the
            # stages' gradients (rows of their own layers) are summed
            shared = {} if lora is None else {
                f"{n}.{k}": t for n, ab in lora.items() for k, t in zip("ab", ab)}

            def pipe_block(i, hh, a):
                factors = None if lora is None else {n: (a[f"{n}.a"], a[f"{n}.b"]) for n in lora}
                return run(i, hh, a["kv_lengths"], a["kv_starts"], a["cos"], a["sin"],
                           factors=factors)

            params = [p for i in pipe.layers for p in self.blocks[i].parameters()
                      if p.requires_grad]
            m = n_micro_for(b, pipe.size)
            if stream is not None and stream.armed:
                stream.expect(m)
            h = pipeline_scan(pipe_block, list(range(cfg.num_layers)), h,
                              dict(cos=cos, sin=sin, kv_lengths=kv_lengths, kv_starts=kv_starts),
                              group=pipe.group, n_micro=m, params=params, shared=shared)
        else:
            for i in range(cfg.num_layers):
                h = run(i, h, kv_lengths, kv_starts, cos, sin,
                        None if cache is None else cache.layer(i))
                if i in tap_layers:
                    taps[i] = h
        hidden = self.final_norm(h)
        out: Dict[str, object] = {
            "hidden": hidden, "cache": cache, "taps": tuple(taps[i] for i in tap_layers),
            "moe_aux": None,
        }
        if moe:
            # JAX's per-layer mean (f32 sums in layer order), so the loss
            # weight is depth-independent
            total = sum(aux_sum[1:], aux_sum[0])
            out["moe_aux"] = dict(zip(MOE_AUX_KEYS, (total / cfg.num_layers).unbind(0)))
        if compute_logits:
            out["logits"] = self.logits(hidden, use_kernel)
        return out


def init_decoder(cfg: DecoderConfig, *, device=None, seed: int = 0) -> Decoder:
    """JAX `init_decoder`: a bare decoder (what beam search and speculative
    decoding take) with seeded random weights made on `device` (CUDA when
    None) by a torch.Generator, in the config's dtype: the JAX
    distributions, not its numbers."""
    from visper_lm_tpu_torch.device import resolve_device
    from visper_lm_tpu_torch.utils.param import init_weights_, torch_dtype

    device = resolve_device(device)
    with torch.device("meta"):
        decoder = Decoder(cfg, dtype=torch_dtype(cfg.dtype))
    decoder = decoder.to_empty(device=device)
    init_weights_(decoder, torch.Generator(device=device).manual_seed(seed))
    return decoder.eval()


# ---------------------------------------------------------------------------
# Gradient streaming (JAX's blocks_chunks layout and host_grad_segment)
# ---------------------------------------------------------------------------


def stream_chunk_ranges(
    num_layers: int, n_chunks: int, tap_layers: Sequence[int] = ()
) -> Tuple[Tuple[int, int], ...]:
    """Layer ranges of the gradient-streaming segments: the uniform n_chunks
    grid unioned with the tap boundaries, so every tapped block output ends
    a segment (JAX `stream_chunk_ranges`)."""
    n_chunks = max(1, min(n_chunks, num_layers))
    ends = {(i + 1) * num_layers // n_chunks for i in range(n_chunks)} | {l + 1 for l in tap_layers}
    ends = sorted(e for e in ends if 0 < e <= num_layers)
    return tuple(zip([0] + ends[:-1], ends))


def stage_chunk_ranges(ranges: Sequence[Tuple[int, int]], pipe) -> Tuple[Tuple[int, int], ...]:
    """The segments of `ranges` that pipeline stage `pipe` streams: each
    cut at the stages' bounds, those inside the stage's layers kept, so no
    segment spans two stages (ROADMAP C31; JAX runs the streamed layout
    unpipelined). Without a pipeline, `ranges` as they are."""
    if pipe is None:
        return tuple(ranges)
    ends = sorted({e for _, e in ranges} | set(pipe.bounds[1:]))
    lo, hi = pipe.layers.start, pipe.layers.stop
    return tuple((s, e) for s, e in zip([0] + ends[:-1], ends) if lo <= s and e <= hi)


def chunk_blocks_at(blocks: Mapping[str, Any], ranges: Sequence[Tuple[int, int]]) -> Tuple[Any, ...]:
    """A JAX stacked blocks tree (numpy leaves (L, ...)) cut into the layer
    ranges' sub-stacks (JAX `chunk_blocks_at`)."""

    def cut(node, s, e):
        if isinstance(node, Mapping):
            return {k: cut(v, s, e) for k, v in node.items()}
        return node[s:e]

    return tuple(cut(blocks, s, e) for s, e in ranges)


def unchunk_blocks(chunks: Sequence[Any]) -> Any:
    """The sub-stacks concatenated back into one stacked tree (JAX `unchunk_blocks`)."""
    first = chunks[0]
    if isinstance(first, Mapping):
        return {k: unchunk_blocks([c[k] for c in chunks]) for k in first}
    return np.concatenate([np.asarray(c) for c in chunks], axis=0)


_CHUNK_KEY = re.compile(r"^(.*?decoder\.)blocks_chunks\.(\d+)\.(\d+)\.(.*)$")


def normalize_stream_layout(params: Any) -> Any:
    """Undo the gradient-streaming layout at an export or serving boundary
    (JAX `normalize_stream_layout`): a JAX tree whose decoder holds
    `blocks_chunks` {"0": sub-stack, ...} gets its stacked `blocks` back; a
    state dict with keys `...decoder.blocks_chunks.<c>.<j>.<rest>` gets
    `...decoder.blocks.<layer>.<rest>`, the layer counted over the chunks in
    order. Anything else is returned as it is."""
    if not isinstance(params, Mapping):
        return params
    dec = params.get("decoder")
    if isinstance(dec, Mapping) and "blocks_chunks" in dec:
        dec = dict(dec)
        chunks = dec.pop("blocks_chunks")
        subs = [chunks[k] for k in sorted(chunks, key=int)] if isinstance(chunks, Mapping) else list(chunks)
        dec["blocks"] = unchunk_blocks(subs)
        out = dict(params)
        out["decoder"] = dec
        return out
    found = {k: _CHUNK_KEY.match(k) for k in params}
    if not any(found.values()):
        return params
    sizes: Dict[Tuple[str, int], int] = {}
    for m in filter(None, found.values()):
        key = (m.group(1), int(m.group(2)))
        sizes[key] = max(sizes.get(key, 0), int(m.group(3)) + 1)
    starts, total = {}, {}
    for prefix, c in sorted(sizes):
        starts[(prefix, c)] = total.get(prefix, 0)
        total[prefix] = starts[(prefix, c)] + sizes[(prefix, c)]
    out = {}
    for k, v in params.items():
        m = found[k]
        if m is None:
            out[k] = v
        else:
            layer = starts[(m.group(1), int(m.group(2)))] + int(m.group(3))
            out[f"{m.group(1)}blocks.{layer}.{m.group(4)}"] = v
    return out


class GradStream:
    """JAX `host_grad_segment` for the port's one-layout decoder: a VLM's
    decoder blocks are cut into segments (`ranges`, from `stream_chunk_ranges`), and while
    the stream is `armed` each segment's weight gradients leave the card as
    soon as the backward has produced the last of them.

    A post-accumulate-grad hook on every trainable block parameter counts the
    segment down; at zero the segment's gradients are summed for the global
    norm on the card (`leaf_sumsq`, so the norm pass never brings them back)
    and copied on a side stream into page-locked host buffers, each
    `.grad` is freed (its memory returns to the allocator once the copy is
    done) and the step's stream waits for the PREVIOUS segment's copies
    first: at most two segments' gradients are on the card at once, the
    counterpart of JAX's optimization_barrier tie. On the CPU the host
    buffers are the gradients themselves (JAX's host put is a no-op off the
    TPU). `collect()` ends a backward: it waits for the copies and returns
    {name: host gradient} and {name: (sum of squares, dtype)}.

    In a process group (`zero`: the step's parallel/sharding.ZeroPlan) each
    gradient is first summed over the data group onto the rank's ZeRO
    slice (`scatter_grad`, a collective in the hook: every rank runs the
    same backward), and only that slice leaves for the host; a leaf split
    over the data or the model axis reports its slice's f32 sum of squares
    (the optimizer adds the slices' over the ranks). JAX keeps GSPMD's
    partitioning on the host transfer. Under sequence parallelism (the
    plan's `seq`) the seq group's sum comes first, as `AdamW.reduce_grads`
    takes it for the gradients it reduces.

    Under pipeline parallelism (`Decoder.pipe`) the ranges are the stage's
    (`stage_chunk_ranges`) and cover its blocks only. A pipelined forward
    runs each block once per microbatch, and each microbatch's backward
    accumulates into `.grad`: the decoder tells the stream how many
    (`expect`), and a segment leaves once the last microbatch's backward
    has passed it."""

    def __init__(self, model: nn.Module, ranges: Sequence[Tuple[int, int]], device: torch.device,
                 zero=None):
        from visper_lm_tpu_torch.device import HostPool

        decoder = model.decoder
        pipe = decoder.pipe
        layers = range(decoder.cfg.num_layers) if pipe is None else pipe.layers
        if (not ranges or ranges[0][0] != layers.start or ranges[-1][1] != layers.stop
                or any(b != a for (_, a), (b, _) in zip(ranges, ranges[1:]))):
            raise ValueError(f"stream ranges {tuple(ranges)} do not cover the layers "
                             f"[{layers.start}, {layers.stop}) of the decoder"
                             + ("" if pipe is None else f"'s pipeline stage {pipe.rank}"))
        self.decoder, self.ranges, self.device = decoder, tuple(ranges), torch.device(device)
        self.zero = zero
        self.segments: List[List[Tuple[str, nn.Parameter]]] = []
        for s, e in self.ranges:
            self.segments.append([
                (f"decoder.blocks.{i}.{n}", p)
                for i in range(s, e) for n, p in decoder.blocks[i].named_parameters()
                if p.requires_grad
            ])
        self._segment_of = {id(p): k for k, seg in enumerate(self.segments) for _, p in seg}
        self.pool = None
        self.host: Dict[str, torch.Tensor] = {}
        if self.device.type == "cuda":
            shapes = {n: (self._slice_shape(n, p), p.dtype) for seg in self.segments for n, p in seg}
            self.pool = HostPool(sum(HostPool.size_of(*s) for s in shapes.values()), self.device)
            self.host = {n: self.pool.take(*s) for n, s in shapes.items()}
            self.side = torch.cuda.Stream(self.device)
        self._hooks = [p.register_post_accumulate_grad_hook(self._ready)
                       for seg in self.segments for _, p in seg]
        self.armed = False
        decoder.grad_stream = self

    def _slice_shape(self, n: str, p: torch.Tensor) -> Tuple[int, ...]:
        """The shape of what leaves for the host: the rank's ZeRO slice."""
        if self.zero is None:
            return tuple(p.shape)
        return self.zero.moments[n].local_shape(p.shape, self.zero.rank)

    @property
    def host_bytes(self) -> int:
        return 0 if self.pool is None else self.pool.nbytes

    def check_forward(self, tap_layers: Sequence[int], cache) -> None:
        """JAX's asserts on the streamed layout: training only, every tap (of
        the stream's layers) a segment end."""
        if cache is not None or self.decoder.cfg.moe_experts:
            raise ValueError("blocks_chunks is a training-only layout (no cache/MoE)")
        ends = {e - 1 for _, e in self.ranges}
        lo, hi = self.ranges[0][0], self.ranges[-1][1]
        missing = [l for l in sorted(set(tap_layers)) if lo <= l < hi and l not in ends]
        if missing:
            raise ValueError(
                f"tap layers {missing} do not land on chunk boundaries — build the layout "
                "with stream_chunk_ranges(num_layers, n_chunks, tap_layers)")

    def arm(self) -> None:
        """Start a streamed forward and backward."""
        self.expect(1)
        self._shipped = [False] * len(self.segments)
        self._last = None
        self.grads: Dict[str, torch.Tensor] = {}
        self.sumsq: Dict[str, torch.Tensor] = {}
        self.armed = True

    def expect(self, uses: int) -> None:
        """The armed forward runs each block `uses` times (a pipeline's
        microbatches): a segment leaves after its parameters' last
        accumulation."""
        self._pending = [len(seg) * uses for seg in self.segments]

    def _ready(self, p: torch.Tensor) -> None:
        if not self.armed:
            return
        k = self._segment_of[id(p)]
        self._pending[k] -= 1
        if self._pending[k] == 0:
            self._ship(k)

    def _ship(self, k: int) -> None:
        from visper_lm_tpu_torch.train.optimizer import leaf_sumsq

        seg = self.segments[k]
        grads = [(n, p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in seg]
        if self.zero is not None:
            from visper_lm_tpu_torch.parallel.sharding import scatter_grad

            z = self.zero
            if z.seq is not None:
                # each seq rank's gradient is its rows' share
                grads = [(n, all_reduce(g.contiguous(), z.seq.group)) for n, g in grads]
            grads = [(n, scatter_grad(z.moments[n], g.contiguous(), z.group, z.rank))
                     for n, g in grads]
        for n, g in grads:
            pl = None if self.zero is None else self.zero.moments[n]
            if pl is not None and (pl.sharded or pl.model_sharded):
                self.sumsq[n] = torch.linalg.vector_norm(g, dtype=torch.float32).square()
            else:
                self.sumsq[n] = leaf_sumsq(g)
        if self.device.type != "cuda":
            self.grads.update(grads)
        else:
            compute = torch.cuda.current_stream(self.device)
            if self._last is not None:
                compute.wait_event(self._last)       # the previous segment's copies first
            self.side.wait_stream(compute)
            with torch.cuda.stream(self.side):
                for n, g in grads:
                    self.host[n].copy_(g, non_blocking=True)
                    g.record_stream(self.side)
                self._last = torch.cuda.Event()
                self._last.record(self.side)
            self.grads.update((n, self.host[n]) for n, _ in grads)
        for _, p in seg:
            p.grad = None
        self._shipped[k] = True

    def collect(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """End the backward: ship what is left (a parameter the loss did not
        reach gets zeros), make the step's stream wait for every copy, disarm.
        Returns (grads, sums)."""
        for k in range(len(self.segments)):
            if not self._shipped[k]:
                self._ship(k)
        if self._last is not None:
            torch.cuda.current_stream(self.device).wait_event(self._last)
        self.armed = False
        return self.grads, self.sumsq

    def close(self) -> None:
        """Remove the hooks and release the host buffers."""
        for h in self._hooks:
            h.remove()
        self._hooks = []
        if self.decoder.grad_stream is self:
            self.decoder.grad_stream = None
        self.host, self.pool = {}, None


def _quantized(linear: nn.Linear, mode: str, rms: Optional[torch.Tensor], tp=None) -> nn.Module:
    """The QuantLinear of `linear` (tp: its weight is the rank's rows of a
    row-parallel weight, whose statistics span the group)."""
    w = linear.weight.detach().T                     # input-major (din, dout)
    if mode == "int8":
        return QuantLinear(**quantize_linear_int8(w, tp))
    buffers = quantize_linear_int4(w, act_rms=rms, tp=tp)
    return linear if buffers is None else QuantLinear(**buffers)


@torch.no_grad()
def quantize_decoder(
    decoder: Decoder,
    mode: str,
    act_rms: Optional[Mapping[str, object]] = None,
) -> Decoder:
    """A NEW decoder for serving whose block linears (and lm_head when
    untied) are `QuantLinear`s, a MoE block's router and expert banks shared
    dense (JAX leaves every `moe_*` leaf raw): mode "int8" (w8a16, JAX
    `quantize_linear_weights`) or "int4" (w4a16, JAX
    `quantize_linear_weights_int4` at its defaults, group 128; a layer whose
    din no group size divides stays dense). act_rms: AWQ calibration for
    "int4", {proj name: (L, din), "lm_head": (din,)} from
    serve/calibrate.decoder_act_rms (tensors or arrays); an entry of another
    shape is ignored, as in JAX.

    Under tensor parallelism (a decoder `shard_model` cut) each rank
    quantizes its slices into the slices of the one-device quantized
    decoder: a row-parallel linear's statistics over din are all-reduced
    over the group (collective), its int4 groups must split evenly over
    the ranks (ROADMAP C28), and its act_rms is the rank's input channels
    (`decoder_act_rms` on the tp decoder) or the whole decoder's (sliced here).

    The embedding and the norms are the caller's modules, shared; the
    caller's decoder is left as it was (JAX quantizes a copy of the tree)."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown weight quantization {mode!r}")
    tp = decoder.tp
    split = 1 if tp is None else tp.size
    cfg = decoder.cfg
    device = decoder.embed_tokens.weight.device
    rms = {}
    if mode == "int4" and act_rms:
        rms = {k: v.to(device) if torch.is_tensor(v) else torch.tensor(v, device=device)
               for k, v in act_rms.items()}
    with torch.device("meta"):
        out = Decoder(cfg, ep=decoder.ep)
    out.embed_tokens = decoder.embed_tokens
    out.final_norm = decoder.final_norm
    for i, (src, dst) in enumerate(zip(decoder.blocks, out.blocks)):
        dst.attn_norm, dst.mlp_norm = src.attn_norm, src.mlp_norm
        for name in MOE_NAMES if src.moe else ():
            setattr(dst, name, getattr(src, name))
        for name in block_linears(cfg):
            lin = getattr(src, name)
            row = tp is not None and split_kind(name) == "row"
            r = rms.get(name)
            if row and r is not None and tuple(r.shape) == (cfg.num_layers, lin.in_features * split):
                r = r.narrow(1, tp.rank * lin.in_features, lin.in_features)
            r = r[i] if r is not None and tuple(r.shape) == (cfg.num_layers, lin.in_features) else None
            setattr(dst, name, _quantized(lin, mode, r, tp if row else None))
    if decoder.lm_head is not None:
        out.lm_head = _quantized(decoder.lm_head, mode, rms.get("lm_head"))
    if tp is not None:
        dense = dict(out.named_parameters())
        set_tensor_parallel(out, tp, {n: pl for n, pl in decoder.tp_plan.items() if n in dense},
                            quant_plan(out, split))
    return out.eval()
