"""Tensor parallelism: Megatron's column/row-parallel decoder blocks and the
vocab-parallel embedding and cross-entropy (no JAX twin file: GSPMD derives
all of it from `_PARAM_RULES`, parallel/sharding.py, and inserts every
all-reduce itself; the port runs one process per device and writes them).

A `TensorParallel` is one rank's tensor-parallel group (the ranks of one
data coordinate: `distributed.model_group`). `shard_model` turns a whole
`VLM` (or a bare `Decoder`) into that rank's local form, by the 'model'
placements of `sharding.tp_placements` (JAX's rules):

  * q/k/v/gate/up (column-parallel): the rank's rows of nn.Linear's weight,
    heads [r nh/tp, (r+1) nh/tp) and kv heads [r nkv/tp, ...) in contiguous
    blocks (GQA's query-to-kv map survives when nkv % tp == 0), mlp_dim/tp
    columns of the MLP;
  * o/down (row-parallel): the matching columns of their input dim;
  * embed_tokens: rows [r V/tp, (r+1) V/tp) of the vocab; lm_head its rows;
  * every other parameter (norms, tower, projector, heads, task tokens, a
    MoE block's router and expert banks) replicated, and its gradient the
    same on every rank of the group.

Call it on a model built on the meta device or on the host, before the
rank's share moves to its device: a rank never holds the whole decoder on
the card (`vlm.init_vlm(..., tp=)`, `weights.from_jax_params(..., tp=)`
build so; `train/cli.py`'s --init-from overlays host tensors' slices).

The blocks then run nh/tp heads and mlp_dim/tp columns: the input of each
column-parallel group goes through `copy_to_group` (identity forward, dX
all-reduced backward) and the outputs of o_proj and down_proj through
`reduce_from_group` (all-reduce forward, identity backward), so remat's
recompute issues the same collectives in the same order on every rank and
a kept linear output is the rank's local columns. The lookup (`vocab_embed`)
zeroes the ids outside the rank's rows and all-reduces, which is exact. The
loss reads the rank's (B, T, V/tp) logits through `vocab_parallel_nll`
(Megatron's cross-entropy: the max, then the sum of exp and the target's
logit all-reduced; never the (B, T, V) logits); every other reader of
logits gets the full vocabulary (`gather_vocab`), so sampling and greedy
decoding run unchanged, identically on every rank.

Quantized serving weights (`QuantLinear`, utils/param.py) are cut as their
linear's weight is (`QUANT_DIMS`): a column-parallel target's buffers by
dout, a row-parallel target's by din (packed int4 rows din/2, int4 groups
G), its int8 `out_scale` whole. `quantize_decoder` quantizes the rank's
slice: a row-parallel target's statistics over din (int8's max, AWQ's
geometric mean) are all-reduced, so each rank's buffers are the slice of
the one-device quantized tree. An int4 group may not straddle two ranks
(din / tp a multiple of the group size, else a ValueError: ROADMAP C28).

The LoRA factors stay replicated, as JAX's rules leave them (no rule names
`lora/`): a column-parallel target's side path runs (x A) and the rank's
columns of B, a row-parallel target's the rank's rows of A, the partial
(x A) all-reduced, then B. Each slice is `slice_of_group`'s, whose backward
gathers the slices' gradients, and a column target's dA sees the (x A)
gradient all-reduced (models/decoder.py), so every factor's gradient is
whole and the same on every rank of the group, like a norm's.

Serving (the Generator, the Engine, speculative and beam decoding, chat)
runs the one-device programs on the rank's form: caches of nkv/tp heads,
logits gathered before every sampling or selection, so every rank of the
group runs the same host schedule and draws the same tokens.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from visper_lm_tpu_torch.parallel import distributed
from visper_lm_tpu_torch.parallel.sharding import Placement, tp_placements

# the block linears by their 'model' split (`_PARAM_RULES`): the output
# dim (column-parallel; lm_head too) or the input dim (row-parallel)
ROW_PARALLEL = ("o_proj", "down_proj")

# {split kind: {QuantLinear buffer: the dim split over 'model', None whole}}:
# buffers are input-major (din, dout) (packed int4 rows (din/2, dout),
# groups (G, dout), the AWQ input scale (din,))
QUANT_DIMS = {
    "column": {"weight_q8": 1, "out_scale": 0, "weight_q4p": 1, "q4_scale": 1,
               "q4_in_scale": None},
    "row": {"weight_q8": 0, "out_scale": None, "weight_q4p": 0, "q4_scale": 0,
            "q4_in_scale": 0},
}


# one rank's tensor-parallel group: the process group, the rank's index in
# it (its model coordinate) and its size
TensorParallel = distributed.AxisGroup


def tensor_parallel(mesh) -> Optional[TensorParallel]:
    """This process's `TensorParallel` on the mesh's model axis (collective:
    every process makes every group), None when the axis is 1 wide."""
    if mesh is None or mesh.model_size == 1:
        return None
    group, rank, size = distributed.model_group(mesh)
    return TensorParallel(group, rank, size)


def check_divisible(cfg, tp: int) -> None:
    """The port splits heads, kv heads, the MLP and the vocabulary in equal
    blocks and pads nothing (GSPMD pads where the port cannot): each must
    divide by tp (ROADMAP C21)."""
    for what, n in (("num_heads", cfg.num_heads), ("num_kv_heads", cfg.num_kv_heads),
                    ("mlp_dim", cfg.mlp_dim), ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"tensor parallelism: {what} {n} does not divide by tp {tp}")


def _decoder_of(model: nn.Module):
    return model.decoder if hasattr(model, "decoder") else model


def tp_plan(model: nn.Module, tp: int) -> Dict[str, Placement]:
    """{name in `model`: Placement over 'model'} of a WHOLE VLM or Decoder."""
    prefix = "" if hasattr(model, "decoder") else "decoder."
    shapes = {prefix + n: tuple(p.shape) for n, p in model.named_parameters()}
    return {n[len(prefix):]: pl for n, pl in tp_placements(shapes, tp).items()}


@torch.no_grad()
def shard_model(model: nn.Module, tp: Optional[TensorParallel]) -> nn.Module:
    """`model` (a whole VLM or Decoder, on the meta device or the host) in
    tp's local form, in place: every 'model'-split parameter replaced by the
    rank's slice (a copy, so the whole tensor can go), each quantized
    linear's buffers too (`quant_plan`), the decoder and its blocks given
    the group. LoRA factors stay whole. Returns the model; tp None changes
    nothing."""
    if tp is None:
        return model
    decoder = _decoder_of(model)
    if decoder.tp is not None:
        raise ValueError("shard_model: the model is already tensor parallel")
    check_divisible(decoder.cfg, tp.size)
    buffers = quant_plan(decoder, tp.size)
    for name, pl in buffers.items():
        if name.endswith(".q4_scale") and pl.model_dim == 0:       # a row-parallel int4 linear
            check_int4_groups(decoder.get_buffer(name).shape[0], tp.size, name)
    plan = tp_plan(model, tp.size)
    prefix = "decoder." if model is not decoder else ""
    whole: Dict[str, Placement] = {}
    for name, pl in plan.items():
        if not pl.model_sharded:
            continue
        mname, leaf = name.rsplit(".", 1)
        module = model.get_submodule(mname)
        old = getattr(module, leaf)
        new = nn.Parameter(pl.model_local(old.detach(), tp.rank).clone(),
                           requires_grad=old.requires_grad)
        setattr(module, leaf, new)
        if isinstance(module, nn.Linear):
            module.out_features, module.in_features = new.shape
        elif isinstance(module, nn.Embedding):
            module.num_embeddings = new.shape[0]
        whole[name[len(prefix):]] = pl
    for name, pl in buffers.items():
        mname, leaf = name.rsplit(".", 1)
        module = decoder.get_submodule(mname)
        module.register_buffer(leaf, pl.model_local(getattr(module, leaf), tp.rank).clone())
    set_tensor_parallel(decoder, tp, whole, buffers)
    return model


def set_tensor_parallel(decoder: nn.Module, tp: TensorParallel, plan: Dict[str, Placement],
                        buffers: Dict[str, Placement]) -> None:
    """Give a decoder in tp's local form its group and the placements of its
    split parameters and quantized buffers (by name in the decoder)."""
    decoder.tp, decoder.tp_plan, decoder.tp_buffers = tp, plan, buffers
    for block in decoder.blocks:
        block.tp = tp


def split_kind(name: str) -> str:
    """'row' for a row-parallel linear (o_proj, down_proj; by its module
    name), else 'column' (q/k/v/gate/up and lm_head)."""
    return "row" if name.rsplit(".", 1)[-1] in ROW_PARALLEL else "column"


def check_int4_groups(groups: int, tp: int, what: str = "an int4 linear") -> None:
    """A row-parallel int4 linear's groups must split evenly over the ranks:
    a group may not straddle two ranks (ROADMAP C28)."""
    if groups % tp:
        raise ValueError(f"{what}: {groups} int4 groups over its input dim do not split over "
                         f"tp {tp} (a group would straddle two ranks; ROADMAP C28)")


def quant_plan(decoder: nn.Module, tp: int) -> Dict[str, Placement]:
    """{buffer name in the decoder: Placement over 'model'} of the
    decoder's quantized linears (`QUANT_DIMS`)."""
    from visper_lm_tpu_torch.utils.param import QuantLinear

    out: Dict[str, Placement] = {}
    for mname, module in decoder.named_modules():
        if not isinstance(module, QuantLinear):
            continue
        for leaf, _ in module.named_buffers(recurse=False):
            dim = QUANT_DIMS[split_kind(mname)][leaf]
            if dim is not None:
                out[f"{mname}.{leaf}"] = Placement(model_dim=dim, model_parts=tp)
    return out


def model_placements(model: nn.Module) -> Dict[str, Placement]:
    """{name in `model`: Placement over 'model'} of a model `shard_model`
    cut (the decoder's split parameters and quantized buffers; nothing for a
    whole model)."""
    decoder = _decoder_of(model)
    plan = {**(getattr(decoder, "tp_plan", None) or {}),
            **(getattr(decoder, "tp_buffers", None) or {})}
    prefix = "decoder." if model is not decoder else ""
    return {prefix + n: pl for n, pl in plan.items()}


def _expert_bank(model: nn.Module, name: str):
    """The decoder's expert group when `name` is a MoE bank it splits, else None."""
    from visper_lm_tpu_torch.utils.param import is_expert_kernel, jax_path

    ep = getattr(_decoder_of(model), "ep", None)
    prefix = "" if hasattr(model, "decoder") else "decoder."
    return ep if ep is not None and is_expert_kernel(jax_path(prefix + name)) else None


def whole_param(model: nn.Module, name: str, local: torch.Tensor) -> torch.Tensor:
    """Parameter (or quantized buffer) `name`'s whole value from every
    rank's tp-local `local` (collective over the model group; `local`
    itself where it is not split).
    A MoE expert bank under expert parallelism: every rank's experts
    (collective over the expert group)."""
    ep = _expert_bank(model, name)
    if ep is not None:
        return distributed.all_gather(local.detach().contiguous(), 0, ep.group)
    pl = model_placements(model).get(name)
    tp = _decoder_of(model).tp
    if pl is None or tp is None:
        return local
    return distributed.all_gather(local.detach().contiguous(), pl.model_dim, tp.group)


def local_param(model: nn.Module, name: str, whole: torch.Tensor) -> torch.Tensor:
    """This rank's tp-local slice of parameter `name`'s whole value (a view;
    a MoE bank's: the rank's experts)."""
    ep = _expert_bank(model, name)
    if ep is not None:
        n = whole.shape[0] // ep.size
        return whole.narrow(0, ep.rank * n, n)
    pl = model_placements(model).get(name)
    tp = _decoder_of(model).tp
    if pl is None or tp is None:
        return whole
    return pl.model_local(whole, tp.rank)


def vocab_embed(weight: torch.Tensor, ids: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The token rows of `ids` from a vocab-parallel table: this rank holds
    rows [r V/tp, (r+1) V/tp) (`weight`); an id outside them (any other
    rank's, or a negative marker such as IMAGE_TOKEN_INDEX) reads row 0 and
    is zeroed, then the ranks' rows are added (one all-reduce): exact."""
    v = weight.shape[0]
    start = tp.rank * v
    inside = (ids >= start) & (ids < start + v)
    rows = F.embedding(torch.where(inside, ids - start, torch.zeros_like(ids)), weight)
    rows = rows.masked_fill(~inside[..., None], 0)
    return distributed.reduce_from_group(rows, tp.group)


class _SliceOfGroup(torch.autograd.Function):
    """The rank's block of a tensor replicated over the group; the backward
    gathers every rank's block gradient into the whole (exact, the same on
    every rank)."""

    @staticmethod
    def forward(ctx, t, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        n = t.shape[dim] // tp.size
        return t.narrow(dim, tp.rank * n, n)

    @staticmethod
    def backward(ctx, g):
        return distributed.all_gather(g.contiguous(), ctx.dim, ctx.tp.group), None, None


def slice_of_group(t: torch.Tensor, dim: int, tp: TensorParallel) -> torch.Tensor:
    """The rank's 1/tp block of the replicated `t` along `dim`, whose
    gradient comes back whole on every rank (the LoRA factors' slices)."""
    return _SliceOfGroup.apply(t, dim, tp)


def gather_vocab(logits: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Every rank's (..., V/tp) logits as (..., V), in vocab order (collective)."""
    return distributed.all_gather(logits.contiguous(), logits.ndim - 1, tp.group)


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[target] over a vocab split into the ranks'
    blocks (Megatron's cross-entropy): the max, then the sum of exp and the
    target's logit all-reduced. The backward is the rank's block of
    softmax - onehot(target), scaled by the gradient."""

    @staticmethod
    def forward(ctx, logits, target, tp):
        v = logits.shape[-1]
        start = tp.rank * v
        peak = logits.max(dim=-1).values
        distributed.all_reduce(peak, tp.group, op="max")
        shifted = logits - peak[..., None]
        e = shifted.exp()
        inside = (target >= start) & (target < start + v)
        local = torch.where(inside, target - start, torch.zeros_like(target))
        gold = torch.gather(shifted, -1, local[..., None])[..., 0] * inside
        sums = torch.stack([e.sum(dim=-1), gold])
        distributed.all_reduce(sums, tp.group)
        total, gold = sums.unbind(0)
        ctx.save_for_backward(e, total, local, inside)
        return total.log() - gold

    @staticmethod
    def backward(ctx, g):
        e, total, local, inside = ctx.saved_tensors
        grad = e / total[..., None]
        grad.scatter_add_(-1, local[..., None], -inside.to(grad.dtype)[..., None])
        return grad * g[..., None], None, None


def vocab_parallel_nll(logits: torch.Tensor, target: torch.Tensor,
                       tp: TensorParallel) -> torch.Tensor:
    """(...) NLL of `target` (ids in the whole vocabulary) under this rank's
    f32 (..., V/tp) logits; the same on every rank of the group."""
    return _VocabParallelNLL.apply(logits, target, tp)
