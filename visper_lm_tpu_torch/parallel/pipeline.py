"""Pipeline parallelism: GPipe layer pipelining over a 'pipe' axis
(counterpart of visper_lm_tpu/parallel/pipeline.py).

A pipeline of S stages cuts the decoder's L blocks into S contiguous ranges:
stage s owns blocks [s L/S, (s+1) L/S) (`PipeParallel.bounds`), holds their
parameters and trains them; every other block is a foreign block on that
rank, its parameters kept in shape but with no storage (`shard_pipeline`;
`vlm.init_vlm(..., pp=)` and `weights.from_jax_params(..., pp=)` build so,
never holding a foreign block on the device).

`pipeline_scan` is JAX's: the batch is cut into M microbatches, and stage s
runs its blocks on microbatch m once stage s - 1 has sent it (point to
point, `distributed.send` / `recv`), so stage s works on microbatch t - s
at tick t of the M + S - 1 ticks, the GPipe parallelogram. JAX computes
the bubble ticks on zeros (or the clamped last microbatch) and never
collects them; a process of the port blocks on its neighbour instead, so a
bubble computes nothing and passes no gradient. The result is the last
stage's outputs, sent to every stage (JAX's `out[-1]`), so each pipe rank
computes the loss on the same values. Exact: the pipeline only reorders
when each (block, microbatch) cell runs.

The backward (`_Pipeline`, an autograd Function) runs the reversed
schedule explicitly: each stage keeps the graph of each microbatch from
its forward, receives the output gradient of microbatch m from stage s + 1
(the last stage takes it from the loss), runs `torch.autograd.backward`
on that graph, which leaves the stage's parameter gradients in `.grad`,
and sends the input gradient to stage s - 1. The sends are issued in one
order on every stage, so gloo's in-order matching cannot deadlock (leaving
their order to autograd could). The loss's gradient is taken from ONE
copy (the last stage's), and stage 0's input gradient goes to every stage,
so the parameters before the pipeline get the same gradient on every pipe
rank: what one process computes, never the sum over the pipe ranks.
Tensors every stage reads whole (`shared`: the LoRA factors, stacked over
the layers) enter each microbatch's graph as leaves of its own; after the
schedule each stage's gradient of them (the rows of its own layers) is
summed over the pipe group.

A decoder call JAX would not pipeline (taps, a cache, B % S, a tensor
q_offset, L % S) runs the plain loop over every block, each foreign block
gathered from its owner around its use (`PipeParallel.enter` / `leave`,
as ZeRO-3 gathers its blocks: a broadcast over the pipe group before the
block's forward and again before its backward, freed after each).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn as nn

from visper_lm_tpu_torch.parallel import distributed
from visper_lm_tpu_torch.parallel.mesh import Mesh
from visper_lm_tpu_torch.parallel.sharding import _FreeAfterBackward, _GatherBeforeBackward


class PipeParallel:
    """One rank's pipeline: the process group of its stages, its stage
    (`rank`), the number of stages (`size`), and the decoder's blocks cut
    into `size` contiguous ranges (`bounds`, as even as the layer count
    allows). Once `shard_pipeline` has cut a decoder it also holds its
    blocks (`modules`): `gather` fills a foreign block's parameters from
    their owner and `free` empties them again."""

    def __init__(self, group, rank: int, size: int, num_layers: int):
        self.group, self.rank, self.size = group, rank, size
        self.num_layers = num_layers
        self.bounds = [s * num_layers // size for s in range(size + 1)]
        self.modules: Optional[nn.ModuleList] = None
        self.gathered: set = set()

    @property
    def foreign(self) -> List[int]:
        """The blocks other stages own."""
        return [i for i in range(self.num_layers) if not self.owns(i)]

    def owner(self, layer: int) -> int:
        """The stage that owns block `layer`."""
        return max(s for s in range(self.size) if self.bounds[s] <= layer)

    def owns(self, layer: int) -> bool:
        return self.owner(layer) == self.rank

    @property
    def layers(self) -> range:
        """The blocks this stage owns."""
        return range(self.bounds[self.rank], self.bounds[self.rank + 1])

    # -- the foreign blocks, gathered around a plain loop's use --------------

    @torch.no_grad()
    def gather(self, layer: int) -> None:
        """Block `layer`'s parameters on every stage (collective over the
        pipe group: its owner sends them)."""
        if layer in self.gathered:
            return
        src = self.owner(layer)
        for p in self.modules[layer].parameters():
            if src != self.rank:
                p.data.untyped_storage().resize_(p.numel() * p.element_size())
            distributed.broadcast(p.data, src, self.group)
        self.gathered.add(layer)

    def free(self, layer: int) -> None:
        """Release a foreign block's storage (the owner keeps its own)."""
        if layer not in self.gathered:
            return
        if not self.owns(layer):
            for p in self.modules[layer].parameters():
                p.data.untyped_storage().resize_(0)
        self.gathered.discard(layer)

    def enter(self, layer: int, h: torch.Tensor) -> torch.Tensor:
        """Before block `layer` of a plain loop: gather it; its storage is
        freed again once its backward has given h its gradient."""
        self.gather(layer)
        return _FreeAfterBackward.apply(h, self, layer) if h.requires_grad else h

    def leave(self, layer: int, h: torch.Tensor) -> torch.Tensor:
        """After block `layer` of a plain loop: free it; it is gathered again
        before its backward runs."""
        self.free(layer)
        return _GatherBeforeBackward.apply(h, self, layer) if h.requires_grad else h


def pipe_parallel(mesh: Optional[Mesh], num_layers: int) -> Optional[PipeParallel]:
    """This process's `PipeParallel` on the mesh's pipe axis for a decoder of
    `num_layers` blocks (collective: every process makes every group), None
    when the axis is 1 wide."""
    if mesh is None or mesh.pipe_size == 1:
        return None
    group, rank, size = distributed.pipe_group(mesh)
    if num_layers < size:
        raise ValueError(f"pipeline parallelism: {num_layers} layers for {size} stages")
    return PipeParallel(group, rank, size, num_layers)


def _decoder_of(model: nn.Module):
    return model.decoder if hasattr(model, "decoder") else model


def foreign_names(model: nn.Module) -> List[str]:
    """The names (in `model`) of the parameters of the blocks another stage
    owns; none without a pipeline."""
    decoder = _decoder_of(model)
    pipe = getattr(decoder, "pipe", None)
    if pipe is None:
        return []
    prefix = "decoder." if decoder is not model else ""
    return [f"{prefix}blocks.{i}.{n}" for i in range(len(decoder.blocks)) if not pipe.owns(i)
            for n, _ in decoder.blocks[i].named_parameters()]


def _freed(p: torch.Tensor, device) -> nn.Parameter:
    """A parameter of p's shape and dtype on `device`, with no storage (a
    meta tensor stays as it is: it has none)."""
    t = torch.empty(p.shape, dtype=p.dtype, device=device)
    if t.device.type != "meta":
        t.untyped_storage().resize_(0)
    return nn.Parameter(t, requires_grad=False)


def _free_block(block: nn.Module, device) -> None:
    """Every parameter of `block` replaced by a frozen storage-less one on
    `device`."""
    for module in block.modules():
        for leaf, p in list(module.named_parameters(recurse=False)):
            setattr(module, leaf, _freed(p, device))


def shard_pipeline(model: nn.Module, pipe: Optional[PipeParallel]) -> nn.Module:
    """`model` (a VLM or a bare Decoder, on the meta device or not) cut for
    `pipe`'s stage, in place: the decoder given the pipeline, each foreign
    block's parameters frozen and replaced by storage-less ones where they
    are (a meta model's stay on meta until `materialize_foreign`). Returns
    the model; pipe None changes nothing."""
    if pipe is None:
        return model
    decoder = _decoder_of(model)
    if decoder.pipe is not None:
        raise ValueError("shard_pipeline: the model is already cut for a pipeline")
    if len(decoder.blocks) != pipe.num_layers:
        raise ValueError(f"shard_pipeline: {len(decoder.blocks)} blocks, the pipeline cuts "
                         f"{pipe.num_layers}")
    decoder.pipe, pipe.modules = pipe, decoder.blocks
    for i in pipe.foreign:
        _free_block(decoder.blocks[i], next(decoder.blocks[i].parameters()).device)
    return model


def materialize_foreign(model: nn.Module, device) -> None:
    """The foreign blocks' parameters of a model cut on the meta device,
    storage-less on `device`."""
    decoder = _decoder_of(model)
    if decoder.pipe is not None:
        for i in decoder.pipe.foreign:
            _free_block(decoder.blocks[i], device)


@contextlib.contextmanager
def foreign_blocks_detached(model: nn.Module):
    """The foreign blocks out of the module tree for a while (so that
    `to_empty` does not allocate them), put back after."""
    decoder = _decoder_of(model)
    pipe = decoder.pipe
    held = {} if pipe is None else {i: decoder.blocks[i] for i in pipe.foreign}
    for i in held:
        decoder.blocks._modules[str(i)] = None
    try:
        yield
    finally:
        for i, block in held.items():
            decoder.blocks._modules[str(i)] = block


@torch.no_grad()
def whole_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: value} of every parameter of `model`, the foreign blocks'
    received from their owners (collective over the pipe group), as new
    tensors where they were gathered."""
    decoder = _decoder_of(model)
    pipe = decoder.pipe
    out = {}
    prefix = "decoder." if decoder is not model else ""
    for name, p in model.named_parameters():
        out[name] = p.detach()
    if pipe is None:
        return out
    for i in range(pipe.num_layers):
        for n, p in decoder.blocks[i].named_parameters():
            buf = p.detach().clone() if pipe.owns(i) else torch.empty(p.shape, dtype=p.dtype,
                                                                      device=p.device)
            out[f"{prefix}blocks.{i}.{n}"] = distributed.broadcast(buf, pipe.owner(i), pipe.group)
    return out


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


def n_micro_for(batch: int, stages: int) -> int:
    """JAX's choice of microbatches: the largest divisor of the batch in
    (stages, min(batch, 4 stages)], else `stages` (the bubble (S-1)/(M+S-1)
    shrinks with M; too small a microbatch starves the card)."""
    for m in range(min(batch, 4 * stages), stages, -1):
        if batch % m == 0:
            return m
    return stages


def _split(args: Mapping[str, Any], batch: int, m: int, i: int) -> Dict[str, Any]:
    """Microbatch i of m of the leaves whose leading dim is the batch; the
    others whole."""
    size = batch // m
    return {k: v[i * size:(i + 1) * size] if torch.is_tensor(v) and v.ndim >= 1
            and v.shape[0] == batch else v for k, v in args.items()}


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule (see the module docstring). Inputs: h (the whole
    batch, the same on every stage), the schedule's state, the shared
    tensors (whole on every stage; each microbatch's graph reads them as
    leaves of its own, and their gradient is the stages' shares summed over
    the pipe group), and the stage's parameters that train (so that the
    result needs a gradient when they do; their gradients reach `.grad`
    from the inner backward)."""

    @staticmethod
    def forward(ctx, h, state, *tensors):
        fn, blocks, args, group, m, names = state
        shared = dict(zip(names, tensors))
        s, n = distributed.group_rank(group), distributed.group_size(group)
        b = h.shape[0]
        size = b // m
        build = any(ctx.needs_input_grad)
        leaves = {k: t.detach().requires_grad_(build and t.requires_grad)
                  for k, t in shared.items()}
        graphs, outs = [], []
        for i in range(m):
            if s == 0:
                x = h[i * size:(i + 1) * size]
            else:
                x = distributed.recv((size,) + tuple(h.shape[1:]), h.dtype, h.device, s - 1, group)
            x = x.detach().requires_grad_(build)
            a = dict(_split(args, b, m, i), **leaves)
            with torch.enable_grad() if build else contextlib.nullcontext():
                y = x
                for blk in blocks:
                    y = fn(blk, y, a)
            if s < n - 1:
                distributed.send(y.detach(), s + 1, group)
            else:
                outs.append(y.detach())
            if build:
                graphs.append((x, y))
        out = torch.cat(outs) if s == n - 1 else torch.empty_like(h)
        distributed.broadcast(out, n - 1, group)
        ctx.graphs, ctx.group, ctx.m = graphs, group, m
        ctx.leaves, ctx.n_params = list(leaves.values()), len(tensors) - len(leaves)
        return out

    @staticmethod
    def backward(ctx, g):
        group, m = ctx.group, ctx.m
        s, n = distributed.group_rank(group), distributed.group_size(group)
        size = g.shape[0] // m
        parts = []
        for i, (x, y) in enumerate(ctx.graphs):
            if s == n - 1:
                gy = g[i * size:(i + 1) * size]          # one copy of the loss: the last stage's
            else:
                gy = distributed.recv(y.shape, y.dtype, y.device, s + 1, group)
            torch.autograd.backward(y, gy.contiguous())
            gx = x.grad if x.grad is not None else torch.zeros_like(x)
            if s > 0:
                distributed.send(gx, s - 1, group)
            else:
                parts.append(gx)
        ctx.graphs = []
        dh = torch.cat(parts) if s == 0 else torch.empty_like(g)
        distributed.broadcast(dh, 0, group)
        # a shared tensor's gradient: each stage's share (zeros where its
        # microbatches never read it) summed over the stages
        shared = [None if not x.requires_grad else distributed.all_reduce(
            x.grad if x.grad is not None else torch.zeros_like(x), group) for x in ctx.leaves]
        ctx.leaves = []
        return (dh, None) + tuple(shared) + (None,) * ctx.n_params


def pipeline_scan(
    block_fn: Callable[[Any, torch.Tensor, Dict[str, Any]], torch.Tensor],
    blocks: Sequence[Any],                 # all L blocks, in order (a stage reads its own)
    h: torch.Tensor,                       # (B, ...) the whole batch, on every stage
    micro_args: Optional[Mapping[str, Any]] = None,   # {name: (B, ...) per sample, or whole}
    *,
    group,
    n_micro: Optional[int] = None,
    params: Sequence[torch.Tensor] = (),
    shared: Optional[Mapping[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Apply the L blocks to h through the group's S stages (JAX
    `pipeline_scan`): stage s runs blocks [s L/S, (s+1) L/S), one at a time,
    block_fn(block, h_micro, args_micro) -> h_micro on one microbatch; the
    `micro_args` leaves whose leading dim is B are cut into microbatches
    alongside h, the others passed whole, and they take no gradient.
    `shared` ({name: tensor}, the same on every stage) joins the args whole
    and takes a gradient: the stages' shares summed over the group (the
    LoRA factors, stacked over the layers: each stage's rows).
    `params`: the stage's parameters that train (their gradients land in
    `.grad`). Returns the last stage's result (B, ...) on every stage. A
    group of one stage runs the plain loop."""
    micro_args = dict(micro_args or {})
    shared = dict(shared or {})
    n = distributed.group_size(group) if distributed.is_initialized() else 1
    if n == 1:
        micro_args.update(shared)
        for blk in blocks:
            h = block_fn(blk, h, micro_args)
        return h
    if len(blocks) % n:
        raise ValueError(f"layers ({len(blocks)}) % pipe stages ({n}) != 0")
    b = h.shape[0]
    m = n if n_micro is None else n_micro
    if b % m:
        raise ValueError(f"batch ({b}) % n_micro ({m}) != 0")
    s, per = distributed.group_rank(group), len(blocks) // n
    mine = list(blocks[s * per:(s + 1) * per])
    return _Pipeline.apply(h, (block_fn, mine, micro_args, group, m, list(shared)),
                           *shared.values(), *params)
