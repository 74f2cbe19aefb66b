"""Parameter / optimizer-state sharding plans and their placements
(counterpart of visper_lm_tpu/parallel/sharding.py).

The plans are JAX's, computed the way JAX computes them: on the JAX param
tree's paths and on its STACKED shapes (the decoder's and the towers'
blocks as (L, ...) leaves; `jax_shapes` builds that view of the port's
parameters), so each leaf's spec equals JAX's PartitionSpec, as a plain
tuple of axis names:

  * `param_pspecs`: `_PARAM_RULES` (the Megatron rules of the 'model' axis;
    with tp = 1 they shard nothing, but they decide which dims ZeRO may
    take);
  * `zero_pspec`: the 'data' axis on the largest still-unsharded dim that
    the data size divides, for a leaf of at least `min_size` elements
    (ZeRO-1/2 on the moments; ZeRO-3 on the parameters with `zero_params`,
    on the frozen ones with `zero_frozen`);
  * `opt_state_pspecs`: a moment's spec is `zero_pspec` of the spec of the
    FIRST trainable of its shape in the tree's order, as JAX looks it up by
    shape (so q_proj's moments take o_proj's spec where their shapes agree);
  * `batch_pspecs`, `model_shard_pspec`.

`placements` turns a leaf's spec into the port's placement of each of its
per-layer tensors: the tensor's dim that is split over the data axis (the
JAX dim mapped through the port's layout: a linear kernel is the transpose
of nn.Linear's weight, a conv kernel HWIO of OIHW) and this rank's slice.
Where JAX splits a stacked leaf along its layers, each layer's tensor lives
whole on the rank that owns that layer (`Placement.owner`).

`ShardedParams` keeps ZeRO-3's persistent copy: the rank's slices, the
full parameters' storage freed, gathered for a decoder block's forward and
again for its backward (models/decoder.py calls `enter` / `leave` around
each block), and for the step for the rest.

JAX's `to_named` and `constrain` have no twin: the port has no sharding
annotations, only these plans and the collectives that apply them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from visper_lm_tpu_torch.parallel import distributed
from visper_lm_tpu_torch.parallel.mesh import DATA_AXIS, EXPERT_AXIS, MODEL_AXIS
from visper_lm_tpu_torch.utils.param import is_expert_kernel, jax_path, split_layer

Spec = Tuple[Any, ...]

# (path-regex, spec) — first match wins. Paths look like
# "decoder/blocks/q_proj/kernel"; stacked block params have a leading layer axis.
_PARAM_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r"decoder/embed_tokens/embedding$", (MODEL_AXIS, None)),
    (r"decoder/lm_head/kernel$", (None, MODEL_AXIS)),
    (r"decoder/blocks(?:_chunks/\d+)?/(q_proj|k_proj|v_proj)/kernel$", (None, None, MODEL_AXIS)),
    (r"decoder/blocks(?:_chunks/\d+)?/o_proj/kernel$", (None, MODEL_AXIS, None)),
    (r"decoder/blocks(?:_chunks/\d+)?/(gate_proj|up_proj)/kernel$", (None, None, MODEL_AXIS)),
    (r"decoder/blocks(?:_chunks/\d+)?/down_proj/kernel$", (None, MODEL_AXIS, None)),
    (r"decoder/blocks/(moe_gate|moe_up|moe_down)/kernel$", (None, EXPERT_AXIS, None, None)),
)


def _has_data(entry) -> bool:
    return entry == DATA_AXIS or (isinstance(entry, tuple) and DATA_AXIS in entry)


def jax_shapes(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, Tuple[int, ...]]:
    """{JAX path: the JAX leaf's shape} of the port's parameters: a linear
    kernel (in, out), a conv kernel HWIO, a stacked block list (L, ...), in
    the JAX tree's leaf order (sorted paths)."""
    per: Dict[str, Tuple[int, ...]] = {}
    layers: Dict[str, int] = {}
    for name, t in named:
        path = jax_path(name)
        per[path] = _jax_layout(path, tuple(t.shape))
        if split_layer(name)[1] is not None:
            layers[path] = layers.get(path, 0) + 1
    return {p: ((layers[p],) + per[p] if p in layers else per[p])
            for p in sorted(per, key=tree_order)}


def tree_order(path: str) -> Tuple[Tuple[int, Any], ...]:
    """Sort key of a JAX path in the tree's leaf order: dict keys as
    strings, list indices as numbers."""
    return tuple((0, int(s)) if s.isdigit() else (1, s) for s in path.split("/"))


def _jax_layout(path: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """A port tensor's shape in the JAX layout (`utils.param.jax_flat_arrays`)."""
    if not path.endswith("/kernel") or is_expert_kernel(path):
        return shape
    return tuple(shape[d] for d in _kernel_perm(len(shape)))


def _kernel_perm(ndim: int) -> Tuple[int, ...]:
    """JAX dim k of a kernel is the port's dim perm[k]."""
    return (2, 3, 1, 0) if ndim == 4 else tuple(range(ndim))[::-1]


def param_pspecs(shapes: Mapping[str, Sequence[int]]) -> Dict[str, Spec]:
    """{JAX path: spec} by `_PARAM_RULES` (JAX `param_pspecs`)."""

    def assign(path, shape):
        for pattern, spec in _PARAM_RULES:
            if re.search(pattern, path) and len(spec) <= len(shape):
                return spec
        return ()

    return {p: assign(p, s) for p, s in shapes.items()}


def zero_pspec(spec: Spec, shape: Sequence[int], data_size: int, min_size: int = 2 ** 16) -> Spec:
    """Add the 'data' axis to the largest unsharded divisible dim (ZeRO
    sharding); leaves under min_size elements, and leaves already
    data-sharded, keep their spec."""
    shape = tuple(int(d) for d in shape)
    spec = tuple(spec)
    if math.prod(shape) < min_size or data_size <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if any(_has_data(e) for e in entries):
        return spec
    best_axis, best_dim = None, 0
    for i, (s, d) in enumerate(zip(entries, shape)):
        if s is None and d % data_size == 0 and d > best_dim:
            best_axis, best_dim = i, d
    if best_axis is None:
        return spec
    entries[best_axis] = DATA_AXIS
    return tuple(entries)


def opt_state_pspecs(trainable_shapes: Mapping[str, Sequence[int]],
                     train_specs: Mapping[str, Spec], data_size: int) -> Dict[str, Spec]:
    """{JAX path: the spec of that trainable's moments (and master copy)}
    (JAX `opt_state_pspecs`): the spec of the first trainable of the same
    shape, in the tree's order, with ZeRO's 'data' axis added. Scalars
    replicate."""
    by_shape: Dict[Tuple[int, ...], Spec] = {}
    for path in sorted(trainable_shapes, key=tree_order):
        by_shape.setdefault(tuple(trainable_shapes[path]), train_specs[path])
    out = {}
    for path, shape in trainable_shapes.items():
        shape = tuple(shape)
        out[path] = () if not shape else zero_pspec(by_shape.get(shape, ()), shape, data_size)
    return out


def batch_pspecs(batch: Mapping[str, Any], leading_accum: bool = False) -> Dict[str, Spec]:
    """Every batch array split along 'data' on its batch axis (axis 1 under
    a leading (accum_steps, ...) axis)."""

    def assign(leaf):
        nd = getattr(leaf, "ndim", 0)
        if leading_accum:
            return () if nd <= 1 else (None, DATA_AXIS) + (None,) * (nd - 2)
        return () if nd == 0 else (DATA_AXIS,) + (None,) * (nd - 1)

    return {k: assign(v) for k, v in batch.items()}


def model_shard_pspec(shape: Sequence[int], tp_size: int, min_size: int = 2 ** 16) -> Spec:
    """Shard the largest tp-divisible dim over 'model' (frozen teacher
    weights under shard_teachers: `teacher_placements`). Small tensors
    replicate."""
    shape = tuple(int(d) for d in shape)
    if tp_size <= 1 or not shape or math.prod(shape) < min_size:
        return ()
    best = None
    for i, d in enumerate(shape):
        if d % tp_size == 0 and (best is None or d > shape[best]):
            best = i
    if best is None:
        return ()
    entries: List[Any] = [None] * len(shape)
    entries[best] = MODEL_AXIS
    return tuple(entries)


# ---------------------------------------------------------------------------
# placements: a spec applied to the port's tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one port tensor lives over the mesh's two axes.

    Over the 'model' axis of `model_parts` ranks the WHOLE tensor is split
    into equal slices along `model_dim` (tensor parallelism: each model
    rank holds its slice as its parameter, the "tp-local" tensor), or
    replicated (model_dim None). Over the data axis of `parts` ranks that
    tp-local tensor is replicated (dim and owner None), split into equal
    slices along `dim`, or whole on data rank `owner` (a stacked leaf split
    along its layers: the other ranks hold an empty slice of it). `sharded`
    and the methods without "model" in their names are the data axis's, on
    the tp-local tensor (ZeRO's group is the ranks with one model
    coordinate); `tile` and `box` are a rank's piece of the whole tensor.
    Over the 'expert' axis of `expert_parts` ranks a MoE expert bank is
    split along `expert_dim` (its experts: each rank holds its E/ep as its
    parameter, like a tp-local tensor); the data axis's methods then work
    on that expert-local tensor."""

    dim: Optional[int] = None
    parts: int = 1
    owner: Optional[int] = None
    model_dim: Optional[int] = None
    model_parts: int = 1
    expert_dim: Optional[int] = None
    expert_parts: int = 1

    @property
    def sharded(self) -> bool:
        return self.dim is not None or self.owner is not None

    @property
    def model_sharded(self) -> bool:
        return self.model_dim is not None

    @property
    def expert_sharded(self) -> bool:
        return self.expert_dim is not None

    def expert_local(self, t: torch.Tensor, expert_rank: int) -> torch.Tensor:
        """expert rank's slice of the whole t (a view)."""
        if self.expert_dim is None:
            return t
        size = t.shape[self.expert_dim] // self.expert_parts
        return t.narrow(self.expert_dim, expert_rank * size, size)

    def bounds(self, shape: Sequence[int], rank: int) -> Tuple[int, int, int]:
        """(dim, start, stop) of data rank's slice of a tp-local tensor."""
        if self.owner is not None:
            return 0, 0, (int(shape[0]) if rank == self.owner else 0)
        if self.dim is None:
            return 0, 0, (int(shape[0]) if len(shape) else 1)
        size = int(shape[self.dim]) // self.parts
        return self.dim, rank * size, (rank + 1) * size

    def local(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """data rank's slice of the tp-local t (a view; t itself when
        replicated over the data axis)."""
        if not self.sharded:
            return t
        if t.ndim == 0:
            t = t.reshape(1)
        dim, start, stop = self.bounds(t.shape, rank)
        return t.narrow(dim, start, stop - start)

    def local_shape(self, shape: Sequence[int], rank: int) -> Tuple[int, ...]:
        shape = tuple(int(d) for d in shape)
        if not self.sharded:
            return shape
        shape = shape or (1,)
        dim, start, stop = self.bounds(shape, rank)
        return shape[:dim] + (stop - start,) + shape[dim + 1:]

    def model_local(self, t: torch.Tensor, model_rank: int) -> torch.Tensor:
        """model rank's tp-local slice of the whole t (a view)."""
        if self.model_dim is None:
            return t
        size = t.shape[self.model_dim] // self.model_parts
        return t.narrow(self.model_dim, model_rank * size, size)

    def model_local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        shape = tuple(int(d) for d in shape)
        if self.model_dim is None:
            return shape
        d = self.model_dim
        return shape[:d] + (shape[d] // self.model_parts,) + shape[d + 1:]

    def whole_shape(self, local_shape: Sequence[int]) -> Tuple[int, ...]:
        """The whole tensor's shape from a tp- (or expert-) local one."""
        shape = tuple(int(d) for d in local_shape)
        for d, parts in ((self.model_dim, self.model_parts), (self.expert_dim, self.expert_parts)):
            if d is not None:
                shape = shape[:d] + (shape[d] * parts,) + shape[d + 1:]
        return shape

    def spec(self, ndim: int) -> Spec:
        """The axes over which each dim of the whole tensor is split, as a
        spec of the port's layout (a layer owner: 'data' on dim 0)."""
        entries: List[Any] = [None] * max(ndim, 1)
        if self.model_dim is not None:
            entries[self.model_dim] = MODEL_AXIS
        if self.expert_dim is not None:
            entries[self.expert_dim] = EXPERT_AXIS
        data = 0 if self.owner is not None else self.dim
        if data is not None:
            entries[data] = DATA_AXIS if entries[data] is None else (DATA_AXIS, MODEL_AXIS)
        return tuple(entries)

    def tile(self, t: torch.Tensor, data_rank: int, model_rank: int) -> torch.Tensor:
        """The (data rank, model rank)'s piece of the whole t (a view)."""
        return self.local(self.model_local(t, model_rank), data_rank)

    def box(self, shape: Sequence[int], data_rank: int,
            model_rank: int) -> Tuple[Tuple[int, int], ...]:
        """The (start, stop) ranges, one a dim, of the whole tensor of
        `shape` that the (data rank, model rank) holds."""
        shape = tuple(int(d) for d in shape) or (1,)
        box = [(0, d) for d in shape]
        if self.model_dim is not None:
            size = shape[self.model_dim] // self.model_parts
            box[self.model_dim] = (model_rank * size, (model_rank + 1) * size)
        if self.sharded:
            local = self.model_local_shape(shape)
            d, a, b = self.bounds(local, data_rank)
            off = box[d][0]
            box[d] = (off + a, off + b) if b > a else (off, off)
        return tuple(box)


def _port_dim(path: str, ndim: int, axis: int) -> int:
    """The port tensor's dim of JAX dim `axis` of a per-layer leaf (a
    kernel's layout mapped through `_kernel_perm`)."""
    if path.endswith("/kernel") and not is_expert_kernel(path):
        return _kernel_perm(ndim)[axis]
    return axis


def _axis_of(spec: Spec, axis_name: str) -> Optional[int]:
    return next((i for i, e in enumerate(spec) if e == axis_name or (
        isinstance(e, tuple) and axis_name in e)), None)


def placements(named_shapes: Mapping[str, Sequence[int]], specs: Mapping[str, Spec],
               data_size: int, model_size: int = 1, expert_size: int = 1) -> Dict[str, Placement]:
    """{port name: Placement} of each per-layer tensor under its JAX leaf's
    spec (specs keyed by JAX path; a path without one replicates); shapes
    are the WHOLE tensors'. The 'model' axis counts only when model_size >
    1, the 'expert' axis only when expert_size > 1, the data axis only when
    data_size > 1."""
    layers: Dict[str, int] = {}
    for name in named_shapes:
        if split_layer(name)[1] is not None:
            layers[jax_path(name)] = layers.get(jax_path(name), 0) + 1
    out = {}
    for name, shape in named_shapes.items():
        path, layer = jax_path(name), split_layer(name)[1]
        spec = tuple(specs.get(path, ()))
        ndim = len(shape)
        stacked = 1 if layer is not None else 0
        kw: Dict[str, Any] = {}
        m_axis = _axis_of(spec, MODEL_AXIS) if model_size > 1 else None
        if m_axis is not None:
            if m_axis < stacked:
                raise ValueError(f"{path}: the 'model' axis on the layer axis has no placement")
            kw.update(model_dim=_port_dim(path, ndim, m_axis - stacked), model_parts=model_size)
        e_axis = _axis_of(spec, EXPERT_AXIS) if expert_size > 1 else None
        if e_axis is not None:
            kw.update(expert_dim=_port_dim(path, ndim, e_axis - stacked), expert_parts=expert_size)
        axis = _axis_of(spec, DATA_AXIS) if data_size > 1 else None
        if axis is not None:
            if axis < stacked:
                kw.update(parts=data_size, owner=layer // (layers[path] // data_size))
            else:
                kw.update(dim=_port_dim(path, ndim, axis - stacked), parts=data_size)
        out[name] = Placement(**kw)
    return out


def assemble(pl: Placement, local: torch.Tensor, out: torch.Tensor, group, rank: int) -> None:
    """Every rank's slice `local` of a tensor placed by `pl` into `out`, the
    whole tensor, on every rank (collective): an all-gather along the split
    dim, or a broadcast from the owner."""
    if pl.owner is not None:
        if rank == pl.owner:
            out.copy_(local.reshape(out.shape))
        distributed.broadcast(out, pl.owner, group)
    elif pl.dim is not None:
        distributed.all_gather(local.contiguous(), pl.dim, group, out=out)
    else:
        out.copy_(local)


def scatter_grad(pl: Placement, g: torch.Tensor, group, rank: int) -> torch.Tensor:
    """A full gradient summed over the ranks, as rank's slice under `pl`
    (collective; g must be contiguous and may be overwritten): an
    all-reduce, a reduce-scatter along the split dim, or a reduce to the
    owner."""
    if pl.owner is not None:
        return pl.local(distributed.reduce(g, pl.owner, group), rank)
    if pl.dim is not None:
        return distributed.reduce_scatter(g, pl.dim, group)
    return distributed.all_reduce(g, group)


@dataclasses.dataclass
class ZeroPlan:
    """The ZeRO layout of one train step on a data axis of `size` ranks:
    each trainable's moments (and master copy), each parameter's persistent
    copy (replicated unless zero_params / zero_frozen shard it), the
    process group the collectives run on (the data group), and under tensor
    parallelism the rank's `tp` group (parallel/tensor.TensorParallel).
    Under sequence parallelism `seq` (parallel/sequence.SequenceParallel)
    shards no parameter: its ranks' gradients are summed. Under pipeline
    parallelism `pipe` (parallel/pipeline.PipeParallel) ZeRO runs over the
    data group inside the stage, on the stage's blocks and the shared
    parameters; the plans are made on the whole model's shapes, as JAX's.
    Under expert parallelism `ep` (parallel/distributed.AxisGroup) a MoE bank is the
    rank's experts, ZeRO runs over the data group of ranks that hold the
    same experts, and a bank's share of the norm is added over `ep`."""

    group: Any
    rank: int
    size: int
    moments: Dict[str, Placement]
    params: Dict[str, Placement]
    tp: Any = None
    seq: Any = None
    pipe: Any = None
    ep: Any = None


def plan_zero(named: Mapping[str, torch.Tensor], trainable: Mapping[str, bool], data_size: int,
              *, zero_params: bool = False, zero_frozen: bool = False,
              zero_min_size: int = 2 ** 16, model_size: int = 1, expert_size: int = 1,
              ) -> Tuple[Dict[str, Placement], Dict[str, Placement],
                         Dict[str, Spec], Dict[str, Spec]]:
    """JAX `plan_train_shardings` on the port's parameters (tp-local when
    model_size > 1: their whole shapes are planned): (moment placements of
    the trainables, parameter placements of all, the parameters' JAX specs,
    the moments' specs).

    The moments' layout under tensor parallelism: JAX looks a moment's spec
    up by SHAPE (`opt_state_pspecs`), so some moments get a 'model' dim
    other than their parameter's (q_proj's take o_proj's at Llama-3-8B),
    and XLA reshards between the gradient and the moment. The update is
    elementwise, so the port keeps every moment in its parameter's own tp
    slice: where JAX's moment spec splits 'model' along another dim than
    the parameter's, the moment's spec is `zero_pspec` of the parameter's
    own spec, with the same bytes a rank (tests/test_torch_sharding.py).
    With model_size 1 the moments' specs are JAX's. expert_size > 1: the
    expert banks are the rank's E/ep experts (planned on their whole
    shapes, JAX's 'expert' dim kept in the specs)."""
    shapes = jax_shapes((n, t) for n, t in named.items())
    is_train = {jax_path(n): trainable[n] for n in named}
    specs = param_pspecs(shapes)
    for axis, size in ((MODEL_AXIS, model_size), (EXPERT_AXIS, expert_size)):
        if size > 1:
            shapes = {p: _whole_jax_shape(s, specs[p], size, axis) for p, s in shapes.items()}
    for path, shape in shapes.items():
        if (zero_params and is_train[path]) or (zero_frozen and not is_train[path]):
            specs[path] = zero_pspec(specs[path], shape, data_size, min_size=zero_min_size)
    train_shapes = {p: s for p, s in shapes.items() if is_train[p]}
    moment_specs = opt_state_pspecs(train_shapes, {p: specs[p] for p in train_shapes}, data_size)
    if model_size > 1:
        for path in train_shapes:
            if _axis_of(moment_specs[path], MODEL_AXIS) != _axis_of(specs[path], MODEL_AXIS):
                moment_specs[path] = zero_pspec(specs[path], train_shapes[path], data_size)
    port_shapes = {n: tuple(t.shape) for n, t in named.items()}
    if model_size > 1 or expert_size > 1:
        split_only = placements(port_shapes, specs, 1, model_size, expert_size)
        port_shapes = {n: split_only[n].whole_shape(s) for n, s in port_shapes.items()}
    params = placements(port_shapes, specs, data_size, model_size, expert_size)
    moments = placements({n: s for n, s in port_shapes.items() if trainable[n]}, moment_specs,
                         data_size, model_size, expert_size)
    return moments, params, specs, moment_specs


def _whole_jax_shape(shape: Sequence[int], spec: Spec, size: int,
                     axis_name: str = MODEL_AXIS) -> Tuple[int, ...]:
    """A tp- (or expert-) local JAX-layout shape times size along its
    `axis_name` dim."""
    shape = tuple(int(d) for d in shape)
    axis = _axis_of(spec, axis_name)
    if axis is None or axis >= len(shape):
        return shape
    return shape[:axis] + (shape[axis] * size,) + shape[axis + 1:]


def tp_placements(named_shapes: Mapping[str, Sequence[int]],
                  model_size: int) -> Dict[str, Placement]:
    """{port name: Placement} over the 'model' axis alone (`_PARAM_RULES`,
    JAX's Megatron rules) of the whole tensors `named_shapes`: what
    `parallel/tensor.shard_model` cuts."""
    shapes = jax_shapes((n, torch.empty(tuple(s), device="meta")) for n, s in named_shapes.items())
    return placements(named_shapes, param_pspecs(shapes), 1, model_size)


# the teachers' stacked block lists in the JAX tree (layer index dropped)
_TEACHER_STACKED = re.compile(r"^((?:dinov2|clip_h)\.blocks\.|swin\.stages\.\d+\.blocks\.)(\d+)\.(.*)$")


def _module_perm(module: nn.Module, ndim: int) -> Tuple[int, ...]:
    """JAX dim k of a teacher weight is the port's dim perm[k]."""
    if isinstance(module, nn.ConvTranspose2d):
        return (2, 3, 0, 1)
    if isinstance(module, (nn.Conv2d, nn.Linear)):
        return _kernel_perm(ndim)
    return tuple(range(ndim))


def teacher_leaves(teachers: nn.Module) -> Dict[str, Tuple[str, Tuple[int, ...], Tuple[int, ...],
                                                           bool]]:
    """{port name: (JAX path, JAX leaf shape (stacked: (L, ...)), JAX dim ->
    port dim, stacked)} of the teachers' parameters (JAX `init_teachers`'
    tree: dinov2 / clip_h blocks and each Swin stage's blocks stacked)."""
    mods = dict(teachers.named_modules())
    per: Dict[str, Tuple[str, Tuple[int, ...], Tuple[int, ...], bool]] = {}
    counts: Dict[str, int] = {}
    for name, p in teachers.named_parameters():
        mname, leaf = name.rsplit(".", 1)
        module = mods[mname]
        perm = _module_perm(module, p.ndim) if leaf == "weight" else tuple(range(p.ndim))
        jax_leaf = "kernel" if leaf == "weight" and isinstance(
            module, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)) else leaf
        m = _TEACHER_STACKED.match(mname + "." + jax_leaf)
        flat = (m.group(1) + m.group(3)) if m else mname + "." + jax_leaf
        path = flat.replace(".", "/")
        shape = tuple(int(p.shape[d]) for d in perm)
        if m:
            counts[path] = counts.get(path, 0) + 1
        per[name] = (path, shape, perm, m is not None)
    return {n: (path, ((counts[path],) + shape) if stacked else shape, perm, stacked)
            for n, (path, shape, perm, stacked) in per.items()}


def teacher_placements(teachers: nn.Module, model_size: int) -> Dict[str, Placement]:
    """{port name: Placement over the 'model' axis} of the frozen teachers
    under `shard_teachers`: JAX's `model_shard_pspec` of each leaf of the
    JAX tree (its largest tp-divisible dim over 'model', leaves of at least
    2^16 elements), mapped onto the port's per-layer tensors."""
    out = {}
    for name, (path, shape, perm, stacked) in teacher_leaves(teachers).items():
        axis = _axis_of(model_shard_pspec(shape, model_size), MODEL_AXIS)
        if axis is None:
            out[name] = Placement()
            continue
        if stacked and axis == 0:
            raise ValueError(f"{path}: model_shard_pspec splits the layer axis")
        out[name] = Placement(model_dim=perm[axis - int(stacked)], model_parts=model_size)
    return out


# ---------------------------------------------------------------------------
# ZeRO-3: the parameters' persistent copy sharded, gathered per use
# ---------------------------------------------------------------------------


class _GatherBeforeBackward(torch.autograd.Function):
    """Identity; its backward (which runs before the block's) gathers the
    block's parameters."""

    @staticmethod
    def forward(ctx, h, owner, key):
        ctx.owner, ctx.key = owner, key
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g):
        ctx.owner.gather(ctx.key)
        return g, None, None


class _FreeAfterBackward(torch.autograd.Function):
    """Identity; its backward (which runs once the block's has given the
    block's input its gradient) frees the block's parameters."""

    @staticmethod
    def forward(ctx, h, owner, key):
        ctx.owner, ctx.key = owner, key
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g):
        ctx.owner.free(ctx.key)
        return g, None, None


_BLOCK = re.compile(r"^decoder\.blocks\.(\d+)\.")


class ShardedParams:
    """ZeRO-3's persistent copy of the parameters that `placements` shards:
    `shards[name]` is the rank's slice; the parameter keeps its shape and
    identity, but its storage is freed (resized to 0 bytes) between uses.

    `gather(key)` refills the storage of one group of parameters from every
    rank's slice, `free(key)` releases it. The groups are the decoder blocks
    (key: the block's index), gathered by `enter` before the block's forward
    and by the backward of the boundary `leave` puts on its output, and
    freed after each (whatever remat recomputes runs between the two); and
    "rest", every other sharded parameter. `in_step()` holds the step's
    forward and backward: "rest" gathered throughout, `enter` / `leave`
    active, every group freed after. Outside it `enter` / `leave` do
    nothing, so what reads the model between steps sees the parameters as
    they are: `whole()` gathers every group for a while (a step hook),
    `gather_all()` for good (the model `train` returns). A saved activation
    that refers to a parameter sees the same storage again once it is
    gathered."""

    REST = "rest"

    def __init__(self, named: Mapping[str, nn.Parameter], plan: Mapping[str, Placement],
                 group, rank: int):
        self.group, self.rank = group, rank
        self.params = {n: p for n, p in named.items() if plan[n].sharded}
        self.plan = {n: plan[n] for n in self.params}
        self.groups: Dict[Any, List[str]] = {}
        self.shards: Dict[str, torch.Tensor] = {}
        for n, p in self.params.items():
            m = _BLOCK.match(n)
            self.groups.setdefault(int(m.group(1)) if m else self.REST, []).append(n)
            with torch.no_grad():
                self.shards[n] = self.plan[n].local(p.detach(), rank).clone()
                # a storage of the allocator's own, which can be resized
                p.data = torch.empty(p.shape, dtype=p.dtype, device=p.device)
        self.gathered = set(self.groups)
        self.active = False
        for key in list(self.groups):
            self.free(key)

    @property
    def shard_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.shards.values())

    @torch.no_grad()
    def gather(self, key) -> None:
        if key in self.gathered or key not in self.groups:
            return
        for n in self.groups[key]:
            p = self.params[n]
            p.data.untyped_storage().resize_(p.numel() * p.element_size())
            self.assemble(n, self.shards[n], p.data)
        self.gathered.add(key)

    def assemble(self, n: str, shard: torch.Tensor, out: torch.Tensor) -> None:
        """Every rank's `shard` of parameter n into `out` (the full tensor)."""
        assemble(self.plan[n], shard, out, self.group, self.rank)

    def free(self, key) -> None:
        if key not in self.gathered:
            return
        for n in self.groups[key]:
            self.params[n].data.untyped_storage().resize_(0)
        self.gathered.discard(key)

    def free_all(self) -> None:
        for key in list(self.gathered):
            self.free(key)

    def gather_all(self) -> None:
        """Every parameter whole until the next step frees it (collective)."""
        for key in self.groups:
            self.gather(key)

    @contextlib.contextmanager
    def whole(self):
        """Every parameter whole inside the block, and as before after it
        (collective: every rank enters it)."""
        before = set(self.gathered)
        self.gather_all()
        try:
            yield
        finally:
            for key in set(self.groups) - before:
                self.free(key)

    @contextlib.contextmanager
    def in_step(self):
        """The step's forward and backward (see the class)."""
        self.gather(self.REST)
        self.active = True
        try:
            yield
        finally:
            self.active = False
            self.free_all()

    def full(self, n: str) -> torch.Tensor:
        """Parameter n whole, in a new tensor (collective)."""
        p = self.params[n]
        out = torch.empty(p.shape, dtype=p.dtype, device=p.device)
        self.assemble(n, self.shards[n], out)
        return out

    @torch.no_grad()
    def load_full(self, n: str, full: torch.Tensor) -> None:
        """Set parameter n from its whole value (every rank keeps its slice)."""
        self.shards[n].copy_(self.plan[n].local(full.to(self.shards[n].device), self.rank))

    # the decoder's hooks around block i
    def enter(self, i: int, h: torch.Tensor) -> torch.Tensor:
        if not self.active or i not in self.groups:
            return h
        self.gather(i)
        return _FreeAfterBackward.apply(h, self, i) if h.requires_grad else h

    def leave(self, i: int, h: torch.Tensor) -> torch.Tensor:
        if not self.active or i not in self.groups:
            return h
        self.free(i)
        return _GatherBeforeBackward.apply(h, self, i) if h.requires_grad else h
