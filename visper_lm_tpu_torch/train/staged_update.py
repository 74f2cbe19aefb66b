"""AdamW with its state offloaded to host memory and a blockwise-staged update
(counterpart of visper_lm_tpu/train/staged_update.py).

`OffloadedAdamW` keeps every moment (and master) tensor of at least
`min_bytes` in one page-locked host pool (`device.HostPool`); smaller ones
(norm scales, biases) stay on the card beside the parameters. The update is
`adam_leaf_update`, the on-card `AdamW`'s, so both give the same bytes; only
where the state lives differs:

  * `plan_offload_layout` decides, from the shape alone, each offloaded
    tensor's row blocks: a tensor whose f32-equivalent bytes exceed
    `block_bytes` is split along axis 0 into ceil(bytes / block_bytes) row
    ranges, so mu, nu and master of one parameter share their boundaries.
    A block is a `narrow` view of the tensor: there is one layout, whatever
    the blocks (JAX's ChunkedHostArray / StackedHostArray exist so that XLA
    can stage a block; `scan_chunks` only makes the blocks uniform, as
    JAX's stacked layout does);
  * `blockwise_staged_update` first takes each lr group's global norm
    (`AdamW.norm_pass`). Streamed gradients come with their sums of
    squares, taken on the card before they left, so each crosses the host
    link once, in the update loop (JAX stages them in for the norm too, and
    keeps the first 256 MiB staged for the loop; here there is nothing to
    keep); a host gradient without its sum is staged in for it, one at a
    time. Then it runs each
    block: mu, nu, master and the gradient come in on a
    host-to-device stream, the update runs in f32 on the card on the step's
    stream, and the new mu, nu and master go back on a device-to-host
    stream. Two slots of device buffers alternate, ordered by CUDA events:
    block k+1 comes in while block k computes and block k-1 goes out, and at
    most two blocks of state are on the card (JAX's token chain);
  * `blockwise=False` plans JAX's whole-tree staging layout, every tensor
    one block (JAX keeps it as a compile A/B); the same loop runs it.

Under a zero plan (data parallelism, `AdamW`'s `zero`, and tensor
parallelism with it) each rank offloads only its own slices: the layout is
JAX's on the whole shapes and the specs (`offload_shapes`): a tensor is
offloaded only where its spec splits it over every axis larger than 1
(`covers_mesh`), and cut into row blocks only where no axis splits its dim
0 (`axis0_unsharded`), so the blocks are rows of each rank's slice; the
gradients are summed over the ranks before the norm pass, and the updated
slices are gathered into the parameters after the loop. Under sequence or
pipeline parallelism no spec covers the 'seq' or 'pipe' axis, so every
tensor stays on the card (JAX's plan, ROADMAP C32); the update, the seq sum
and the stages' global norm are `AdamW`'s (`foreign`: the blocks other
stages hold). Under expert parallelism a bank's spec names 'expert' on its
experts' dim, so a rank offloads its E/ep slice of a bank's moments whole
(one block: dim 0 is split) where the spec covers the mesh; the norm adds
the banks' shares over the expert group, as `AdamW`'s does.

On the CPU the "host" tensors are ordinary CPU tensors and every copy is the
identity, as JAX's host put is a no-op off the TPU: the blocks are updated
in place, which is the math under test. A checkpoint of this state has the
on-card AdamW's names, dtypes and bytes (`state_tensors`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch

from visper_lm_tpu_torch.device import HostPool
from visper_lm_tpu_torch.train.optimizer import AdamW, OptimizerConfig, adam_leaf_update

# None: on the card; a tuple of row ranges: on the host in those blocks;
# the empty tuple: on the host, the whole tensor one block
Placement = Optional[Tuple[Tuple[int, int], ...]]


def _numel(shape: Sequence[int]) -> int:
    return math.prod(int(d) for d in shape)


def _axes(entry) -> Tuple[Any, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def covers_mesh(spec: Sequence[Any], axis_sizes: Mapping[str, int]) -> bool:
    """JAX `_covers_mesh`: the spec splits over every axis larger than 1 (no
    replication: a replicated leaf stays on the card)."""
    used = {a for e in spec for a in _axes(e) if a is not None}
    return {a for a, n in axis_sizes.items() if n > 1} <= used


def axis0_unsharded(spec: Sequence[Any], axis_sizes: Mapping[str, int]) -> bool:
    """JAX `_axis0_unsharded`: no axis larger than 1 splits dim 0 (the row
    blocks of a leaf are the same rows on every rank)."""
    return not spec or all(a is None or axis_sizes.get(a, 1) <= 1 for a in _axes(spec[0]))


def plan_offload_layout(
    shapes: Mapping[str, Tuple[Sequence[int], torch.dtype]], *,
    block_bytes: int = 256 << 20, min_bytes: int = 1 << 20,
    chunk: bool = True, scan_chunks: bool = False,
    specs: Optional[Mapping[str, Sequence[Any]]] = None,
    axis_sizes: Optional[Mapping[str, int]] = None,
) -> Dict[str, Placement]:
    """{state key: (WHOLE shape, dtype)} -> {state key: placement} (JAX
    `plan_offload_layout`). A tensor of fewer than `min_bytes`, or whose spec
    (`specs`, by key; none: replicated) does not split it over every axis of
    `axis_sizes` larger than 1, stays on the card. An offloaded one whose
    f32-equivalent bytes exceed `block_bytes` (with more than one row, and
    dim 0 split by no axis) gets ceil(bytes / block_bytes) row ranges; with
    `scan_chunks` the smallest count at least that which divides the rows
    (uniform blocks); chunk=False keeps every tensor whole (JAX's whole-tree
    staging layout). Dim 0 being whole on every rank, the ranges are rows
    of each rank's slice too."""
    specs, axis_sizes = specs or {}, axis_sizes or {}
    out: Dict[str, Placement] = {}
    for key, (shape, dtype) in shapes.items():
        shape = tuple(int(d) for d in shape)
        spec = tuple(specs.get(key, ()))
        if (_numel(shape) * torch.empty((), dtype=dtype).element_size() < min_bytes
                or not covers_mesh(spec, axis_sizes)):
            out[key] = None
            continue
        nbytes = _numel(shape) * 4
        n_rows = shape[0] if len(shape) > 1 else 1
        if (not chunk or nbytes <= block_bytes or n_rows <= 1
                or not axis0_unsharded(spec, axis_sizes)):
            out[key] = ()
            continue
        n = min(n_rows, math.ceil(nbytes / block_bytes))
        if scan_chunks:
            n = next(k for k in range(n, n_rows + 1) if n_rows % k == 0)
        out[key] = tuple((i * n_rows // n, (i + 1) * n_rows // n) for i in range(n))
    return out


def offload_shapes(params: Mapping[str, torch.Tensor], mu_dtype: torch.dtype, master: bool,
                   zero=None) -> Tuple[Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                                       Dict[str, Tuple[Any, ...]], Dict[str, int]]:
    """What `plan_offload_layout` plans an optimizer's state on: ({state
    key: (whole shape, dtype)}, {state key: spec}, the mesh's axis sizes)
    of the moments (and masters) of `params` (tp-local tensors under a zero
    plan with tensor parallelism, a MoE bank the rank's experts under expert
    parallelism). The axis sizes are the mesh's 'data', 'model', 'seq',
    'pipe' and 'expert': no spec names 'seq' or 'pipe' (JAX's parameter
    rules split no parameter over them), so on a mesh where either is wider
    than 1 every state tensor stays on the card, as JAX's `_covers_mesh`
    plans it (ROADMAP C32); only a bank's spec names 'expert', so where that
    axis is wider than 1 only the banks' moments can go to the host (those
    whose spec also names every other axis wider than 1)."""
    shapes, specs = {}, {}
    for n, p in params.items():
        pl = None if zero is None else zero.moments[n]
        whole = tuple(p.shape) if pl is None else pl.whole_shape(p.shape)
        kinds = [("mu", mu_dtype), ("nu", p.dtype)] + ([("master", torch.float32)] if master else [])
        for kind, dtype in kinds:
            shapes[f"{kind}/{n}"] = (whole, dtype)
            specs[f"{kind}/{n}"] = () if pl is None else pl.spec(len(whole))
    axis_sizes = {} if zero is None else {
        "data": zero.size, "model": _size(zero.tp), "seq": _size(zero.seq),
        "pipe": _size(zero.pipe), "expert": _size(zero.ep)}
    return shapes, specs, axis_sizes


def _size(group) -> int:
    return 1 if group is None else group.size


def _blocks(placement: Placement) -> Iterator[Tuple[Optional[int], Optional[int]]]:
    """(start, end) row ranges, or one (None, None) for the whole tensor."""
    if not placement:
        yield None, None
    else:
        yield from placement


def _rows(t: Optional[torch.Tensor], s: Optional[int], e: Optional[int]) -> Optional[torch.Tensor]:
    if t is None or s is None:
        return t
    return t.narrow(0, s, e - s)


def chunk_state_like(tensors: Mapping[str, torch.Tensor],
                     plan: Mapping[str, Placement]) -> Dict[str, List[torch.Tensor]]:
    """A `state_tensors` dict as its blocks: {key: [row-block views]} (JAX
    `chunk_state_like`; a whole tensor is one block). Views, no copies."""
    return {k: [_rows(t, s, e) for s, e in _blocks(plan.get(k))] for k, t in tensors.items()}


def unchunk_state(chunked: Mapping[str, Sequence[torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Blocks concatenated back into whole tensors (JAX `unchunk_state`)."""
    return {k: v[0] if len(v) == 1 else torch.cat(list(v), 0) for k, v in chunked.items()}


class OffloadedAdamW(AdamW):
    """`AdamW` whose moments and master weights live in host memory where
    `plan_offload_layout` says, updated by `blockwise_staged_update`
    (blockwise=False: every tensor one block). Same constructor and checkpoint
    API as `AdamW`, plus the layout's knobs; `device` is where the
    parameters and the update are."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], cfg: OptimizerConfig, *,
                 block_bytes: int = 256 << 20, min_bytes: int = 1 << 20, scan_chunks: bool = False,
                 blockwise: bool = True, zero=None, sharded=None,
                 foreign: Optional[Dict[str, torch.Tensor]] = None):
        self.block_bytes, self.min_bytes = block_bytes, min_bytes
        self.scan_chunks, self.blockwise = scan_chunks, blockwise
        super().__init__(named_params, cfg, zero=zero, sharded=sharded, foreign=foreign)

    def init_state(self) -> None:
        """JAX `init_opt_state_offloaded`: host zeros in one pool, the
        master copies cast from the parameters a block at a time; nothing of
        the whole moment tree is allocated on the card."""
        self.device = next(iter(self.params.values())).device
        whole, specs, axis_sizes = offload_shapes(self.params, self.mu_dtype,
                                                  self.cfg.master_weights, self.zero)
        self.plan = plan_offload_layout(whole, block_bytes=self.block_bytes,
                                        min_bytes=self.min_bytes, chunk=self.blockwise,
                                        scan_chunks=self.scan_chunks, specs=specs,
                                        axis_sizes=axis_sizes)
        shapes = {k: (self.local_shape(k.split("/", 1)[1]), dtype)
                  for k, (_, dtype) in whole.items()}
        on_host = {k: s for k, s in shapes.items() if self.plan[k] is not None}
        self.pool = HostPool(sum(HostPool.size_of(*s) for s in on_host.values()), self.device)
        state: Dict[str, torch.Tensor] = {}
        for key, (shape, dtype) in shapes.items():
            if key in on_host:
                state[key] = self.pool.take(shape, dtype)
            else:
                state[key] = torch.zeros(shape, dtype=dtype, device=self.device)
        self.mu = {n: state[f"mu/{n}"] for n in self.params}
        self.nu = {n: state[f"nu/{n}"] for n in self.params}
        self.master = None
        if self.cfg.master_weights:
            self.master = {n: state[f"master/{n}"] for n in self.params}
            with torch.no_grad():
                for n in self.params:
                    p = self.local_param(n)
                    for s, e in _blocks(self.plan[f"master/{n}"]):
                        _rows(self.master[n], s, e).copy_(_rows(p, s, e).float())
            self._full.clear()
        cuda = self.device.type == "cuda"
        self._h2d = torch.cuda.Stream(self.device) if cuda else None
        self._d2h = torch.cuda.Stream(self.device) if cuda else None
        self._slots: List[Dict[str, torch.Tensor]] = []
        self._slot_free: List[Optional[torch.cuda.Event]] = [None, None]

    @property
    def host_bytes(self) -> int:
        return self.pool.nbytes

    def _settle(self) -> None:
        """Wait for every copy in flight (before the host reads or writes the state)."""
        if self._d2h is not None:
            self._d2h.synchronize()
            self._h2d.synchronize()

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        self._settle()
        return super().state_tensors()

    def load_state_tensors(self, tensors: Dict[str, torch.Tensor], count: int) -> None:
        self._settle()
        super().load_state_tensors(tensors, count)
        if self._d2h is not None:
            torch.cuda.current_stream(self.device).synchronize()

    def step(self, grads: Dict[str, torch.Tensor],
             sumsq: Optional[Dict[str, torch.Tensor]] = None,
             reduced: Iterable[str] = ()) -> torch.Tensor:
        return blockwise_staged_update(self, grads, sumsq, reduced)


def _block_bytes(t: torch.Tensor, s: Optional[int], e: Optional[int]) -> int:
    n = t.numel() if s is None else (e - s) * (t.numel() // t.shape[0])
    return n * t.element_size()


def _slots(opt: OffloadedAdamW, names: List[str], grads: Mapping[str, torch.Tensor]):
    """Two sets of device buffers, each as large as the largest block of mu,
    nu, master and of a host gradient (bytes, carved per block)."""
    need = {"mu": 0, "nu": 0, "master": 0, "g": 0}
    for n in names:
        state = {"mu": opt.mu[n], "nu": opt.nu[n],
                 "master": None if opt.master is None else opt.master[n]}
        for kind, t in state.items():
            if t is not None and opt.plan[f"{kind}/{n}"] is not None:
                for s, e in _blocks(opt.plan[f"{kind}/{n}"]):
                    need[kind] = max(need[kind], _block_bytes(t, s, e))
        g = grads[n]
        if g.device != opt.device:
            for s, e in _blocks(_placement(opt, n)):
                need["g"] = max(need["g"], _block_bytes(g, s, e))
    have = opt._slots[0] if opt._slots else {}
    if any(k not in have or have[k].numel() < v for k, v in need.items()):
        opt._settle()                       # no copy may still use the old buffers
        opt._slots = [{k: torch.empty(v, dtype=torch.uint8, device=opt.device) for k, v in need.items()}
                      for _ in range(2)]
    return opt._slots


def _placement(opt: OffloadedAdamW, n: str) -> Placement:
    """The blocks of parameter n's update: those of its offloaded state
    (mu, nu and master share them), else the whole tensor."""
    for kind in ("mu", "nu", "master"):
        placement = opt.plan.get(f"{kind}/{n}")
        if placement:
            return placement
    return None


def _carve(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf[:like.numel() * like.element_size()].view(like.dtype).view(like.shape)


@torch.no_grad()
def blockwise_staged_update(
    opt: OffloadedAdamW, grads: Dict[str, torch.Tensor],
    sumsq: Optional[Dict[str, torch.Tensor]] = None, reduced: Iterable[str] = (),
) -> torch.Tensor:
    """One update of `opt` from {name: grad} (on the card, or on the host
    from gradient streaming, with their sums in `sumsq`), streaming the
    offloaded state through the card block by block. Returns the global
    norm (f32), as `AdamW.step` does."""
    names = opt.trained()
    opt.reduce_grads(names, grads, reduced)
    clips, total = opt.norm_pass(names, grads, sumsq)
    opt.count += 1
    cuda = opt.device.type == "cuda"
    compute = torch.cuda.current_stream(opt.device) if cuda else None
    slots = _slots(opt, names, grads) if cuda else None
    if cuda:
        opt._h2d.wait_stream(compute)       # the gradients and parameters are ready
    k = 0
    for n in names:
        p, g = opt.local_param(n), grads[n]
        master = None if opt.master is None else opt.master[n]
        kw = opt.leaf_kwargs(n, clips)
        for s, e in _blocks(_placement(opt, n)):
            host = {kind: _rows(t, s, e) for kind, t in (("mu", opt.mu[n]), ("nu", opt.nu[n]),
                                                         ("master", master))
                    if t is not None}
            gb = _rows(g, s, e)
            staged = [kind for kind, t in host.items() if cuda and t.device.type == "cpu"]
            uses_slot = cuda and (bool(staged) or gb.device != opt.device)
            dev = dict(host)
            if uses_slot:
                slot = slots[k % 2]
                if opt._slot_free[k % 2] is not None:
                    opt._h2d.wait_event(opt._slot_free[k % 2])
                with torch.cuda.stream(opt._h2d):
                    for kind in staged:
                        dev[kind] = _carve(slot[kind], host[kind]).copy_(host[kind], non_blocking=True)
                    if gb.device != opt.device:
                        gb = _carve(slot["g"], gb).copy_(gb, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(opt._h2d)
                compute.wait_event(ready)
            adam_leaf_update(_rows(p, s, e), gb, dev["mu"], dev["nu"], dev.get("master"),
                             opt.cfg, **kw)
            if uses_slot:
                done = torch.cuda.Event()
                done.record(compute)
                opt._d2h.wait_event(done)
                with torch.cuda.stream(opt._d2h):
                    for kind in staged:
                        host[kind].copy_(dev[kind], non_blocking=True)
                    free = torch.cuda.Event()
                    free.record(opt._d2h)
                opt._slot_free[k % 2] = free
                k += 1
    if cuda:
        # the next step's first reads of the host state come after these writes
        opt._h2d.wait_stream(opt._d2h)
    opt.publish(names)
    return total
