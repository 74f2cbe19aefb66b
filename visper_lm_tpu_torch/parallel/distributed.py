"""The multi-process runtime (counterpart of visper_lm_tpu/parallel/distributed.py).

JAX starts one process per host with `jax.distributed.initialize`, builds
one global mesh, and XLA inserts every collective into the compiled step.
The port runs one process per device on `torch.distributed` and writes the
step's collectives itself; they are all here:

  * `init_distributed` once per process (idempotent). With no argument and
    none of the environment variables below it does nothing: one process.
    The backend is explicit: NCCL where the process's device is CUDA, gloo
    on the CPU, or the `backend` argument (two processes that share one card
    cannot use NCCL, which refuses two ranks on one GPU: they take gloo);
  * each process feeds its own shard of the global batch
    (`shard_batch_multihost`): there is no global array, and the losses
    divide by counts summed over the ranks (train/losses.py). The batch is
    split over the data axis only: the shard is the one of the process's
    DATA coordinate (`data_shard`), so the tensor-parallel ranks of one
    data group read the same rows;
  * the process groups of the mesh's axes: `data_group` (the ranks that
    differ only in their data coordinate), `model_group` (only in their
    model coordinate: a tensor-parallel group), `seq_group` (a
    sequence-parallel group), `pipe_group` (a pipeline's stages),
    `expert_group` (the ranks that hold the same tokens and split the
    experts) and `routing_group` (the data x seq ranks: one global batch's
    rows, which a MoE layer routes over), made once per set of ranks;
  * the collectives the step needs: `all_reduce` (a sum or a max), `reduce_scatter` and
    `all_gather` along a dim, `all_gather_autograd` (gradients flow back,
    summed over the ranks), `all_reduce_autograd` (every rank's loss reads
    the sum), `broadcast` and `reduce`, and the two
    operators of tensor parallelism, `copy_to_group` (identity forward,
    all-reduced gradient) and `reduce_from_group` (all-reduce forward,
    identity backward); for sequence parallelism `all_to_all` (split one
    dim over the ranks, concatenate another: JAX's tiled
    `lax.all_to_all`, with `all_to_all_autograd` whose backward is the
    inverse exchange) and `ring_shift` (every rank's tensor to the next
    rank of the group, JAX's `ppermute` one hop, with its autograd form);
    for pipeline parallelism `send` / `recv` to a neighbour (`p2p_sends`
    counts the sends). Where a backend does
    not run a collective on CUDA tensors, the collective is staged through
    page-locked host memory; `BACKENDS` says which, by the backend's name.

Environment variables honoured (as JAX's):
  VISPER_COORDINATOR        "host:port" of process 0
  VISPER_NUM_PROCESSES, VISPER_PROCESS_ID
  VISPER_AUTO_DISTRIBUTED=1 take them from the launcher instead: torchrun's
                            RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT (and
                            LOCAL_RANK for the device); JAX's counterpart
                            reads a TPU pod's metadata
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from visper_lm_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh

# process groups made so far, by their ranks (every process makes every group
# of an axis in the same order, once)
_groups: Dict[Tuple[int, ...], Any] = {}

# backend -> whether it runs collectives on CUDA tensors (else each is
# staged through host memory)
BACKENDS: Dict[str, bool] = {"nccl": True, "gloo": False}

_state: Dict[str, Any] = dict(initialized=False, local_index=None)


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One rank's group on a mesh axis, as the model's layers hold it: the
    process group (None: every process), the rank's index in it and its
    size. `AxisGroup(*model_group(mesh))` is a tensor-parallel group
    (parallel/tensor.TensorParallel), `AxisGroup(*expert_group(mesh))` an
    expert-parallel one, `routing_group(mesh)` the data x seq group a MoE
    layer routes over (ops/moe.py). A group over two axes counts its ranks
    outer-major: `inner` is the inner axis's size (the seq axis's in the
    routing group; 1 for a group of one axis)."""

    group: Any
    rank: int
    size: int
    inner: int = 1


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    *,
    device: Optional[str] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (idempotent). Arguments win over VISPER_*;
    with neither (and no VISPER_AUTO_DISTRIBUTED=1) this is a no-op.
    local_device_ids[0]: this process's CUDA device index (default
    LOCAL_RANK, else the rank modulo the devices present). device: where
    the process computes, which picks the default backend (NCCL for CUDA,
    gloo for the CPU); backend overrides it."""
    if _state["initialized"] or dist.is_initialized():
        _state["initialized"] = True
        return
    coordinator_address = coordinator_address or os.environ.get("VISPER_COORDINATOR")
    env_np = os.environ.get("VISPER_NUM_PROCESSES")
    env_pid = os.environ.get("VISPER_PROCESS_ID")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if process_id is None and env_pid is not None:
        process_id = int(env_pid)
    explicit = coordinator_address is not None or num_processes is not None
    autodetect = os.environ.get("VISPER_AUTO_DISTRIBUTED") == "1"
    if not explicit and not autodetect:
        return
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError(
                "init_distributed needs the coordinator address, the number of processes and "
                f"this process's id (got {coordinator_address!r}, {num_processes}, {process_id})")
        address, world, rank = coordinator_address, int(num_processes), int(process_id)
    else:
        address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if local_device_ids:
        local = int(local_device_ids[0])
    elif "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
    else:
        local = rank % max(torch.cuda.device_count(), 1)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: the port knows {sorted(BACKENDS)}")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world, rank=rank)
    _state.update(initialized=True, local_index=local)


def free_port(host: str = "localhost") -> int:
    """A free port for a coordinator (rank 0's store, `init_distributed`'s
    address), below the kernel's ephemeral range (`ip_local_port_range`,
    32768-60999 by default). A port of that range can be handed to any
    `bind(port 0)` of another process (gloo's pair listeners, a client's
    socket) between this check and the store's own bind; a port below it
    is taken only by another explicit choice. A random one of those free
    now; bind(0) where the range leaves no room below it."""
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    pick = random.SystemRandom()
    for _ in range(64 if low > 2048 else 0):
        port = pick.randrange(max(1024, low // 2), low)
        with socket.socket() as s:
            try:
                s.bind((host, port))
            except OSError:
                continue
        return port
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def is_initialized() -> bool:
    return dist.is_initialized()


def shutdown() -> None:
    """Leave the process group (a no-op when there is none)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.update(initialized=False, local_index=None)
    _groups.clear()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """Rank-0 gate for logging and for writing files (JAX: process_index() == 0)."""
    return process_index() == 0


def local_device(device: Optional[str]) -> Optional[torch.device]:
    """The device this process computes on: `device` as given, but a bare
    "cuda" in a process group is this process's own card (init_distributed's
    local index). None stays None (the caller resolves it)."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        return torch.device("cuda", _state["local_index"] or 0)
    return dev


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def make_global_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1, pp: int = 1,
                     ep: int = 1) -> Mesh:
    """The ('data', ['pipe',] ['expert',] ['seq',] 'model') grid over every process."""
    return make_mesh(dp=dp, tp=tp, sp=sp, pp=pp, ep=ep, world=process_count())


def _axis_group(mesh: Mesh, ranks_of):
    """(process group, this process's rank in it, its size) of the axis
    whose groups `ranks_of(rank)` gives; the group is None (every process)
    when the axis spans them all. Every process takes part in creating every
    group of the axis, a process outside the mesh too (which then raises)."""
    if len(ranks_of(0)) < process_count():
        for r in range(mesh.size):
            key = ranks_of(r)
            if key not in _groups:
                _groups[key] = dist.new_group(list(key))
    ranks = ranks_of(process_index())
    if len(ranks) == process_count():
        return None, process_index(), len(ranks)
    return _groups[ranks], ranks.index(process_index()), len(ranks)


def data_group(mesh: Mesh):
    """(process group, this process's rank in it, its size) of the data axis
    this process sits on (the ranks with its model coordinate)."""
    return _axis_group(mesh, mesh.data_group_ranks)


def model_group(mesh: Mesh):
    """(process group, this process's rank in it, its size) of the model
    axis this process sits on: its tensor-parallel group (the ranks with its
    data coordinate)."""
    return _axis_group(mesh, mesh.model_group_ranks)


def seq_group(mesh: Mesh):
    """(process group, this process's rank in it, its size) of the seq axis
    this process sits on: its sequence-parallel group (the ranks with its
    data, pipe and model coordinates; the process alone without the axis)."""
    return _axis_group(mesh, mesh.seq_group_ranks)


def pipe_group(mesh: Mesh):
    """(process group, this process's rank in it: its stage, its size) of
    the pipe axis this process sits on (the process alone without the axis)."""
    return _axis_group(mesh, mesh.pipe_group_ranks)


def expert_group(mesh: Mesh):
    """(process group, this process's rank in it, its size) of the expert
    axis this process sits on: the ranks of its data, pipe, seq and model
    coordinates, which read the same rows (the process alone without the
    axis)."""
    return _axis_group(mesh, mesh.expert_group_ranks)


def routing_group(mesh: Mesh) -> Optional[AxisGroup]:
    """The group whose ranks hold the rows of one global batch between them:
    the data x seq ranks of this process's pipe, expert and model
    coordinates, data-major (`inner`: the seq size), as an `AxisGroup`; the
    group a MoE layer routes over (capacity, priority and aux of the global
    batch, ops/moe.py). None when both axes are 1 wide. Collective: every
    process makes every group."""
    if mesh.data_size * mesh.seq_size == 1:
        return None
    return AxisGroup(*_axis_group(mesh, mesh.routing_group_ranks), inner=mesh.seq_size)


def data_shard(mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """(index, count) of this process's shard of the global batch: its data
    coordinate and the data size (the tensor-parallel ranks of one data
    group read the same rows); without a mesh (process_index(),
    process_count())."""
    if mesh is None:
        return process_index(), process_count()
    return mesh.coords(process_index())[DATA_AXIS], mesh.data_size


def local_batch_size(global_batch_size: int, mesh: Optional[Mesh] = None) -> int:
    """Per-process share of a global batch (must divide evenly): over the
    mesh's data axis, or over every process without a mesh."""
    n = data_shard(mesh)[1]
    assert global_batch_size % n == 0, (
        f"global batch {global_batch_size} not divisible by {n} data shards"
    )
    return global_batch_size // n


class LocalBatch(dict):
    """A process's shard of the global batch, on its device, with the
    global batch size that the losses divide by."""

    global_batch_size: int = 0


def shard_batch_multihost(
    batch: Mapping[str, Any], mesh: Mesh, leading_accum: bool = False,
    device: Optional[torch.device] = None,
) -> LocalBatch:
    """Each process passes its LOCAL (local_batch, ...) shard, the rows of
    its data coordinate (`data_shard`; with a leading (accum_steps, ...)
    axis when leading_accum): its arrays go to `device` as they are, and
    the result records the global batch size, the local one times the
    mesh's data size. JAX assembles a global array here; the port never
    does."""
    from visper_lm_tpu_torch.parallel.sharding import batch_pspecs

    specs = batch_pspecs(batch, leading_accum=leading_accum)
    out = LocalBatch()
    local = None
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        axis = specs[k].index(DATA_AXIS) if DATA_AXIS in specs[k] else None
        if axis is not None:
            if local is None:
                local = t.shape[axis]
            elif t.shape[axis] != local:
                raise ValueError(f"batch[{k!r}] has {t.shape[axis]} rows on the batch axis, "
                                 f"the others {local}")
        out[k] = t if device is None else t.to(device)
    out.global_batch_size = (local or 0) * mesh.data_size
    return out


# ---------------------------------------------------------------------------
# collectives (group=None: every process)
# ---------------------------------------------------------------------------


def group_size(group=None) -> int:
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    return dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a collective on t goes through host memory (BACKENDS)."""
    return t.device.type == "cuda" and not BACKENDS[str(dist.get_backend(group)).lower()]


def _host(t: torch.Tensor) -> torch.Tensor:
    """A page-locked host copy of t (a copy through pageable memory runs at
    a tenth of the rate on an H100 host)."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """Sum (or with op="max" the largest of) t over the group, in place (t
    must be contiguous); returns t."""
    if _staged(t, group):
        host = _host(t)
        dist.all_reduce(host, op=_OPS[op], group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """t from group rank `src` to every rank, in place; returns t."""
    if _staged(t, group):
        host = _host(t)
        dist.broadcast(host, group=group, group_src=src)
        t.copy_(host)
    else:
        dist.broadcast(t, group=group, group_src=src)
    return t


def reduce(t: torch.Tensor, dst: int, group=None) -> torch.Tensor:
    """The sum of t over the group lands in t on group rank `dst` (in place;
    the others' t is left unspecified); returns t."""
    if _staged(t, group):
        host = _host(t)
        dist.reduce(host, group=group, group_dst=dst)
        t.copy_(host)
    else:
        dist.reduce(t, group=group, group_dst=dst)
    return t


def reduce_scatter(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The sum of t over the group, cut into equal slices along `dim`: this
    rank's slice (a new tensor)."""
    size = t.shape[dim] // group_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((size,) + tuple(x.shape[1:]), dtype=t.dtype, device=t.device)
    if _staged(t, group):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(host, _host(x), group=group)
        out.copy_(host)
    else:
        dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def all_gather(t: torch.Tensor, dim: int, group=None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every rank's equal slice t concatenated along `dim`, in rank order;
    into `out` when given. Layout work stays on t's device: only contiguous
    bytes cross to the host where the collective is staged."""
    n = group_size(group)
    shape = list(t.shape)
    shape[dim] *= n
    if out is None:
        out = torch.empty(shape, dtype=t.dtype, device=t.device)
    src = t.movedim(dim, 0).contiguous()
    staged = _staged(t, group)
    if staged:
        src = _host(src)
    # the ranks' parts one after another along dim 0 (gloo takes no other layout)
    flat = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=t.dtype,
                       device=src.device, pin_memory=staged)
    dist.all_gather_into_tensor(flat, src, group=group)
    if staged:
        flat = flat.to(t.device)
    # part k, (size, *shape[:dim], *shape[dim + 1:]), lands at index k of out
    # viewed as (pre, n, size, post) along dim
    pre = int(np.prod(shape[:dim], dtype=np.int64))
    post = int(np.prod(shape[dim + 1:], dtype=np.int64))
    size = t.shape[dim]
    out.view(pre, n, size, post).copy_(flat.view(n, size, pre, post).permute(2, 0, 1, 3))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(t.contiguous(), dim, group)

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reads the gathered tensor: this rank's slice's
        # gradient is the sum of the ranks' gradients of that slice
        return reduce_scatter(g.contiguous(), ctx.dim, ctx.group), None, None


def all_gather_autograd(t: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """`all_gather` through which gradients flow back, summed over the ranks."""
    return _AllGather.apply(t, dim, group)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient backward (a
    column-parallel layer's input: each rank's dX is a partial sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward; identity backward (a row-parallel layer's
    output: the ranks' partial sums added; every rank's loss reads the sum,
    and each rank's gradient of it is the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """x as it is; its gradient summed over the group (Megatron's `f`)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group; its gradient as it is (Megatron's `g`)."""
    return _ReduceFromGroup.apply(x, group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reads the sum: a rank's gradient of its summand
        # is the sum of the ranks' gradients of the sum
        return all_reduce(g.contiguous().clone(), ctx.group), None


def all_reduce_autograd(t: torch.Tensor, group=None) -> torch.Tensor:
    """t summed over the group (a new tensor); its gradient the sum of the
    ranks' gradients of the sum."""
    return _AllReduce.apply(t, group)


def all_reduce_scalars(values: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Sum each 0-d tensor over the group in one collective (f32 on their device)."""
    if not values:
        return []
    stacked = torch.stack([v.detach().float().reshape(()) for v in values])
    all_reduce(stacked, group)
    return list(stacked.unbind(0))


# ---------------------------------------------------------------------------
# sequence and pipeline parallelism: all-to-all, ring shift, point to point
# ---------------------------------------------------------------------------

# point-to-point sends made so far (`send`, `ring_shift`): a pipeline that
# engaged moved activations between stages
p2p_sends = 0


def _global(group, group_rank: int) -> int:
    return group_rank if group is None else dist.get_global_rank(group, group_rank)


def all_to_all(t: torch.Tensor, split_dim: int, concat_dim: int, group=None) -> torch.Tensor:
    """JAX's tiled `lax.all_to_all`: t cut into the group's size of equal
    slices along `split_dim`, slice j sent to group rank j, and the slices
    received concatenated along `concat_dim` in rank order (a new tensor).
    Layout work stays on t's device; a staged backend moves contiguous bytes."""
    n = group_size(group)
    if n == 1:
        return t.clone()
    src = torch.stack(t.chunk(n, split_dim), 0).contiguous()
    staged = _staged(t, group)
    out = torch.empty(src.shape, dtype=t.dtype, device="cpu" if staged else t.device,
                      pin_memory=staged)
    dist.all_to_all_single(out, _host(src) if staged else src, group=group)
    if staged:
        out = out.to(t.device)
    return torch.cat(out.unbind(0), concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return all_to_all(t, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        # the exchange's transpose: the inverse all-to-all
        split_dim, concat_dim = ctx.dims
        return all_to_all(g.contiguous(), concat_dim, split_dim, ctx.group), None, None, None


def all_to_all_autograd(t: torch.Tensor, split_dim: int, concat_dim: int,
                        group=None) -> torch.Tensor:
    """`all_to_all` through which gradients flow back by the inverse exchange."""
    return _AllToAll.apply(t, split_dim, concat_dim, group)


def broadcast_object(obj: Any, src: int, group=None) -> Any:
    """A picklable object (host tensors in it) from group rank `src` to
    every rank of the group; returns it."""
    objs = [obj]
    dist.broadcast_object_list(objs, src=_global(group, src), group=group)
    return objs[0]


def send(t: torch.Tensor, dst: int, group=None) -> None:
    """t to group rank `dst` (blocking; staged through host memory where the
    backend needs it)."""
    global p2p_sends
    p2p_sends += 1
    dist.send(_host(t.contiguous()) if _staged(t, group) else t.contiguous(),
              _global(group, dst), group=group)


def recv(shape, dtype: torch.dtype, device, src: int, group=None) -> torch.Tensor:
    """A tensor of `shape` / `dtype` from group rank `src`, on `device`."""
    dev = torch.device(device)
    staged = dev.type == "cuda" and not BACKENDS[str(dist.get_backend(group)).lower()]
    out = torch.empty(tuple(shape), dtype=dtype, device="cpu" if staged else dev,
                      pin_memory=staged)
    dist.recv(out, _global(group, src), group=group)
    return out.to(dev) if staged else out


def ring_shift(t: torch.Tensor, group=None, hop: int = 1) -> torch.Tensor:
    """Every rank's t to group rank (r + hop) mod n; returns what rank
    (r - hop) mod n sent (JAX's `ppermute` around the ring)."""
    global p2p_sends
    n = group_size(group)
    if n == 1:
        return t.clone()
    r = group_rank(group)
    staged = _staged(t, group)
    src = _host(t.contiguous()) if staged else t.contiguous()
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu" if staged else t.device,
                      pin_memory=staged)
    ops = [dist.P2POp(dist.isend, src, _global(group, (r + hop) % n), group),
           dist.P2POp(dist.irecv, out, _global(group, (r - hop) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    p2p_sends += 1
    return out.to(t.device) if staged else out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, hop):
        ctx.group, ctx.hop = group, hop
        return ring_shift(t, group, hop)

    @staticmethod
    def backward(ctx, g):
        # the transpose of a shift is the shift the other way
        return ring_shift(g.contiguous(), ctx.group, -ctx.hop), None, None


def ring_shift_autograd(t: torch.Tensor, group=None, hop: int = 1) -> torch.Tensor:
    """`ring_shift` through which gradients flow back around the ring."""
    return _RingShift.apply(t, group, hop)
