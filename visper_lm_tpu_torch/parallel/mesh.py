"""The process grid (counterpart of visper_lm_tpu/parallel/mesh.py).

JAX builds one `jax.sharding.Mesh` over devices and lets XLA place every
collective. The port runs one process per device and writes its collectives
itself (parallel/distributed.py), so its mesh is a plain description of the
grid: the axis names in JAX's order ('data', 'pipe', 'expert', 'seq',
'model'), the size of each, and each rank's coordinates. There is no device
array and no `mesh_utils`.

Every axis of JAX's mesh is here, in JAX's order: 'model' innermost (the
tp ranks of one data group are consecutive), then 'seq', 'expert' (expert
parallelism, ops/moe.py) and 'pipe', 'data' outermost.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"

@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process grid: `ranks` holds the rank at each coordinate, in the
    shape of the axes `axis_names`."""

    axis_names: Tuple[str, ...]
    ranks: np.ndarray

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as JAX's `mesh.shape`."""
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def data_size(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def model_size(self) -> int:
        return self.shape[MODEL_AXIS]

    def coords(self, rank: int) -> Dict[str, int]:
        """{axis name: index} of `rank` in the grid."""
        where = np.argwhere(self.ranks == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh {self.shape}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    @property
    def seq_size(self) -> int:
        return self.shape.get(SEQ_AXIS, 1)

    @property
    def pipe_size(self) -> int:
        return self.shape.get(PIPE_AXIS, 1)

    @property
    def expert_size(self) -> int:
        return self.shape.get(EXPERT_AXIS, 1)

    def axis_group_ranks(self, rank: int, axis: str) -> Tuple[int, ...]:
        """The ranks that share `rank`'s coordinates but for `axis`, in that
        axis's order (`rank` alone when the mesh has no such axis)."""
        c = self.coords(rank)
        if axis not in c:
            return (int(rank),)
        index = tuple(slice(None) if a == axis else c[a] for a in self.axis_names)
        return tuple(int(r) for r in self.ranks[index].reshape(-1))

    def data_group_ranks(self, rank: int) -> Tuple[int, ...]:
        """The ranks that share `rank`'s coordinates but for the data axis
        (its data-parallel group), in data order."""
        return self.axis_group_ranks(rank, DATA_AXIS)

    def model_group_ranks(self, rank: int) -> Tuple[int, ...]:
        """The ranks that share `rank`'s coordinates but for the model axis
        (its tensor-parallel group), in model order."""
        return self.axis_group_ranks(rank, MODEL_AXIS)

    def seq_group_ranks(self, rank: int) -> Tuple[int, ...]:
        """The ranks that share `rank`'s coordinates but for the seq axis
        (its sequence-parallel group), in seq order."""
        return self.axis_group_ranks(rank, SEQ_AXIS)

    def pipe_group_ranks(self, rank: int) -> Tuple[int, ...]:
        """The ranks that share `rank`'s coordinates but for the pipe axis
        (its pipeline: stage 0 first)."""
        return self.axis_group_ranks(rank, PIPE_AXIS)

    def expert_group_ranks(self, rank: int) -> Tuple[int, ...]:
        """The ranks that share `rank`'s coordinates but for the expert axis
        (its expert-parallel group: the same tokens, each its experts)."""
        return self.axis_group_ranks(rank, EXPERT_AXIS)

    def routing_group_ranks(self, rank: int) -> Tuple[int, ...]:
        """The ranks that share `rank`'s coordinates but for the data and
        seq axes (the rows of one global batch, which a MoE layer routes
        over together), data-major: group rank d·sp + s holds data shard d,
        seq rows s."""
        c = self.coords(rank)
        index = tuple(slice(None) if a in (DATA_AXIS, SEQ_AXIS) else c[a] for a in self.axis_names)
        return tuple(int(r) for r in self.ranks[index].reshape(-1))


def make_mesh(
    dp: Optional[int] = None,
    tp: int = 1,
    world: Optional[int] = None,
    sp: int = 1,
    pp: int = 1,
    ep: int = 1,
) -> Mesh:
    """The ('data', 'model') grid over `world` processes (default: the
    runtime's process count), gaining a 'pipe' axis when pp > 1, an
    'expert' axis when ep > 1 and a 'seq' axis when sp > 1, with JAX's axis
    order and rules: dp defaults to world // (pp * tp * sp * ep), the grid
    takes the first dp * pp * tp * sp * ep ranks, and JAX's assertion fires
    when there are fewer."""
    if world is None:
        from visper_lm_tpu_torch.parallel.distributed import process_count

        world = process_count()
    if dp is None:
        dp = world // (pp * tp * sp * ep)
    n = min(world, dp * pp * tp * sp * ep)
    assert dp * pp * sp * ep * tp == n, (
        f"dp({dp}) * pp({pp}) * sp({sp}) * ep({ep}) * tp({tp}) "
        f"!= available devices({n})"
    )
    shape, axes = [dp], [DATA_AXIS]
    for size, axis in ((pp, PIPE_AXIS), (ep, EXPERT_AXIS), (sp, SEQ_AXIS)):
        if size > 1:
            shape.append(size)
            axes.append(axis)
    shape.append(tp)
    axes.append(MODEL_AXIS)
    return Mesh(tuple(axes), np.arange(n).reshape(tuple(shape)))


def single_device_mesh() -> Mesh:
    return make_mesh(dp=1, tp=1, world=1)
