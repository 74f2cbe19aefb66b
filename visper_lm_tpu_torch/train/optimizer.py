"""Optimizer: AdamW with per-group learning rates and stage freeze policies
(counterpart of visper_lm_tpu/train/optimizer.py).

The stage policies are the JAX package's regexes, matched on JAX-style paths
built from the port's parameter names (`jax_path`). The update is optax's
chain (clip_by_global_norm -> scale_by_adam -> add_decayed_weights ->
scale_by_learning_rate -> apply_updates) in plain torch ops, in place, one
tensor at a time in `adam_leaf_update`, which the on-card `AdamW` and the
offloaded update (train/staged_update.py) share:

  * the learning rate of update n (0-based) is schedule(n): a linear warmup
    from 0 over max(int(warmup_ratio * total_steps), 1) steps, then a cosine
    to 0, so the FIRST update has lr 0, even with warmup_ratio 0;
  * clipping by the global norm has no epsilon (unlike `clip_grad_norm_`),
    and each lr group (base / projector / vision) is clipped by its own
    norm, as optax.multi_transform runs one chain per group;
  * the first moment is kept in `mu_dtype`, the second in the parameter's
    dtype, as optax's `scale_by_adam` keeps them (bf16 for a bf16 parameter:
    6 bytes a trainable with an f32 first moment);
  * what optax computes in the parameter's dtype is computed in it here,
    each op rounding as its does: the clipped gradient, the second moment,
    its bias correction, root and epsilon, the global norm's per-leaf sums
    and their adds. Python constants take the other operand's dtype, as
    optax's weakly typed scalars do (bf16(0.9) = 0.8984375, bf16(0.999) =
    1). The first moment, the quotient and the step are f32 where mu is,
    with 1 / bc1 folded into the step; the bias corrections 1 - b^n are f32.
    On bf16 parameters this lands within an ulp of optax's jitted update
    (tests/test_torch_staged_update.py states the bound);
  * with `master_weights` (JAX `with_master_weights`, last in the chain) the
    update goes to an f32 copy of each trainable instead, and the parameter
    becomes that copy rounded to its dtype. (JAX emits the delta
    round(master) - p in the parameter's dtype, which rounds where a
    parameter crosses zero by more than its own size: there its parameter
    lands an ulp off the rounded master; the port's does not.)
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from visper_lm_tpu_torch.parallel.distributed import all_gather, all_reduce
from visper_lm_tpu_torch.parallel.sharding import assemble, scatter_grad
from visper_lm_tpu_torch.utils.param import jax_path, torch_dtype


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-3
    mm_projector_lr: Optional[float] = None
    mm_vision_lr: Optional[float] = None
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    stage: str = "pretrain"  # pretrain | finetune | vpt | probe | lora
    mu_dtype: str = "float32"
    master_weights: bool = False


# path-regex -> group; first match wins (JAX `_STAGE_TRAINABLE`)
_STAGE_TRAINABLE: Dict[str, Tuple[str, ...]] = {
    "pretrain": (r"^mm_projector/", r"^special_tokens/", r"^heads/", r"^logit_scales/"),
    "finetune": (r"^(?!vision_tower/).*",),
    "vpt": (r"^(?!vision_tower/).*",),
    "vision_tower": (r"^vision_tower/", r"^mm_projector/"),
    "full": (r".*",),
    "probe": (r"^heads/", r"^probes/", r"^logit_scales/"),
    "lora": (r"^lora/", r"^mm_projector/"),
}

def trainable_mask(named_params: Iterable[Tuple[str, torch.Tensor]], stage: str) -> Dict[str, bool]:
    patterns = _STAGE_TRAINABLE[stage]
    return {
        n: any(re.search(pat, jax_path(n)) for pat in patterns) for n, _ in named_params
    }


def lr_group_labels(
    named_params: Iterable[Tuple[str, torch.Tensor]], cfg: OptimizerConfig, stage: str
) -> Dict[str, str]:
    """frozen | projector | vision | base per parameter."""
    named_params = list(named_params)
    mask = trainable_mask(named_params, stage)
    labels = {}
    for n, _ in named_params:
        p = jax_path(n)
        if not mask[n]:
            labels[n] = "frozen"
        elif cfg.mm_projector_lr is not None and p.startswith("mm_projector/"):
            labels[n] = "projector"
        elif cfg.mm_vision_lr is not None and p.startswith("vision_tower/"):
            labels[n] = "vision"
        else:
            labels[n] = "base"
    return labels


def decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, bool]:
    """No weight decay on 1-D params (norm scales, biases), scalars, or any
    path with 'norm' or ending in '/bias'."""
    out = {}
    for n, t in named_params:
        p = jax_path(n)
        out[n] = not (t.ndim <= 1 or "norm" in p or p.endswith("/bias"))
    return out


def cosine_schedule(cfg: OptimizerConfig, peak_lr: float):
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, max(total, warmup+1), 0):
    count -> learning rate."""
    warmup = max(int(cfg.warmup_ratio * cfg.total_steps), 1)
    decay_steps = max(cfg.total_steps, warmup + 1) - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return peak_lr * count / warmup
        frac = min(count - warmup, decay_steps) / decay_steps
        return peak_lr * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


def _weak(value: float, dtype: torch.dtype) -> float:
    """A Python constant as optax's weakly typed scalar takes `dtype`."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def bias_correction(b: float, count: int) -> float:
    """optax's 1 - b^count, in f32: in double it differs by up to 1e-5
    relative (the subtraction cancels)."""
    return float(np.float32(1.0) - np.float32(b) ** np.float32(count))


def leaf_sumsq(g: torch.Tensor) -> torch.Tensor:
    """One gradient's share of optax.global_norm: its squares summed in f32
    (one read of g), as a 0-d tensor in its dtype."""
    return torch.linalg.vector_norm(g, dtype=torch.float32).square().to(g.dtype)


def combine_norm(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm from its leaves' `leaf_sumsq`, in the tree's order:
    added in their promoted dtype (each add rounds to it), then the root."""
    if not parts:
        return torch.zeros(())
    return functools.reduce(torch.add, parts).sqrt()


def clip_divisor(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """clip_by_global_norm as one division, t / clip_divisor: 1 where norm <
    max_norm, else norm / max_norm (optax's t / norm x max_norm, the same
    bytes for max_norm 1)."""
    return torch.where(norm < max_norm, torch.ones_like(norm), norm / max_norm)


def _add_scaled(acc: torch.Tensor, x: torch.Tensor, c: float) -> torch.Tensor:
    """acc += c x, as optax's weakly typed c x: the product rounds to x's
    dtype, unless acc is f32 and so widens it at once (XLA keeps it f32)."""
    if acc.dtype == torch.float32:
        return acc.add_(x, alpha=_weak(c, x.dtype))
    return acc.add_(x * _weak(c, x.dtype))


@torch.no_grad()
def adam_leaf_update(
    p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
    master: Optional[torch.Tensor], cfg: OptimizerConfig, *,
    clip: torch.Tensor, lr: float, count: int, decay: bool,
) -> None:
    """One tensor's optax update, in place (p, mu, nu and master: a whole
    parameter or a block of rows of it): g clipped by its group's
    `clip_divisor`, the moments, the bias corrections of update `count`
    (1-based), weight decay where `decay`, the step of `lr`."""
    pd = p.dtype
    g = torch.div(g, clip.to(g.dtype))
    _add_scaled(mu.mul_(_weak(cfg.b1, mu.dtype)), g, 1.0 - cfg.b1)
    # nu = (1 - b2) g^2 + b2 nu in the parameter's dtype, each op rounding to
    # it as optax's does (bf16(0.999) is 1)
    d2 = _weak(cfg.b2, pd)
    if d2 != 1.0:
        nu.mul_(d2)
    nu.add_(torch.mul(g, g).mul_(_weak(1.0 - cfg.b2, pd)))
    bc1, bc2 = bias_correction(cfg.b1, count), bias_correction(cfg.b2, count)
    denom = torch.div(nu, _weak(bc2, pd)).sqrt_().add_(_weak(cfg.eps, pd))
    u = torch.div(torch.div(mu, _weak(bc1, mu.dtype)), denom)
    if decay and cfg.weight_decay:
        _add_scaled(u, p, cfg.weight_decay)
    u.mul_(_weak(float(np.float32(-lr)), u.dtype))
    if master is None:
        p.add_(u)
    else:
        master.add_(u)
        p.copy_(master)


_BLOCK = re.compile(r"^decoder\.blocks\.\d+\.")


def jax_leaf_order(names: Iterable[str]) -> List[str]:
    """Names in the order of the JAX tree's leaves (sorted paths), the order
    optax.global_norm adds them in."""
    return sorted(names, key=lambda n: (jax_path(n), n))


class AdamW:
    """optax adamw (+ clip_by_global_norm) over named parameters, in place.

    With a `zero` plan (parallel/sharding.ZeroPlan; data parallelism over
    its process group) every rank keeps the moments and master copies of
    its slice of each trainable only (ZeRO-1/2: the plan's moment
    placements, JAX's `opt_state_pspecs`). `step` takes each rank's own
    gradients (its shard of the global batch, already normalised by the
    global counts) and sums them over the ranks: a replicated leaf's by an
    all-reduce (every rank updates the whole leaf, as JAX), a sharded
    leaf's by a reduce-scatter onto the rank's slice, which
    `adam_leaf_update` updates unchanged; the updated slices are then
    gathered into the parameters in place. A leaf's share of the global
    norm is then the sum of its slices' f32 sums of squares, added over the
    ranks in f32 before the cast to the leaf's dtype: the one-device sum
    taken in another order (within a few f32 ulps of the leaf's sum, so at
    most one ulp of a bf16 leaf's). Under tensor parallelism (the plan's
    `tp`) every tensor is the rank's tp-local slice and ZeRO runs over the
    data group (the ranks of its model coordinate); a 'model'-split leaf's
    share of the norm is its slices' f32 sums added over the model group as
    well (the same bound), and a replicated leaf counts once, not tp times:
    its gradient is the same on every rank of the group. Under expert
    parallelism (the plan's `ep`) a MoE bank is the rank's experts: its
    share of the norm is its slices' f32 sums added over the expert group
    too, and every other leaf (the router included) counts once. With `sharded` (ZeRO-3:
    parallel/sharding.ShardedParams) a parameter whose persistent copy is
    sharded is updated in its slices, and never whole where its slices are
    its moments'.

    Under sequence parallelism (the plan's `seq`) each rank's gradients are
    its rows' shares: they are summed over the seq group first (no
    parameter is split over 'seq'). Under pipeline parallelism (the plan's
    `pipe`) the optimizer holds the stage's blocks and the parameters every
    stage shares (their gradients the same on every stage: the pipeline
    hands each the same values), and `foreign` names the trainables other
    stages hold: the global norm takes each block's share from its owner
    (the stage-disjoint blocks' sums all-reduced over the pipe group) and
    every shared leaf once, in the one-device order."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], cfg: OptimizerConfig,
                 *, zero=None, sharded=None, foreign: Optional[Dict[str, torch.Tensor]] = None):
        self.cfg = cfg
        self.params = dict(named_params)
        self.zero, self.sharded = zero, sharded
        # {name: parameter} of the trainables other pipeline stages hold
        self.foreign = dict(foreign or {})
        self._full: Dict[str, torch.Tensor] = {}
        groups = lr_group_labels(list(self.params.items()) + list(self.foreign.items()), cfg,
                                 cfg.stage)
        peaks = {
            "base": cfg.learning_rate,
            "projector": cfg.mm_projector_lr or cfg.learning_rate,
            "vision": cfg.mm_vision_lr or cfg.learning_rate,
        }
        self.schedules = {g: cosine_schedule(cfg, lr) for g, lr in peaks.items()}
        self.group = {n: groups[n] for n in list(self.params) + list(self.foreign)}
        self.decay = decay_mask(self.params.items())
        self.mu_dtype = torch_dtype(cfg.mu_dtype)
        self.count = 0
        self.init_state()

    def init_state(self) -> None:
        """The moments at zero (mu in `mu_dtype`, nu in each parameter's
        dtype) and the f32 master copies, beside the parameters (of the
        rank's slice, under a zero plan)."""
        self.mu, self.nu = {}, {}
        for n, p in self.params.items():
            shape = self.local_shape(n)
            self.mu[n] = torch.zeros(shape, dtype=self.mu_dtype, device=p.device)
            self.nu[n] = torch.zeros(shape, dtype=p.dtype, device=p.device)
        self.master = (
            {n: self.local_param(n).detach().float().clone() for n in self.params}
            if self.cfg.master_weights else None
        )
        self._full.clear()

    # -- the rank's slices under a zero plan (the whole tensors without one) --

    def local_shape(self, n: str) -> Tuple[int, ...]:
        """The shape of parameter n's moments on this rank."""
        shape = tuple(self.params[n].shape)
        return shape if self.zero is None else self.zero.moments[n].local_shape(shape, self.zero.rank)

    def local_param(self, n: str) -> torch.Tensor:
        """The tensor whose values are this rank's slice of parameter n (its
        moments' slice), updated in place: the parameter, a view of it, its
        ZeRO-3 shard, or (where the shard and the moments' slice differ) a
        slice of a gathered copy that `publish` hands back."""
        p = self.params[n]
        if self.zero is None:
            return p
        pl, rank = self.zero.moments[n], self.zero.rank
        if self.sharded is not None and n in self.sharded.shards:
            if self.sharded.plan[n] == pl:
                return self.sharded.shards[n]
            if n not in self._full:
                self._full[n] = self.sharded.full(n)
            return pl.local(self._full[n], rank)
        return pl.local(p.data, rank)

    def reduce_grads(self, names: List[str], grads: Dict[str, torch.Tensor],
                     reduced: Iterable[str] = ()) -> None:
        """Each rank's gradients summed over the ranks, in place of `grads`:
        grads[n] becomes this rank's slice (`scatter_grad`); the names in
        `reduced` are already (gradient streaming reduces per segment)."""
        if self.zero is None:
            return
        reduced = set(reduced)
        seq = getattr(self.zero, "seq", None)
        for n in names:
            if n not in reduced:
                g = grads[n].contiguous()
                if seq is not None:
                    g = all_reduce(g, seq.group)
                grads[n] = scatter_grad(self.zero.moments[n], g, self.zero.group, self.zero.rank)

    @torch.no_grad()
    def publish(self, names: List[str]) -> None:
        """The updated slices into the parameters on every rank (a
        replicated parameter's whole value; a ZeRO-3 shard is its own)."""
        if self.zero is None:
            return
        rank, group = self.zero.rank, self.zero.group
        for n in names:
            pl = self.zero.moments[n]
            if n in self._full:
                full = self._full.pop(n)
                assemble(pl, pl.local(full, rank), full, group, rank)
                self.sharded.shards[n].copy_(self.sharded.plan[n].local(full, rank))
            elif pl.sharded and not (self.sharded is not None and n in self.sharded.shards):
                p = self.params[n].data
                assemble(pl, pl.local(p, rank), p, group, rank)

    def full_state_tensors(self) -> Dict[str, torch.Tensor]:
        """`state_tensors` as one device holds them: under a zero plan each
        rank's slices gathered (collective), on the host."""
        if self.zero is None:
            return self.state_tensors()
        out = {}
        for key, t in self.state_tensors().items():
            out[key] = self.full_state_tensor(key, t)
        return out

    def full_state_tensor(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """One `state_tensors` entry whole, on the host (collective under a
        zero plan)."""
        if self.zero is None:
            return t.detach().cpu()
        n = key.split("/", 1)[1]
        pl = self.zero.moments[n]
        dev = self.params[n].device
        full = t.detach().to(dev)
        if pl.sharded:
            full = torch.empty(self.params[n].shape, dtype=t.dtype, device=dev)
            assemble(pl, t.to(dev), full, self.zero.group, self.zero.rank)
        if pl.model_sharded:
            full = all_gather(full.contiguous(), pl.model_dim, self.zero.tp.group)
        if pl.expert_sharded:
            full = all_gather(full.contiguous(), pl.expert_dim, self.zero.ep.group)
        return full.cpu()

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """The state as flat {"mu/<name>", "nu/<name>", "master/<name>"} tensors
        (what a checkpoint keeps, beside `count`)."""
        out = {f"mu/{n}": t for n, t in self.mu.items()}
        out.update({f"nu/{n}": t for n, t in self.nu.items()})
        if self.master is not None:
            out.update({f"master/{n}": t for n, t in self.master.items()})
        return out

    @torch.no_grad()
    def load_state_tensors(self, tensors: Dict[str, torch.Tensor], count: int) -> None:
        """Copy a `state_tensors` dict (and the update count) into this state;
        each tensor is cast to the state's dtype (a checkpoint with an f32
        second moment loads into a bf16 one). Under a zero plan the tensors
        are whole and each rank takes its slices."""
        for key, dst in self.state_tensors().items():
            if key not in tensors:
                raise KeyError(f"optimizer state has no {key!r}")
            src = torch.as_tensor(tensors[key])
            if self.zero is not None:
                pl = self.zero.moments[key.split("/", 1)[1]]
                if pl.model_sharded:
                    src = pl.model_local(src, self.zero.tp.rank)
                if pl.expert_sharded:
                    src = pl.expert_local(src, self.zero.ep.rank)
                src = pl.local(src, self.zero.rank)
            dst.copy_(src)
        self.count = int(count)

    def trained(self) -> List[str]:
        """The names this optimizer updates, in the JAX tree's leaf order."""
        return jax_leaf_order(n for n in self.params if self.group[n] != "frozen")

    def norm_pass(self, names: List[str], grads: Dict[str, torch.Tensor],
                  sumsq: Optional[Dict[str, torch.Tensor]] = None,
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Each lr group's `clip_divisor` (each group is its own optax chain,
        clipped by its own global norm) and the global norm over all (f32).
        A gradient without its `leaf_sumsq` in `sumsq` is summed beside its
        parameter; for a leaf split over the data or the model axis `sumsq`
        holds its slice's f32 sum of squares."""
        moments = {} if self.zero is None else self.zero.moments
        split = [n for n in names if n in moments and (moments[n].sharded or
                                                        moments[n].model_sharded or
                                                        moments[n].expert_sharded)]
        sq = {n: sumsq[n] if sumsq and n in sumsq
              else leaf_sumsq(grads[n].to(self.params[n].device, non_blocking=True))
              for n in names if n not in split}
        if split:
            # a split leaf's sum: its slices' f32 sums added over the ranks
            # that hold them (the data group, the model group, or both)
            parts = {n: sumsq[n].float() if sumsq and n in sumsq else torch.linalg.vector_norm(
                grads[n].to(self.params[n].device, non_blocking=True), dtype=torch.float32).square()
                for n in split}
            for axis, group in (("sharded", self.zero.group),
                                ("model_sharded", getattr(self.zero.tp, "group", None)),
                                ("expert_sharded", getattr(self.zero.ep, "group", None))):
                over = [n for n in split if getattr(moments[n], axis)]
                if over:
                    stacked = torch.stack([parts[n] for n in over])
                    all_reduce(stacked, group)
                    parts.update(zip(over, stacked.unbind(0)))
            sq.update({n: parts[n].to(grads[n].dtype) for n in split})
        pipe = None if self.zero is None else getattr(self.zero, "pipe", None)
        blocks = [] if pipe is None else jax_leaf_order(
            set(self.foreign) | {n for n in names if _BLOCK.match(n)})
        if blocks:
            # the stage-disjoint blocks' sums from their owners (zeros here
            # for the blocks other stages hold), every shared leaf once
            dtypes = {n: (self.foreign[n] if n in self.foreign else self.params[n]).dtype
                      for n in blocks}
            dev = next(iter(self.params.values())).device
            vec = torch.stack([sq[n].float().to(dev) if n in sq else torch.zeros((), device=dev)
                               for n in blocks])
            all_reduce(vec, pipe.group)
            sq.update({n: v.to(dtypes[n]) for n, v in zip(blocks, vec.unbind(0))})
            names = jax_leaf_order(set(names) | set(self.foreign))
        clips = {group: clip_divisor(combine_norm([sq[n] for n in names if self.group[n] == group]),
                                     self.cfg.max_grad_norm)
                 for group in set(self.group[n] for n in names)}
        return clips, combine_norm([sq[n] for n in names]).float()

    def leaf_kwargs(self, n: str, clips: Dict[str, torch.Tensor]) -> dict:
        """`adam_leaf_update`'s keywords for parameter n in the current update."""
        group = self.group[n]
        return dict(clip=clips[group], lr=self.schedules[group](self.count - 1),
                    count=self.count, decay=self.decay[n])

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor],
             sumsq: Optional[Dict[str, torch.Tensor]] = None,
             reduced: Iterable[str] = ()) -> torch.Tensor:
        """Apply one update from {name: grad} (every parameter needs a grad;
        pass zeros for unused ones; `sumsq` may hold some gradients'
        `leaf_sumsq`, taken where they were made; `reduced` names gradients
        already summed over the ranks). Returns the pre-clip global norm (f32)."""
        names = self.trained()
        self.reduce_grads(names, grads, reduced)
        clips, total = self.norm_pass(names, grads, sumsq)
        self.count += 1
        for n in names:
            adam_leaf_update(self.local_param(n), grads[n], self.mu[n], self.nu[n],
                             None if self.master is None else self.master[n], self.cfg,
                             **self.leaf_kwargs(n, clips))
        self.publish(names)
        return total
