"""Mixture-of-experts MLP with expert parallelism over an 'expert' axis
(counterpart of visper_lm_tpu/ops/moe.py).

JAX's layer, kept where a number depends on it:

  * top-k routing on f32 logits (`x.float() @ router`, the router f32 in a
    bf16 model), the k gates renormalised by their sum (floored at 1e-9);
    ties go to the lowest expert index, as `jax.lax.top_k` breaks them
    (a stable descending sort, first k; `torch.topk` promises no order);
  * static capacity C = ceil(N K / E cf) of the call's N = B T tokens, and
    priority by the running count over the (N K) routes in token-major
    order: earlier tokens win, a route past C is dropped (combine weight
    0, so a token with every route dropped gets exactly 0);
  * the Switch load-balance loss E sum_e f_e p_e (f_e over the KEPT top-1
    routes), the router z-loss mean(logsumexp(logits)^2) and the dropped
    share, returned beside the output;
  * JAX's rounding points: the dispatched rows in x's dtype, the gate and
    up products and the expert outputs in f32 (`preferred_element_type`),
    silu(g) u rounded to x's dtype before the down product, the combine in
    f32 and one rounding at the end.

What differs is the dispatch: JAX contracts (N, E, C) one-hot tensors on
the MXU; the port gathers each kept route's row into its expert's slot
and scatter-adds the gated outputs back (index ops). A one-hot
contraction picks exactly one term, so the values are the same, without
tensors quadratic in the tokens (ROADMAP C, the index dispatch). The
module holds no Pallas kernel in JAX: the expert products are batched
matmuls here too.

Expert parallelism (`ep`, a `distributed.AxisGroup` over the 'expert'
axis). JAX shards the batch over 'data' only, so the ranks of an expert
group hold the same tokens. Each routes all of them (the router, gates and aux
losses are replicated), runs its E/ep experts on the routes that reach
them, and the partial outputs are summed over the group in f32
(`reduce_from_group`: all-reduce forward, identity backward). The rows
fed to the experts and the gates pass `copy_to_group` (identity forward,
gradient all-reduced), so the router's and the input's gradients are the
one-process ones on every rank: not partial, not counted ep times.

Global-batch semantics under data and sequence parallelism (`data`, the
routing group: an `AxisGroup` over the data x seq ranks,
`distributed.routing_group`, data-major, `data.inner` the seq size).
JAX computes capacity, priority and the aux losses over the global batch;
a port rank holds its data shard's rows, and under sp only its T/sp rows
of each (parallel/sequence.py), so JAX's token-major order (b, t)
interleaves the seq ranks' slices inside every row. Capacity comes from
the global N (the local N times the group's size). The slot of a route to
expert e at the rank's token (b, t) is its running count among the rank's
routes of row b, plus the routes to e of every data rank before this one
(all their rows), of every seq rank of this data rank in rows b' < b, and
of the seq ranks before this one in row b: one all-gather of the (B, E)
route counts a row of every rank of the group (dp alone is the case sp =
1). f_e, p_e, the z-loss and the kept count are averaged over the group
(p_e and the z-loss through an autograd all-reduce). The aux values are
the global batch's, the same on every rank of the group.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from visper_lm_tpu_torch.parallel import distributed
from visper_lm_tpu_torch.parallel.distributed import AxisGroup


def expert_parallel(mesh) -> Optional[AxisGroup]:
    """This process's group on the mesh's 'expert' axis (collective: every
    process makes every group), None when the axis is absent or 1 wide."""
    if mesh is None or mesh.expert_size == 1:
        return None
    return AxisGroup(*distributed.expert_group(mesh))


def check_experts(num_experts: int, ep: int) -> None:
    """The port splits the experts in equal blocks: E must divide by ep."""
    if num_experts % ep:
        raise ValueError(f"expert parallelism: moe_experts {num_experts} does not divide by ep {ep}")


class ExpertBank(nn.Module):
    """One stacked expert weight (E / parts, din, dout) in JAX's layout (no
    transpose: the experts' products read it as it is), holding experts
    [rank E/parts, (rank + 1) E/parts) of E."""

    def __init__(self, num_experts: int, din: int, dout: int, *, parts: int = 1, rank: int = 0,
                 device=None, dtype=None):
        super().__init__()
        check_experts(num_experts, parts)
        self.num_experts, self.parts = num_experts, parts
        self.first = rank * (num_experts // parts)
        self.kernel = nn.Parameter(torch.empty(num_experts // parts, din, dout, device=device,
                                               dtype=dtype))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """U(-din^-0.5, din^-0.5), as JAX `init_moe_mlp`, drawn for all E
        experts (so a rank's slice holds the one-device model's numbers). A
        bank with no storage (a block another pipeline stage owns) is drawn
        all the same and dropped, so the banks after it get the whole
        model's numbers."""
        e, din, dout = self.num_experts, self.kernel.shape[1], self.kernel.shape[2]
        held = self.kernel.untyped_storage().nbytes() > 0
        if self.parts == 1 and held:
            self.kernel.uniform_(-din ** -0.5, din ** -0.5, generator=generator)
            return
        whole = torch.empty((e, din, dout), dtype=self.kernel.dtype, device=self.kernel.device)
        whole.uniform_(-din ** -0.5, din ** -0.5, generator=generator)
        if held:
            self.kernel.copy_(whole[self.first:self.first + self.kernel.shape[0]])


class Router(nn.Linear):
    """The router (E, D), f32 whatever the model's dtype (JAX keeps it f32:
    bf16 logits visibly perturb top-k ties); its weight is nn.Linear's, the
    transpose of JAX's (D, E) kernel."""

    def __init__(self, d_model: int, num_experts: int, device=None):
        super().__init__(d_model, num_experts, bias=False, device=device, dtype=torch.float32)


def init_moe_mlp(d_model: int, mlp_dim: int, num_experts: int, *, dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None, device=None) -> Dict[str, torch.Tensor]:
    """JAX `init_moe_mlp`'s tree with its distributions (not its numbers):
    {"router": (D, E) f32, "gate" / "up": (E, D, F), "down": (E, F, D)}."""
    def u(shape, s):
        return torch.empty(shape, dtype=dtype, device=device).uniform_(-s, s, generator=generator)

    return {
        "router": torch.empty((d_model, num_experts), device=device).normal_(
            0.0, 0.02, generator=generator),
        "gate": u((num_experts, d_model, mlp_dim), d_model ** -0.5),
        "up": u((num_experts, d_model, mlp_dim), d_model ** -0.5),
        "down": u((num_experts, mlp_dim, d_model), mlp_dim ** -0.5),
    }


def _bmm_to_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b batched, the product in f32 (XLA's preferred_element_type):
    bf16 operands are multiplied and accumulated with an f32 result, never
    rounded to bf16 (torch.bmm's out_dtype on CUDA; the CPU has no such
    product and multiplies f32 copies)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _ExpertProduct(torch.autograd.Function):
    """(E, C, din) @ (E, din, dout) with an f32 result; the backward gives
    each operand its gradient in its own dtype (the f32 cotangent rounded to
    the operand's dtype first where that is bf16), and none to a frozen
    bank."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return _bmm_to_f32(a, w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = _bmm_to_f32(g.to(w.dtype), w.transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            dw = _bmm_to_f32(a.transpose(1, 2), g.to(a.dtype)).to(w.dtype)
        return da, dw


def expert_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The experts' batched product, its result in f32."""
    if a.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.bmm(a, w)
    return _ExpertProduct.apply(a, w)


def route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gate values (N, k), expert ids (N, k)) of the k largest probabilities,
    ties to the lowest expert index (`jax.lax.top_k`)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def capacity_of(n: int, k: int, e: int, capacity_factor: float) -> int:
    """JAX's static capacity: max(1, ceil(N K / E cf))."""
    return max(1, int(math.ceil(n * k / e * capacity_factor)))


def route_offsets(rows: torch.Tensor, data: AxisGroup) -> torch.Tensor:
    """(B, E): for each of this rank's rows b and expert e, the routes to e
    that the global token-major order puts before the rank's first token of
    row b, less the rank's own routes in rows before b (its running count
    already holds those). rows: this rank's route counts (B, E) a row.
    Collective over the routing group `data` (data-major, `data.inner` seq
    ranks a data rank): those of the data ranks before this one (every row),
    of this data rank's seq ranks in rows before b, and of its seq ranks
    before this one in row b."""
    b, e = rows.shape
    sp = data.inner
    counts = distributed.all_gather(rows[None].contiguous(), 0, data.group)
    counts = counts.reshape(data.size // sp, sp, b, e)
    d, s = divmod(data.rank, sp)
    mine = counts[d]                                                  # (sp, B, E)
    per_row = mine.sum(0)
    return (counts[:d].sum((0, 1, 2))[None] + per_row.cumsum(0) - per_row
            + mine[:s].sum(0) - (rows.cumsum(0) - rows))


def moe_mlp(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,                     # (B, T, D)
    *,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    ep: Optional[AxisGroup] = None,
    data: Optional[AxisGroup] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """JAX `moe_mlp`: (out (B, T, D) in x's dtype, aux {lb_loss, z_loss,
    dropped_frac} f32 0-d). params: "router" (D, E) f32 and the rank's
    expert banks "gate" / "up" (E / ep, D, F) and "down" (E / ep, F, D).
    ep: the expert group (its rank runs experts [rank E/ep, ...)); data:
    the routing group whose ranks hold the other rows of the global batch
    (`distributed.routing_group`: the data shards, and under sp each row's
    other slices; capacity, priority and aux over the global batch).
    Collective under either."""
    b, t, d = x.shape
    router = params["router"]
    e = router.shape[-1]
    k = min(top_k, e)
    n = b * t
    xf = x.reshape(n, d)
    gate_w, up_w, down_w = params["gate"], params["up"], params["down"]
    e_local = gate_w.shape[0]
    first = 0 if ep is None else ep.rank * e_local
    if e_local * (1 if ep is None else ep.size) != e:
        raise ValueError(f"moe_mlp: {e_local} experts a rank x ep "
                         f"{1 if ep is None else ep.size} != the router's {e}")
    ranks = 1 if data is None else data.size

    logits = xf.float() @ router.float()                              # (N, E) f32
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = route(probs, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    capacity = capacity_of(n * ranks, k, e, capacity_factor)

    # slot of each (token, k) route in its expert's buffer: the running count
    # over the flattened (N K) priority order (earlier tokens win); its
    # global position adds the routes the group's other ranks put before it
    flat = gate_idx.reshape(-1)                                       # (N K,)
    onehot = F.one_hot(flat, e)                                       # (N K, E) int64
    slot = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
    pos = slot
    if ranks > 1:
        row = torch.arange(n * k, device=x.device) // (t * k)
        pos = slot + route_offsets(onehot.reshape(b, t * k, e).sum(1), data)[row, flat]
    keep = pos < capacity                                             # (N K,)

    # dispatch by index: each kept route of this rank's experts writes its
    # token's row into slot (expert - first, slot) of a (E_local, C, D)
    # buffer; everything else goes to a spare slot that no product reads
    mine = keep & (flat >= first) & (flat < first + e_local)
    n_slots = e_local * capacity
    dest = torch.where(mine, (flat - first).clamp(0, e_local - 1) * capacity + slot, n_slots)
    token = torch.arange(n * k, device=x.device) // k
    slot_token = torch.full((n_slots + 1,), n, dtype=torch.long, device=x.device)
    slot_token.scatter_(0, dest, torch.where(mine, token, n))
    xin_rows = xf if ep is None else distributed.copy_to_group(xf, ep.group)
    xin = torch.cat([xin_rows, xin_rows.new_zeros(1, d)]).index_select(0, slot_token[:n_slots])
    xin = xin.reshape(e_local, capacity, d)

    g = expert_product(xin, gate_w)                                   # (E_l, C, F) f32
    u = expert_product(xin, up_w)
    y = expert_product((F.silu(g) * u).to(x.dtype), down_w)           # (E_l, C, D) f32

    # combine in f32: each kept route adds gate x its slot's output to its token
    gates = gate_vals if ep is None else distributed.copy_to_group(gate_vals, ep.group)
    y_rows = torch.cat([y.reshape(n_slots, d), y.new_zeros(1, d)]).index_select(0, dest)
    out = (gates.reshape(-1, 1) * mine[:, None] * y_rows).reshape(n, k, d).sum(1)
    if ep is not None:
        out = distributed.reduce_from_group(out, ep.group)

    # Switch load-balance loss over the kept top-1 routes, the router z-loss
    top1 = F.one_hot(gate_idx[:, 0], e).float() * keep.reshape(n, k)[:, :1]
    f_e = top1.mean(0)
    p_e = probs.mean(0)
    z = torch.logsumexp(logits, dim=-1).square().mean()
    kept = keep.float().sum()
    if ranks > 1:
        both = torch.cat([p_e, z[None], f_e, kept[None]])
        both = distributed.all_reduce_autograd(both, data.group)
        p_e, z, f_e = both[:e] / ranks, both[e] / ranks, both[e + 1:2 * e + 1] / ranks
        kept = both[-1]
    aux = {"lb_loss": e * (f_e * p_e).sum(), "z_loss": z,
           "dropped_frac": 1.0 - kept / (n * ranks * k)}
    return out.reshape(b, t, d).to(x.dtype), aux
