"""The reference training steps: the configuration's losses, the gradient
averaged over the micro-batches, clipping by the global norm and AdamW with
the warmup-cosine schedule, all in float32 (TF32 off)."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from benchmark.reference import models
from benchmark.reference.models import Ctx


def schedule(opt: dict, count: int) -> float:
    """The learning rate of update `count` (0-based): linear warmup from 0
    over max(int(warmup_ratio * total_steps), 1) updates, then a cosine to 0."""
    warmup = max(int(opt["warmup_ratio"] * opt["total_steps"]), 1)
    decay = max(opt["total_steps"], warmup + 1) - warmup
    if count < warmup:
        return opt["learning_rate"] * count / warmup
    frac = min(count - warmup, decay) / decay
    return opt["learning_rate"] * 0.5 * (1.0 + math.cos(math.pi * frac))


def decays(name: str, shape) -> bool:
    """Weight decay skips 1-D leaves, norms and biases."""
    return not (len(shape) <= 1 or "norm" in name or name.endswith(".bias"))


def steps(m: dict, W, W_teach, batches: Sequence[Sequence[Dict[str, torch.Tensor]]], opt: dict,
          trainable: Sequence[str], prec: str = "f32", teacher_chunk: int = 2,
          moments_on=None) -> Dict[str, object]:
    """Follow len(batches) optimizer steps (each a list of micro-batches on
    the device) from the drawn weights. Returns each step's loss (the mean of
    its micro-batches'), each trainable's first clipped gradient norm, and
    each trainable's change after the last step. moments_on: where Adam's
    moments live (host memory for a trainable decoder: they are read leaf by
    leaf)."""
    models.strict_float32()
    c = Ctx(W, prec)
    ct = Ctx(W_teach, prec) if W_teach is not None else None
    params = {}
    for n in trainable:
        params[n] = W[n].detach().clone().requires_grad_(True)
        W.cache.pop(n, None)
    W.override = params
    where = moments_on or next(iter(params.values())).device
    mu = {n: torch.zeros(p.shape, device=where) for n, p in params.items()}
    nu = {n: torch.zeros(p.shape, device=where) for n, p in params.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses: List[float] = []
    first: Dict[str, float] = {}
    for s, micro in enumerate(batches):
        gsum = {n: torch.zeros_like(p) for n, p in params.items()}
        lsum = 0.0
        for mb in micro:
            targets = None
            if ct is not None:
                parts = []
                b = mb["images"].shape[0]
                for i in range(0, b, teacher_chunk):
                    parts.append(models.teacher_targets(
                        ct, m, {k: v[i:i + teacher_chunk] for k, v in mb.items()
                                if k.endswith("_images")}))
                targets = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
            loss = models.vlm_loss(c, m, mb, targets)
            names = list(params)
            grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
            for n, g in zip(names, grads):
                if g is not None:
                    gsum[n] += g
            lsum += float(loss.detach())
            del loss, grads, targets
        g = {n: t / len(micro) for n, t in gsum.items()}
        norm = math.sqrt(sum(float(t.double().square().sum()) for t in g.values()))
        div = 1.0 if norm < opt["max_grad_norm"] else norm / opt["max_grad_norm"]
        g = {n: t / div for n, t in g.items()}
        if s == 0:
            first = {n: float(t.double().norm()) for n, t in g.items()}
        count = s + 1
        lr = schedule(opt, count - 1)
        bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        with torch.no_grad():
            for n, p in params.items():
                m1, m2 = mu[n].to(p.device), nu[n].to(p.device)
                m1.mul_(b1).add_(g[n], alpha=1.0 - b1)
                m2.mul_(b2).add_(g[n].square(), alpha=1.0 - b2)
                u = (m1 / bc1) / ((m2 / bc2).sqrt() + eps)
                if opt["weight_decay"] and decays(n, p.shape):
                    u = u + opt["weight_decay"] * p
                p.sub_(lr * u)
                mu[n].copy_(m1)
                nu[n].copy_(m2)
        del g, gsum
        losses.append(lsum / len(micro))
    W.override = {}
    change = {}
    for n, p in params.items():
        change[n] = float((p.detach() - W[n]).double().norm())
        W.cache.pop(n, None)
    return {"losses": losses, "grad_norms": first, "changes": change}
