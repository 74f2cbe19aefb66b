"""Optimizer: AdamW with per-group learning rates and stage freeze policies
(counterpart of visper_lm_tpu/train/optimizer.py).

The stage policies are the JAX package's regexes, matched on JAX-style paths
built from the port's parameter names (`jax_path`). The update is plain torch
written to follow optax's arithmetic (clip_by_global_norm -> scale_by_adam ->
add_decayed_weights -> scale_by_learning_rate -> apply_updates):

  * the learning rate of update n (0-based) is schedule(n): a linear warmup
    from 0 over max(int(warmup_ratio * total_steps), 1) steps, then a cosine
    to 0, so the FIRST update has lr 0, even with warmup_ratio 0;
  * clipping by the global norm has no epsilon (unlike `clip_grad_norm_`),
    and each lr group (base / projector / vision) is clipped by its own
    norm, as optax.multi_transform runs one chain per group;
  * the moments are f32 whatever the parameter dtype (optax keeps the first
    moment in `mu_dtype` f32 and the second in the parameter dtype: the two
    agree for f32 parameters); the bias corrections 1 - b^n are computed in
    f32, as optax does;
  * the weight decay constant takes the parameter's dtype, as optax's weakly
    typed scalar does (bf16(0.1) = 0.10009766 for a bf16 parameter), and
    multiplies the parameter in f32;
  * the f32 update is added to the parameter and the sum rounded to its dtype;
  * with `master_weights` (JAX `with_master_weights`, last in the chain) the
    update goes to an f32 copy of each trainable instead, and the parameter
    becomes that copy rounded to its dtype. (JAX emits the delta
    round(master) - p in the parameter's dtype, which rounds where a
    parameter crosses zero by more than its own size: there its parameter
    lands an ulp off the rounded master; the port's does not.)
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from visper_lm_tpu_torch.utils.param import (
    jax_path,
)


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


class AdamW:
    """optax adamw (+ clip_by_global_norm) over named parameters, in place."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], cfg: OptimizerConfig):
        if cfg.mu_dtype != "float32":
            raise NotImplementedError("the port keeps its moments in f32")
        self.cfg = cfg
        self.params = dict(named_params)
        groups = lr_group_labels(self.params.items(), cfg, cfg.stage)
        peaks = {
            "base": cfg.learning_rate,
            "projector": cfg.mm_projector_lr or cfg.learning_rate,
            "vision": cfg.mm_vision_lr or cfg.learning_rate,
        }
        self.schedules = {g: cosine_schedule(cfg, lr) for g, lr in peaks.items()}
        self.group = {n: groups[n] for n in self.params}
        self.decay = decay_mask(self.params.items())
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in self.params.items()}
        self.master = (
            {n: p.detach().float().clone() for n, p in self.params.items()}
            if cfg.master_weights else None
        )
        self.count = 0

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
        """Copy a `state_tensors` dict (and the update count) into this state."""
        for key, dst in self.state_tensors().items():
            if key not in tensors:
                raise KeyError(f"optimizer state has no {key!r}")
            dst.copy_(torch.as_tensor(tensors[key]))
        self.count = int(count)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Apply one update from {name: grad} (every parameter needs a grad;
        pass zeros for unused ones). Returns the pre-clip global norm (f32)."""
        cfg = self.cfg
        names = [n for n in self.params if self.group[n] != "frozen"]
        g32 = {n: grads[n].float() for n in names}
        sq = {n: g.square().sum() for n, g in g32.items()}
        gnorm = torch.sqrt(sum(sq.values()))
        # each lr group is its own optax chain: clipped by its own global norm
        clip = {}
        for group in set(self.group[n] for n in names):
            norm = torch.sqrt(sum(sq[n] for n in names if self.group[n] == group))
            clip[group] = torch.where(
                norm < cfg.max_grad_norm, torch.ones_like(norm), cfg.max_grad_norm / norm
            )
        self.count += 1
        # optax's bias corrections, 1 - b^count in f32: in double they differ
        # from its by up to 1e-5 relative (the subtraction cancels)
        n = np.float32(self.count)
        bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** n)
        bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** n)
        for n in names:
            p, g = self.params[n], g32[n] * clip[self.group[n]]
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(cfg.b1).add_(g, alpha=1.0 - cfg.b1)
            nu.mul_(cfg.b2).add_(g.square(), alpha=1.0 - cfg.b2)
            upd = (mu / bc1) / ((nu / bc2).sqrt() + cfg.eps)
            if cfg.weight_decay and self.decay[n]:
                # optax's weakly typed weight decay takes p's dtype: bf16(0.1)
                # for a bf16 parameter, times p in f32
                wd = float(torch.tensor(cfg.weight_decay, dtype=p.dtype))
                upd = upd + wd * p.float()
            lr = self.schedules[self.group[n]](self.count - 1)
            if self.master is None:
                p.copy_((p.float() - lr * upd).to(p.dtype))
            else:
                master = self.master[n]
                master.sub_(lr * upd)
                p.copy_(master.to(p.dtype))
        return gnorm
