"""Embedding-predictor heads for gen / depth / seg (counterpart of
visper_lm_tpu/models/heads.py: `TaskHead` holds `init_task_head`'s params,
`task_head_forward` is its forward).

A head is a Resampler in task-token mode; the depth head runs its resampler
at the LLM's width and carries three intermediate MLPs (Linear, ReLU,
Linear) for weight parity. Those MLPs feed only the frozen DPT decoder of the
visualisation path (JAX `depth_intermediate_features`, not ported), never the
loss. The probe heads are not on the PT path and are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from visper_lm_tpu_torch.config import DistillTaskConfig
from visper_lm_tpu_torch.models.resampler import Resampler


class BuildMLP(nn.Module):
    """Linear(in, in) -> ReLU -> Linear(in, out), both with bias."""

    def __init__(self, in_dim: int, out_dim: int, device=None, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, in_dim, device=device, dtype=dtype)
        self.fc2 = nn.Linear(in_dim, out_dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))


class TaskHead(nn.Module):
    """One head instance (the VLM has one per task and tapped layer)."""

    def __init__(
        self, task_cfg: DistillTaskConfig, llm_hidden_size: int, *, num_task_tokens: int,
        use_intermediate_depth: bool = False, device=None, dtype=None,
    ):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        task_token = num_task_tokens > 0
        inner_dim = llm_hidden_size if (task_cfg.task == "depth" and task_token) else None
        self.task_cfg = task_cfg
        self.resampler = Resampler(
            task_cfg.head, llm_hidden_size, task_token=task_token, inner_dim=inner_dim, **kw
        )
        self.intermediate = None
        if task_cfg.task == "depth" and use_intermediate_depth:
            d = task_cfg.head.output_dim
            self.intermediate = nn.ModuleList(BuildMLP(d, d, **kw) for _ in range(3))


def task_head_forward(
    head: TaskHead,
    llm_feats: torch.Tensor,                  # (B, N, llm_hidden)
    task_tokens: Optional[torch.Tensor],      # (B, M, llm_hidden) or None
) -> torch.Tensor:
    """The predicted teacher embedding (B, num_tokens, output_dim)."""
    return head.resampler(llm_feats, task_tokens)
