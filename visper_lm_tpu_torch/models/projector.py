"""Vision->LLM projector: 'linear' | 'mlpNx_gelu' | 'identity'
(counterpart of visper_lm_tpu/models/projector.py; exact gelu)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from visper_lm_tpu_torch.config import ProjectorConfig


class Projector(nn.Module):
    def __init__(self, cfg: ProjectorConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        layers = []
        if cfg.projector_type != "identity":
            layers.append(nn.Linear(cfg.input_dim, cfg.output_dim, **kw))
            for _ in range(1, cfg.mlp_depth):
                layers.append(nn.Linear(cfg.output_dim, cfg.output_dim, **kw))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not len(self.layers):
            return x
        y = self.layers[0](x)
        for layer in self.layers[1:]:
            y = layer(F.gelu(y, approximate="none"))
        return y
