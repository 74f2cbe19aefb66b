"""Perceiver resampler, the distillation heads' core (counterpart of
visper_lm_tpu/models/resampler.py).

  * PerceiverAttention: latents attend to concat([x, latents]); q and k are
    each scaled by d_head^-0.25 in f32 and the softmax is taken in f32. Plain
    attention, no kernel, as in the JAX package.
  * FeedForward: LayerNorm, linear, exact gelu, linear.
  * Resampler: proj_in / proj_out + output LayerNorm around residual attn + FF
    layers. In task-token mode (no learned latents) the latents come from the
    caller, tiled or mean-pooled to num_tokens, and are projected with the same
    proj_in as x.

The JAX `attention_pool2d` is not on the PT path and is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from visper_lm_tpu_torch.config import ResamplerConfig
from visper_lm_tpu_torch.utils.param import LayerNorm


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int, heads: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = dim_head * heads
        self.dim_head, self.heads = dim_head, heads
        self.norm1 = LayerNorm(dim, **kw)
        self.norm2 = LayerNorm(dim, **kw)
        self.to_q = nn.Linear(dim, inner, bias=False, **kw)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False, **kw)
        self.to_out = nn.Linear(inner, dim, bias=False, **kw)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        """x (B, N1, D) features, latents (B, N2, D) -> (B, N2, D)."""
        x = self.norm1(x)
        latents = self.norm2(latents)
        b, n_lat, _ = latents.shape
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)

        def heads_split(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, t.shape[1], self.heads, self.dim_head).transpose(1, 2)

        q, k, v = heads_split(q), heads_split(k), heads_split(v)
        scale = float(self.dim_head) ** -0.25
        w = torch.einsum("bhld,bhnd->bhln", q.float() * scale, k.float() * scale)
        w = torch.softmax(w, dim=-1).to(v.dtype)
        out = torch.einsum("bhln,bhnd->bhld", w, v)
        return self.to_out(out.transpose(1, 2).reshape(b, n_lat, self.heads * self.dim_head))


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = int(dim * mult)
        self.norm = LayerNorm(dim, **kw)
        self.fc1 = nn.Linear(dim, inner, bias=False, **kw)
        self.fc2 = nn.Linear(inner, dim, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.norm(x)), approximate="none"))


class ResamplerLayer(nn.Module):
    def __init__(self, dim: int, cfg: ResamplerConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn = PerceiverAttention(dim, cfg.dim_head, cfg.num_heads, **kw)
        self.ff = FeedForward(dim, cfg.ff_mult, **kw)


class Resampler(nn.Module):
    """JAX `init_resampler` params; its forward is JAX `resampler_forward`.

    inner_dim defaults to cfg.output_dim (the task-token depth head runs at
    the LLM width instead). task_token=True drops the learned latents."""

    def __init__(
        self, cfg: ResamplerConfig, embedding_dim: int, *, task_token: bool = False,
        inner_dim: Optional[int] = None, device=None, dtype=None,
    ):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        dim = inner_dim if inner_dim is not None else cfg.output_dim
        self.cfg = cfg
        self.proj_in = nn.Linear(embedding_dim, dim, **kw)
        self.proj_out = nn.Linear(dim, cfg.output_dim, **kw)
        self.norm_out = LayerNorm(cfg.output_dim, **kw)
        self.layers = nn.ModuleList(ResamplerLayer(dim, cfg, **kw) for _ in range(cfg.depth))
        self.latents = (
            None if task_token else nn.Parameter(torch.zeros(cfg.num_tokens, dim, **kw))
        )

    def forward(
        self,
        x: torch.Tensor,                          # (B, N, embedding_dim)
        latents: Optional[torch.Tensor] = None,   # (B, M, embedding_dim), task-token mode
    ) -> torch.Tensor:
        """-> (B, num_tokens, output_dim)."""
        cfg = self.cfg
        b = x.shape[0]
        if latents is None:
            lat = self.latents.expand(b, *self.latents.shape)
        else:
            m = latents.shape[1]
            if m != cfg.num_tokens:
                if cfg.num_tokens > 1 and cfg.num_tokens % m == 0:
                    latents = latents.repeat(1, cfg.num_tokens // m, 1)
                else:
                    latents = latents.mean(dim=1, keepdim=True).expand(
                        b, cfg.num_tokens, latents.shape[-1]
                    )
            lat = self.proj_in(latents)
        x = self.proj_in(x)
        for layer in self.layers:
            lat = layer.attn(x, lat) + lat
            lat = layer.ff(lat) + lat
        return self.norm_out(self.proj_out(lat))
