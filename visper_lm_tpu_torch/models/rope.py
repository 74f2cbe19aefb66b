"""Rotary position embeddings (NeoX/Llama-style half rotation), computed in f32.

Counterpart of visper_lm_tpu/models/rope.py: inv_freq = theta^(-2i/d), cos/sin
broadcast over both halves, rotate_half(x) = concat(-x[d/2:], x[:d/2]).
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape positions.shape + (head_dim,), float32."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, N, H); cos/sin (B, T, H) or (T, H), broadcast over heads."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def apply_rope_transpose(g: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The vector-Jacobian product of `apply_rope`: g (B, T, N, H), the
    gradient of its output, to the gradient of its input (in g's dtype)."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    gf = g.float()
    gs = gf * sin
    half = g.shape[-1] // 2
    return (gf * cos + torch.cat([gs[..., half:], -gs[..., :half]], dim=-1)).to(g.dtype)
