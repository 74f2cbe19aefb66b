"""The AutoencoderKL decoder of SD-2.1: latents (B, h, w, 4) -> RGB (B, 8h,
8w, 3), NHWC (counterpart of visper_lm_tpu/models/genpipe/vae.py).

The stable-diffusion-2-1-unclip `vae/config.json`: block_out_channels (128,
256, 512, 512), layers_per_block 2 (the decoder's up blocks run 3 resnets),
GroupNorm(32, eps 1e-6), SiLU, a mid block with one single-head
self-attention, scaling_factor 0.18215. Only the decoder: post_quant_conv ->
conv_in -> mid -> the upsampling levels -> norm / SiLU -> conv_out.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from visper_lm_tpu_torch.models.genpipe.unet import (
    GroupNorm,
    Level,
    Mid,
    ResnetBlock,
    _conv,
    group_norm,
    resnet_block,
    upsample_nearest2x,
)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2  # the decoder's up blocks run layers_per_block + 1 resnets
    norm_groups: int = 32
    norm_eps: float = 1e-6
    out_channels: int = 3
    scaling_factor: float = 0.18215


class MidAttention(nn.Module):
    """The VAE's single-head spatial self-attention (diffusers AttnBlock)."""

    def __init__(self, c: int, **kw):
        super().__init__()
        self.norm = GroupNorm(c, **kw)
        self.q, self.k, self.v, self.o = (nn.Linear(c, c, **kw) for _ in range(4))


def _mid_attention(p: MidAttention, cfg: VAEConfig, x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    n = group_norm(p.norm, x, cfg.norm_groups, cfg.norm_eps).reshape(b, h * w, c)
    q, k, v = p.q(n), p.k(n), p.v(n)
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(c)
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    return x + p.o(torch.matmul(probs, v)).reshape(b, h, w, c)


class VAEDecoder(nn.Module):
    """JAX `init_vae_decoder`'s tree: post_quant_conv, conv_in, mid, up
    (deepest level first), conv_norm_out, conv_out."""

    def __init__(self, cfg: VAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ch = list(reversed(cfg.block_out_channels))
        cdeep = ch[0]
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1, **kw)
        self.conv_in = nn.Conv2d(cfg.latent_channels, cdeep, 3, **kw)
        self.mid = Mid(ResnetBlock(cdeep, cdeep, **kw), MidAttention(cdeep, **kw),
                       ResnetBlock(cdeep, cdeep, **kw))
        up, cin = [], cdeep
        for j, cout in enumerate(ch):
            resnets = [ResnetBlock(cin if i == 0 else cout, cout, **kw)
                       for i in range(cfg.layers_per_block + 1)]
            up.append(Level(resnets, [], "upsample" if j < len(ch) - 1 else "", cout, **kw))
            cin = cout
        self.up = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(cfg.block_out_channels[0], **kw)
        self.conv_out = nn.Conv2d(cfg.block_out_channels[0], cfg.out_channels, 3, **kw)


def vae_decode(p: VAEDecoder, cfg: VAEConfig, latents: torch.Tensor) -> torch.Tensor:
    """Scaled latents (B, h, w, 4) -> RGB in [0, 1], in the decoder's dtype."""
    g, eps = cfg.norm_groups, cfg.norm_eps
    z = latents.to(p.conv_in.weight.dtype) / cfg.scaling_factor
    z = _conv(p.post_quant_conv, z, padding=0)
    h = _conv(p.conv_in, z)
    h = resnet_block(p.mid.resnet1, h, None, g, eps)
    h = _mid_attention(p.mid.attn, cfg, h)
    h = resnet_block(p.mid.resnet2, h, None, g, eps)
    for blk in p.up:
        for res in blk.resnets:
            h = resnet_block(res, h, None, g, eps)
        if hasattr(blk, "upsample"):
            h = _conv(blk.upsample, upsample_nearest2x(h))
    h = group_norm(p.conv_norm_out, h, g, eps)
    h = _conv(p.conv_out, F.silu(h))
    return torch.clamp(h * 0.5 + 0.5, 0.0, 1.0)
