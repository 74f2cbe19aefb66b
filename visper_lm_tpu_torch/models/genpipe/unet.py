"""UNet2DConditionModel of SD-2.1-unclip, NHWC (counterpart of
visper_lm_tpu/models/genpipe/unet.py).

The stabilityai/stable-diffusion-2-1-unclip `unet/config.json`: in / out
channels 4, block_out_channels (320, 640, 1280, 1280), down = 3 x
CrossAttnDownBlock2D + DownBlock2D, mid = UNetMidBlock2DCrossAttn, up =
UpBlock2D + 3 x CrossAttnUpBlock2D, layers_per_block 2, cross_attention_dim
1024, attention_head_dim (5, 10, 20, 20) (diffusers' name; it is the number
of heads), linear projections, class_embed_type 'projection' over [CLIP
image embedding | noise-level embedding] (2048), GroupNorm(32), SiLU, eps 1e-5.

The modules hold the JAX tree's names (`weights.genpipe_from_jax_params`).
Convolutions are `utils.image.conv2d` on the modules' weights; attention is
`torch.matmul` and `softmax`, as the JAX package leaves it to XLA's einsum
(no Pallas kernel): the scores in q's dtype, upcast to f32 for the softmax,
the probabilities cast back. GroupNorm statistics are f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from visper_lm_tpu_torch.utils.image import conv2d
from visper_lm_tpu_torch.utils.param import LayerNorm


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: Tuple[int, ...] = (5, 10, 20, 20)
    # the levels with cross-attention transformers (SD-2.1: all but the innermost)
    cross_attn_levels: Tuple[bool, ...] = (True, True, True, False)
    norm_groups: int = 32
    norm_eps: float = 1e-5
    time_embed_mult: int = 4  # time_embed_dim = block_out[0] * 4
    projection_class_embeddings_input_dim: int = 2048
    sample_size: int = 96

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * self.time_embed_mult


# ---------------------------------------------------------------- primitives


class GroupNorm(nn.Module):
    """{scale, bias} of a GroupNorm (JAX `init_group_norm`); the group count
    and eps are the caller's (`group_norm`)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))


def group_norm(p: GroupNorm, x: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over channel-last x (B, ..., C), statistics and affine in
    f32, cast back to x's dtype."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.float().reshape(b, -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    out = xg.reshape(x.shape) * p.scale.float() + p.bias.float()
    return out.to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int, *, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """diffusers get_timestep_embedding: t (B,) -> (B, dim), f32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.exp(exponent)
    args = t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, Nq, C) x (B, Nk, C) -> (B, Nq, C), C = heads x hd: scores in q's
    dtype divided by sqrt(hd), softmax in f32, probabilities in q's dtype."""
    b, nq, c = q.shape
    nk = k.shape[1]
    hd = c // heads
    q = q.reshape(b, nq, heads, hd).transpose(1, 2)
    k = k.reshape(b, nk, heads, k.shape[-1] // heads).transpose(1, 2)
    v = v.reshape(b, nk, heads, v.shape[-1] // heads).transpose(1, 2)
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, v).transpose(1, 2).reshape(b, nq, c)


def _conv(conv: nn.Conv2d, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    return conv2d(x, conv.weight, conv.bias, stride=stride, padding=padding)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """jax.image.resize(method="nearest") to twice the size of an NHWC map."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


# ------------------------------------------------------------------- resnet


class ResnetBlock(nn.Module):
    """GroupNorm, SiLU, 3x3 conv, the time embedding (temb_dim > 0), again;
    a 1x1 conv_shortcut where cin != cout (the VAE's blocks have no time
    embedding)."""

    def __init__(self, cin: int, cout: int, temb_dim: int = 0, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = GroupNorm(cin, **kw)
        self.conv1 = nn.Conv2d(cin, cout, 3, **kw)
        self.time_emb_proj = nn.Linear(temb_dim, cout, **kw) if temb_dim else None
        self.norm2 = GroupNorm(cout, **kw)
        self.conv2 = nn.Conv2d(cout, cout, 3, **kw)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1, **kw) if cin != cout else None


def resnet_block(p: ResnetBlock, x: torch.Tensor, temb, groups: int, eps: float) -> torch.Tensor:
    h = _conv(p.conv1, F.silu(group_norm(p.norm1, x, groups, eps)))
    if p.time_emb_proj is not None:
        h = h + p.time_emb_proj(F.silu(temb))[:, None, None, :]
    h = _conv(p.conv2, F.silu(group_norm(p.norm2, h, groups, eps)))
    if p.conv_shortcut is not None:
        x = _conv(p.conv_shortcut, x, padding=0)
    return x + h


# -------------------------------------------------------------- transformer


class Attention(nn.Module):
    """to_q / to_k / to_v without bias, to_out with bias."""

    def __init__(self, dim: int, kv_dim: int, **kw):
        super().__init__()
        self.q = nn.Linear(dim, dim, bias=False, **kw)
        self.k = nn.Linear(kv_dim, dim, bias=False, **kw)
        self.v = nn.Linear(kv_dim, dim, bias=False, **kw)
        self.o = nn.Linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor, heads: int) -> torch.Tensor:
        return self.o(attention(self.q(x), self.k(ctx), self.v(ctx), heads))


class TransformerBlock(nn.Module):
    """BasicTransformerBlock: self-attention, cross-attention and a GEGLU
    feed-forward, each pre-LayerNorm."""

    def __init__(self, dim: int, cross_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = LayerNorm(dim, **kw)
        self.attn1 = Attention(dim, dim, **kw)
        self.norm2 = LayerNorm(dim, **kw)
        self.attn2 = Attention(dim, cross_dim, **kw)
        self.norm3 = LayerNorm(dim, **kw)
        self.ff_in = nn.Linear(dim, dim * 8, **kw)       # GEGLU: 2 x 4 x dim
        self.ff_out = nn.Linear(dim * 4, dim, **kw)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor, heads: int) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.attn1(h, h, heads)
        x = x + self.attn2(self.norm2(x), ctx, heads)
        a, gate = self.ff_in(self.norm3(x)).chunk(2, dim=-1)
        return x + self.ff_out(a * F.gelu(gate, approximate="none"))


class SpatialTransformer(nn.Module):
    """Transformer2DModel with use_linear_projection (SD-2.x)."""

    def __init__(self, dim: int, cross_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = GroupNorm(dim, **kw)
        self.proj_in = nn.Linear(dim, dim, **kw)
        self.block = TransformerBlock(dim, cross_dim, **kw)
        self.proj_out = nn.Linear(dim, dim, **kw)


def spatial_transformer(p: SpatialTransformer, cfg: UNetConfig, x: torch.Tensor,
                        ctx: torch.Tensor, heads: int) -> torch.Tensor:
    b, hgt, wid, c = x.shape
    h = group_norm(p.norm, x, cfg.norm_groups, cfg.norm_eps).reshape(b, hgt * wid, c)
    h = p.proj_out(p.block(p.proj_in(h), ctx, heads))
    return x + h.reshape(b, hgt, wid, c)


# ------------------------------------------------------------------- blocks


class Level(nn.Module):
    """One resolution level: resnets, attentions (empty where the level has
    no cross-attention), and a downsample (down path) or upsample (up path)
    3x3 conv, or neither."""

    def __init__(self, resnets, attentions, resample: str = "", channels: int = 0, **kw):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if resample:
            setattr(self, resample, nn.Conv2d(channels, channels, 3, **kw))


class TwoLinear(nn.Module):
    """linear_1 -> SiLU -> linear_2 (the time and class embeddings)."""

    def __init__(self, din: int, dout: int, **kw):
        super().__init__()
        self.linear_1 = nn.Linear(din, dout, **kw)
        self.linear_2 = nn.Linear(dout, dout, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class Mid(nn.Module):
    def __init__(self, resnet1: nn.Module, attn: nn.Module, resnet2: nn.Module):
        super().__init__()
        self.resnet1, self.attn, self.resnet2 = resnet1, attn, resnet2


class UNet(nn.Module):
    """JAX `init_unet`'s tree: conv_in, time_embedding, class_embedding,
    down (per level), mid, up (in execution order, deepest level first),
    conv_norm_out, conv_out."""

    def __init__(self, cfg: UNetConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        ch = cfg.block_out_channels
        c0, temb, xdim = ch[0], cfg.time_embed_dim, cfg.cross_attention_dim
        n = len(ch)
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, **kw)
        self.time_embedding = TwoLinear(c0, temb, **kw)
        self.class_embedding = TwoLinear(cfg.projection_class_embeddings_input_dim, temb, **kw)
        down = []
        for level in range(n):
            cin, cout = (c0 if level == 0 else ch[level - 1]), ch[level]
            resnets = [ResnetBlock(cin if i == 0 else cout, cout, temb, **kw)
                       for i in range(cfg.layers_per_block)]
            attns = ([SpatialTransformer(cout, xdim, **kw) for _ in range(cfg.layers_per_block)]
                     if cfg.cross_attn_levels[level] else [])
            down.append(Level(resnets, attns, "downsample" if level < n - 1 else "", cout, **kw))
        self.down = nn.ModuleList(down)
        self.mid = Mid(ResnetBlock(ch[-1], ch[-1], temb, **kw),
                       SpatialTransformer(ch[-1], xdim, **kw),
                       ResnetBlock(ch[-1], ch[-1], temb, **kw))
        up = []
        for level in reversed(range(n)):
            nb = cfg.layers_per_block + 1
            cout, prev = ch[level], ch[min(level + 1, n - 1)]
            skip_in = ch[max(level - 1, 0)]
            resnets = [ResnetBlock((prev if i == 0 else cout) + (cout if i < nb - 1 else skip_in),
                                   cout, temb, **kw) for i in range(nb)]
            attns = ([SpatialTransformer(cout, xdim, **kw) for _ in range(nb)]
                     if cfg.cross_attn_levels[level] else [])
            up.append(Level(resnets, attns, "upsample" if level > 0 else "", cout, **kw))
        self.up = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(c0, **kw)
        self.conv_out = nn.Conv2d(c0, cfg.out_channels, 3, **kw)


def unet_forward(
    p: UNet,
    cfg: UNetConfig,
    sample: torch.Tensor,                  # (B, H, W, 4) noisy latents
    timestep: torch.Tensor,                # () or (B,)
    encoder_hidden_states: torch.Tensor,   # (B, 77, cross_dim) text states
    class_labels: torch.Tensor,            # (B, proj_dim) image-embedding conditioning
) -> torch.Tensor:
    """The v (or epsilon) prediction, the sample's shape, in the UNet's dtype."""
    g, eps = cfg.norm_groups, cfg.norm_eps
    b = sample.shape[0]
    dtype = p.conv_in.weight.dtype
    t = torch.as_tensor(timestep, device=sample.device).reshape(-1).expand(b)
    temb = p.time_embedding(timestep_embedding(t, cfg.block_out_channels[0]).to(dtype))
    emb = temb + p.class_embedding(class_labels.to(dtype))
    ctx = encoder_hidden_states.to(dtype)
    h = _conv(p.conv_in, sample.to(dtype))

    skips: List[torch.Tensor] = [h]
    for level, blk in enumerate(p.down):
        heads = cfg.attention_head_dim[level]
        for i, res in enumerate(blk.resnets):
            h = resnet_block(res, h, emb, g, eps)
            if cfg.cross_attn_levels[level]:
                h = spatial_transformer(blk.attentions[i], cfg, h, ctx, heads)
            skips.append(h)
        if hasattr(blk, "downsample"):
            h = _conv(blk.downsample, h, stride=2)
            skips.append(h)

    h = resnet_block(p.mid.resnet1, h, emb, g, eps)
    h = spatial_transformer(p.mid.attn, cfg, h, ctx, cfg.attention_head_dim[-1])
    h = resnet_block(p.mid.resnet2, h, emb, g, eps)

    n = len(cfg.block_out_channels)
    for up_idx, blk in enumerate(p.up):
        level = n - 1 - up_idx
        heads = cfg.attention_head_dim[level]
        for i, res in enumerate(blk.resnets):
            h = resnet_block(res, torch.cat([h, skips.pop()], dim=-1), emb, g, eps)
            if cfg.cross_attn_levels[level]:
                h = spatial_transformer(blk.attentions[i], cfg, h, ctx, heads)
        if hasattr(blk, "upsample"):
            h = _conv(blk.upsample, upsample_nearest2x(h))

    h = group_norm(p.conv_norm_out, h, g, eps)
    return _conv(p.conv_out, F.silu(h))
