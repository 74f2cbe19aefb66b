"""Swin Transformer backbone, the OneFormer segmentation teacher's encoder
(counterpart of visper_lm_tpu/models/teachers/swin.py).

The seg distillation target is the Swin-L stage-4 feature map at 24 x 24
(768 px input). Swin-L: embed_dim 192, depths (2, 2, 18, 2), heads
(6, 12, 24, 48), window 12. Odd blocks of a stage are shifted by ws / 2 where
min(h, w) > ws (stage 4 at 24 x 24 still is): a static roll plus an additive
(-100) mask. Relative position biases are gathered from the (2ws - 1)^2 table
with a static index. Window attention goes through ops/window_attention.py
(the B4 kernel on CUDA). The patch embedding is `F.conv2d`, as the JAX
package leaves its conv to XLA; its weight is OIHW (JAX: HWIO).
`import_swin_backbone` reads an HF OneFormer / Swin backbone state dict;
`seg_preprocess_np` is the seg teacher's host pixels in plain numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from visper_lm_tpu_torch.ops.window_attention import window_attention
from visper_lm_tpu_torch.utils.param import LayerNorm, init_weights_


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 12
    patch_size: int = 4
    mlp_ratio: float = 4.0
    norm_eps: float = 1e-5
    dtype: str = "float32"

    def stage_dim(self, i: int) -> int:
        return self.embed_dim * (2 ** i)


SWIN_L = SwinConfig()


def _rel_pos_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) indices into the (2ws-1)^2 relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)   # (N, N, 2)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, N, N) additive mask (0 / -100) against cross-window attention after the roll."""
    img_mask = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wslice in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wslice] = cnt
            cnt += 1
    windows = img_mask.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = windows[:, None, :] - windows[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_merge(x: torch.Tensor, ws: int, b: int, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cfg: SwinConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ws = cfg.window_size
        hidden = int(dim * cfg.mlp_ratio)
        self.heads = heads
        self.norm1 = LayerNorm(dim, cfg.norm_eps, **kw)
        self.qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        self.rel_bias = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, heads, **kw))
        self.norm2 = LayerNorm(dim, cfg.norm_eps, **kw)
        self.fc1 = nn.Linear(dim, hidden, **kw)
        self.fc2 = nn.Linear(hidden, dim, **kw)

    def forward(
        self,
        x: torch.Tensor,                        # (B, H, W, C)
        ws: int,
        shift: int,                             # 0 for unshifted blocks
        rel_index: torch.Tensor,                # (N, N) long
        shift_mask: Optional[torch.Tensor],     # (nW, N, N) f32, applied iff shift
        use_kernel: Optional[bool],
    ) -> torch.Tensor:
        """JAX `_swin_block`."""
        b, h, w, c = x.shape
        hd = c // self.heads
        n = ws * ws
        y = self.norm1(x)
        if shift:
            y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
        qkv = self.qkv(_window_partition(y, ws)).reshape(-1, n, 3, self.heads, hd)
        # (W, heads, N, hd) strided views of the packed projection
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        bias = self.rel_bias.float()[rel_index.reshape(-1)]
        bias = bias.reshape(n, n, self.heads).permute(2, 0, 1)          # (heads, N, N)
        out = window_attention(
            q, k, v, bias, shift_mask if shift else None, scale=hd ** -0.5,
            use_kernel=use_kernel,
        )
        out = self.proj(out.transpose(1, 2).reshape(-1, n, c).to(x.dtype))
        out = _window_merge(out, ws, b, h, w)
        if shift:
            out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
        x = x + out
        y = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="none"))
        return x + y


class PatchMerge(nn.Module):
    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps, device=device, dtype=dtype)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """JAX `_patch_merge`, HF Swin concat order [(0,0), (1,0), (0,1), (1,1)]."""
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c)
        x = torch.cat(
            [x[:, :, 0, :, 0], x[:, :, 1, :, 0], x[:, :, 0, :, 1], x[:, :, 1, :, 1]], dim=-1
        )
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, s: int, cfg: SwinConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        dim = cfg.stage_dim(s)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, cfg.num_heads[s], cfg, **kw) for _ in range(cfg.depths[s])
        )
        self.downsample = (
            PatchMerge(dim, cfg.norm_eps, **kw) if s < len(cfg.depths) - 1 else None
        )


class SwinBackbone(nn.Module):
    """JAX `init_swin` params: patch_embed, patch_norm, stages, out_norms."""

    def __init__(self, cfg: SwinConfig = SWIN_L, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.patch_embed = nn.Conv2d(
            3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size, **kw
        )
        self.patch_norm = LayerNorm(cfg.embed_dim, cfg.norm_eps, **kw)
        self.stages = nn.ModuleList(SwinStage(s, cfg, **kw) for s in range(len(cfg.depths)))
        self.out_norms = nn.ModuleList(
            LayerNorm(cfg.stage_dim(s), cfg.norm_eps, **kw) for s in range(len(cfg.depths))
        )


@torch.no_grad()
def init_swin_(model: SwinBackbone, generator: torch.Generator) -> None:
    """Seeded random init in place with JAX `init_swin`'s values: linears and
    the conv uniform(+-1/sqrt(fan_in)) with zero bias, norms 1/0, rel_bias 0."""
    init_weights_(model, generator)
    conv = model.patch_embed
    bound = (conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]) ** -0.5
    conv.weight.uniform_(-bound, bound, generator=generator)
    conv.bias.zero_()
    for m in model.modules():
        if isinstance(m, SwinBlock):
            m.rel_bias.zero_()


def swin_forward(
    model: SwinBackbone,
    images: torch.Tensor,                  # (B, H, W, 3) normalized
    *,
    out_stages: Sequence[int] = (0, 1, 2, 3),
    use_kernel: Optional[bool] = None,
) -> List[torch.Tensor]:
    """Per-stage NORMED feature maps (B, H_s, W_s, C_s) for out_stages."""
    cfg = model.cfg
    x = F.conv2d(
        images.permute(0, 3, 1, 2), model.patch_embed.weight.to(images.dtype),
        model.patch_embed.bias.to(images.dtype), stride=cfg.patch_size,
    ).permute(0, 2, 3, 1)
    x = model.patch_norm(x)
    ws = cfg.window_size
    rel_index = torch.as_tensor(_rel_pos_index(ws), device=x.device)
    outputs: List[torch.Tensor] = []
    for s, stage in enumerate(model.stages):
        h, w = x.shape[1], x.shape[2]
        shift = ws // 2 if min(h, w) > ws else 0
        shift_mask = None
        if shift:
            shift_mask = torch.as_tensor(_shift_attn_mask(h, w, ws, shift), device=x.device)
        for i, block in enumerate(stage.blocks):
            x = block(x, ws, shift if i % 2 == 1 else 0, rel_index, shift_mask, use_kernel)
        if s in out_stages:
            outputs.append(model.out_norms[s](x))
        if stage.downsample is not None:
            x = stage.downsample(x)
    return outputs


def seg_target(
    model: SwinBackbone, images: torch.Tensor, use_kernel: Optional[bool] = None
) -> torch.Tensor:
    """(B, 576, 1536) f32: the stage-4 map flattened row-major."""
    feats = swin_forward(model, images, out_stages=(3,), use_kernel=use_kernel)[0]
    b, h, w, c = feats.shape
    return feats.reshape(b, h * w, c).float()


def seg_preprocess_np(image, size: int = 768) -> np.ndarray:
    """The seg teacher's pixels: a (size, size) bicubic resize (PIL's
    default), ImageNet normalize; f32 (size, size, 3)."""
    from visper_lm_tpu_torch.data.mm_utils import (
        IMAGENET_MEAN, IMAGENET_STD, normalize_image, resize_bicubic, to_rgb_array,
    )

    return normalize_image(resize_bicubic(to_rgb_array(image), (size, size)),
                           IMAGENET_MEAN, IMAGENET_STD)


def import_swin_backbone(
    sd: Mapping[str, object], cfg: SwinConfig, prefix: str
) -> Dict[str, torch.Tensor]:
    """An HF OneFormer / Swin backbone state dict (e.g. prefix
    "pixel_level_module.encoder.") -> `SwinBackbone` state-dict names: the
    query, key and value linears concatenated into qkv."""
    from visper_lm_tpu_torch.checkpoint.hf_import import _lin, _ln, as_state_dict

    sd = as_state_dict(sd)
    emb = prefix + "embeddings."
    out: Dict[str, torch.Tensor] = {
        "patch_embed.weight": sd[emb + "patch_embeddings.projection.weight"],   # OIHW
        "patch_embed.bias": sd[emb + "patch_embeddings.projection.bias"],
    }
    _ln(out, "patch_norm", sd, emb + "norm")
    for s_ in range(len(cfg.depths)):
        sp = f"{prefix}encoder.layers.{s_}."
        for i in range(cfg.depths[s_]):
            bp, op = f"{sp}blocks.{i}.", f"stages.{s_}.blocks.{i}."
            att = bp + "attention."
            for part in ("weight", "bias"):
                out[f"{op}qkv.{part}"] = torch.cat(
                    [sd[f"{att}self.{n}.{part}"] for n in ("query", "key", "value")])
            _ln(out, op + "norm1", sd, bp + "layernorm_before")
            _lin(out, op + "proj", sd, att + "output.dense")
            out[op + "rel_bias"] = sd[att + "self.relative_position_bias_table"]
            _ln(out, op + "norm2", sd, bp + "layernorm_after")
            _lin(out, op + "fc1", sd, bp + "intermediate.dense")
            _lin(out, op + "fc2", sd, bp + "output.dense")
        if f"{sp}downsample.reduction.weight" in sd:
            _ln(out, f"stages.{s_}.downsample.norm", sd, sp + "downsample.norm")
            _lin(out, f"stages.{s_}.downsample.reduction", sd, sp + "downsample.reduction")
    i = 0
    while f"{prefix}hidden_states_norms.stage{i + 1}.weight" in sd:
        _ln(out, f"out_norms.{i}", sd, f"{prefix}hidden_states_norms.stage{i + 1}")
        i += 1
    return out
