"""Generic ViT image encoder (counterpart of visper_lm_tpu/models/vit.py).

One module covers the three towers of the PT step, by config and flags:
  * CLIP-ViT-L/14-336, the student's tower: class token, pre-norm, quick_gelu,
    `clip_tower_features` (select hidden layer -2, drop CLS);
  * DINOv2 ViT-L/14, the depth teacher: no pre-norm, layerscale (`ls1`/`ls2`),
    exact gelu, eps 1e-6;
  * CLIP-ViT-H/14-224, the generation teacher: adds the visual projection of
    the final-normed CLS token (`cls` output).
Patchify is one matmul. Attention is plain PyTorch, as the JAX tower leaves it
to XLA.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from visper_lm_tpu_torch.config import VisionConfig
from visper_lm_tpu_torch.ops.attention import mha_plain
from visper_lm_tpu_torch.utils.param import ACTIVATIONS, LayerNorm, init_weights_


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, N, 3*p*p), channel-major within the patch (c, ph, pw),
    matching a Conv2d(3, D, p, stride=p) weight flattened."""
    b, h, w, c = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (B, gh, gw, C, ph, pw)
    return x.reshape(b, gh * gw, c * patch_size * patch_size)


class LayerScale(nn.Module):
    """DINOv2 layerscale {gamma} (JAX `ls1`/`ls2`), init 1e-5."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-5, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class ViTBlock(nn.Module):
    def __init__(self, cfg: VisionConfig, use_layerscale: bool = False, device=None, dtype=None):
        super().__init__()
        h, m = cfg.hidden_size, cfg.mlp_dim
        kw = dict(device=device, dtype=dtype)
        self.num_heads = cfg.num_heads
        self.act = ACTIVATIONS[cfg.hidden_act]
        self.norm1 = LayerNorm(h, cfg.norm_eps, **kw)
        self.qkv = nn.Linear(h, 3 * h, **kw)
        self.proj = nn.Linear(h, h, **kw)
        self.norm2 = LayerNorm(h, cfg.norm_eps, **kw)
        self.fc1 = nn.Linear(h, m, **kw)
        self.fc2 = nn.Linear(m, h, **kw)
        self.ls1 = LayerScale(h, **kw) if use_layerscale else None
        self.ls2 = LayerScale(h, **kw) if use_layerscale else None

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, n, d = h.shape
        nh = self.num_heads
        qkv = self.qkv(self.norm1(h)).reshape(b, n, 3, nh, d // nh)
        attn = mha_plain(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=False)
        attn = self.proj(attn.reshape(b, n, d))
        if self.ls1 is not None:
            attn = self.ls1(attn)
        h = h + attn
        y = self.fc2(self.act(self.fc1(self.norm2(h))))
        if self.ls2 is not None:
            y = self.ls2(y)
        return h + y


class VisionTower(nn.Module):
    """ViT with a class token (JAX `init_vit` params + `vit_forward`).

    use_layerscale adds DINOv2's ls1/ls2; projection_dim adds CLIP's
    visual_projection (no bias) of the final-normed CLS token."""

    def __init__(
        self, cfg: VisionConfig, *, use_layerscale: bool = False,
        projection_dim: Optional[int] = None, device=None, dtype=None,
    ):
        super().__init__()
        if not cfg.use_class_token:
            raise NotImplementedError("towers without a class token are not ported yet")
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.cfg = cfg
        self.patch_embed = nn.Linear(3 * cfg.patch_size ** 2, h, **kw)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.num_patches + 1, h, **kw))
        self.cls_token = nn.Parameter(torch.zeros(h, **kw))
        self.pre_norm = LayerNorm(h, cfg.norm_eps, **kw) if cfg.use_pre_norm else None
        self.blocks = nn.ModuleList(
            ViTBlock(cfg, use_layerscale, **kw) for _ in range(cfg.num_layers)
        )
        self.final_norm = LayerNorm(h, cfg.norm_eps, **kw)
        self.visual_projection = (
            None if projection_dim is None
            else nn.Linear(h, projection_dim, bias=False, **kw)
        )

    def forward(
        self,
        images: torch.Tensor,                      # (B, H, W, 3), already normalized
        *,
        output_layers: Optional[Sequence[int]] = None,
        final_norm: bool = True,
    ) -> Dict[str, object]:
        """JAX `vit_forward`: {'taps': {layer: block output}, and with
        final_norm 'last' (post final norm) and 'cls' (its CLS token, through
        the visual projection when there is one)}. With final_norm=False the
        blocks after the last tapped layer are skipped."""
        cfg = self.cfg
        x = patchify(images.to(self.patch_embed.weight.dtype), cfg.patch_size)
        h = self.patch_embed(x)
        cls = self.cls_token.expand(h.shape[0], 1, h.shape[-1])
        h = torch.cat([cls, h], dim=1) + self.pos_embed[None]
        if self.pre_norm is not None:
            h = self.pre_norm(h)

        want = sorted(set(output_layers or ()))
        if want and max(want) >= cfg.num_layers:
            raise ValueError(f"tap layer {max(want)} out of range for {cfg.num_layers} layers")
        n_run = cfg.num_layers
        if want and not final_norm:
            n_run = max(want) + 1
        taps = {}
        for i in range(n_run):
            h = self.blocks[i](h)
            if i in want:
                taps[i] = h
        out: Dict[str, object] = {"taps": taps}
        if final_norm:
            h = self.final_norm(h)
            out["last"] = h
            cls_tok = h[:, 0]
            if self.visual_projection is not None:
                cls_tok = self.visual_projection(cls_tok)
            out["cls"] = cls_tok
        return out


@torch.no_grad()
def init_tower_(tower: VisionTower, generator: torch.Generator) -> None:
    """Seeded random init in place with JAX `init_vit`'s values: linears
    uniform, norms 1/0, position embedding and class token 0, layerscale 1e-5."""
    init_weights_(tower, generator)
    tower.pos_embed.zero_()
    tower.cls_token.zero_()
    for m in tower.modules():
        if isinstance(m, LayerScale):
            m.gamma.fill_(1e-5)


def clip_tower_features(tower: VisionTower, images: torch.Tensor) -> torch.Tensor:
    """CLIPVisionTower features: the select_layer block output, CLS dropped
    for select_feature 'patch' -> (B, num_patches, hidden)."""
    cfg = tower.cfg
    layer = cfg.select_layer if cfg.select_layer >= 0 else cfg.num_layers + cfg.select_layer
    feats = tower(images, output_layers=(layer,), final_norm=False)["taps"][layer]
    if cfg.select_feature == "patch":
        return feats[:, 1:]
    if cfg.select_feature == "cls_patch":
        return feats
    raise ValueError(f"Unexpected select_feature: {cfg.select_feature}")
