"""unCLIP generation teacher: CLIP-ViT-H/14 image encoder -> 1024-d image
embedding (counterpart of visper_lm_tpu/models/teachers/unclip.py)."""

from __future__ import annotations

import torch

from visper_lm_tpu_torch.config import CLIP_VIT_H_224, VisionConfig
from visper_lm_tpu_torch.models.vit import VisionTower

GEN_EMBED_DIM = 1024


def init_clip_h(
    cfg: VisionConfig = CLIP_VIT_H_224, projection_dim: int = GEN_EMBED_DIM,
    device=None, dtype=None,
) -> VisionTower:
    """The CLIP-H tower module with its visual projection."""
    return VisionTower(cfg, projection_dim=projection_dim, device=device, dtype=dtype)


def gen_target(tower: VisionTower, images: torch.Tensor) -> torch.Tensor:
    """(B, 1, 1024) f32: the projected CLS embedding."""
    return tower(images, final_norm=True)["cls"][:, None, :].float()
