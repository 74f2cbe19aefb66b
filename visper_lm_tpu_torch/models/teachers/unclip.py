"""unCLIP generation teacher: CLIP-ViT-H/14 image encoder -> 1024-d image
embedding (counterpart of visper_lm_tpu/models/teachers/unclip.py).
`unclip_preprocess_np` is its host pixel pipeline in plain numpy (a stock
CLIPImageProcessor at 224); `import_clip_h` reads diffusers' image_encoder."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from visper_lm_tpu_torch.config import CLIP_VIT_H_224, VisionConfig
from visper_lm_tpu_torch.data.mm_utils import clip_preprocess
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


def unclip_preprocess_np(image) -> np.ndarray:
    """The pipe's feature extractor: CLIP preprocessing at 224 (shortest-edge
    bicubic resize, centre crop, CLIP normalize); f32 (224, 224, 3)."""
    return clip_preprocess(image, size=224)


def import_clip_h(
    sd: Mapping[str, object], cfg: VisionConfig = CLIP_VIT_H_224
) -> Dict[str, torch.Tensor]:
    """diffusers' pipe.image_encoder (CLIPVisionModelWithProjection) weights
    -> `VisionTower` state-dict names, the visual projection included."""
    from visper_lm_tpu_torch.checkpoint.hf_import import as_state_dict, import_clip_vision

    return import_clip_vision(as_state_dict(sd), cfg, prefix="vision_model.")
