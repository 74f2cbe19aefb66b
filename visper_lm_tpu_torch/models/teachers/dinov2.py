"""DINOv2 ViT-L/14, the Depth-Anything-V2 depth teacher (counterpart of
visper_lm_tpu/models/teachers/dinov2.py).

The generic ViT (models/vit.py) with layerscale, no CLIP pre-norm and eps
1e-6. Distillation target: the mean of the final-normed patch tokens of
intermediate layers [4, 11, 17, 23] on a 336 x 336 input -> (B, 576, 1024) f32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from visper_lm_tpu_torch.config import DINOV2_VIT_L, VisionConfig
from visper_lm_tpu_torch.models.vit import VisionTower

DAV2_INTERMEDIATE_LAYERS = (4, 11, 17, 23)


def init_dinov2(cfg: VisionConfig = DINOV2_VIT_L, device=None, dtype=None) -> VisionTower:
    """The DINOv2 tower module (weights set by the caller's init or import)."""
    return VisionTower(cfg, use_layerscale=True, device=device, dtype=dtype)


def dinov2_intermediate_features(
    tower: VisionTower, images: torch.Tensor, layers: Optional[Sequence[int]] = None
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per layer: (patch tokens (B, N, D), cls (B, D)), final norm applied.
    Towers shallower than 24 layers tap 4 evenly spaced layers."""
    cfg = tower.cfg
    if layers is None:
        if cfg.num_layers >= 24:
            layers = DAV2_INTERMEDIATE_LAYERS
        else:
            n = min(4, cfg.num_layers)
            layers = sorted({round((i + 1) * cfg.num_layers / n) - 1 for i in range(n)})
    out = tower(images, output_layers=tuple(layers), final_norm=False)
    results = []
    for layer in layers:
        h = tower.final_norm(out["taps"][layer])
        results.append((h[:, 1:], h[:, 0]))
    return results


def dav2_depth_target(tower: VisionTower, images: torch.Tensor) -> torch.Tensor:
    """(B, 576, 1024) f32: the mean of the 4 intermediate layers."""
    feats = dinov2_intermediate_features(tower, images)
    return torch.stack([f[0] for f in feats]).float().mean(dim=0)
