"""DINOv2 ViT-L/14, the Depth-Anything-V2 depth teacher (counterpart of
visper_lm_tpu/models/teachers/dinov2.py).

The generic ViT (models/vit.py) with layerscale, no CLIP pre-norm and eps
1e-6. Distillation target: the mean of the final-normed patch tokens of
intermediate layers [4, 11, 17, 23] on a 336 x 336 input -> (B, 576, 1024) f32.
`dav2_preprocess_np` is the host pixel pipeline in plain numpy (PIL's bicubic
resize, data/mm_utils.py); `import_dav2_dinov2` reads a Depth-Anything-V2
checkpoint's `pretrained.*` weights.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from visper_lm_tpu_torch.config import DINOV2_VIT_L, VisionConfig
from visper_lm_tpu_torch.data.mm_utils import IMAGENET_MEAN, IMAGENET_STD, resize_bicubic, to_rgb_array
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


def dav2_preprocess_np(image, flip_channels: bool = True) -> np.ndarray:
    """The DAv2 teacher's pixels (its image2tensor at input size 336): a
    uint8 image resized to 336 x 336 (bicubic, as PIL's default), the
    reference's BGR swap, ImageNet normalize; f32 (336, 336, 3)."""
    arr = resize_bicubic(to_rgb_array(image), (336, 336)).astype(np.float32)
    if flip_channels:
        arr = arr[..., ::-1]
    arr = arr / 255.0
    return (arr - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(IMAGENET_STD, np.float32)


def import_dav2_dinov2(
    sd: Mapping[str, object], cfg: VisionConfig = DINOV2_VIT_L
) -> Dict[str, torch.Tensor]:
    """A Depth-Anything-V2 checkpoint's `pretrained.*` DINOv2 weights (torch
    tensors or numpy arrays) -> `VisionTower` state-dict names. The 37 x 37
    (518 px) position grid is interpolated to the config's grid once here,
    as the teacher always runs at one size."""
    from visper_lm_tpu_torch.checkpoint.hf_import import _lin, _ln, as_state_dict
    from visper_lm_tpu_torch.utils.image import resize_bicubic_pos_embed

    sd = as_state_dict(sd)
    p = "pretrained."
    d = cfg.hidden_size
    pos = sd[p + "pos_embed"][0]                                    # (1 + N, D)
    src_grid = int(round((pos.shape[0] - 1) ** 0.5))
    out: Dict[str, torch.Tensor] = {
        "patch_embed.weight": sd[p + "patch_embed.proj.weight"].reshape(d, -1),
        "patch_embed.bias": sd[p + "patch_embed.proj.bias"],
        "cls_token": sd[p + "cls_token"].reshape(-1),
        "pos_embed": resize_bicubic_pos_embed(pos, src_grid, cfg.num_patches_per_side),
    }
    _ln(out, "final_norm", sd, p + "norm")
    i = 0
    while f"{p}blocks.{i}.norm1.weight" in sd:
        lp, bp = f"{p}blocks.{i}.", f"blocks.{i}."
        _ln(out, bp + "norm1", sd, lp + "norm1")
        _lin(out, bp + "qkv", sd, lp + "attn.qkv")
        _lin(out, bp + "proj", sd, lp + "attn.proj")
        out[bp + "ls1.gamma"] = sd[lp + "ls1.gamma"]
        _ln(out, bp + "norm2", sd, lp + "norm2")
        _lin(out, bp + "fc1", sd, lp + "mlp.fc1")
        _lin(out, bp + "fc2", sd, lp + "mlp.fc2")
        out[bp + "ls2.gamma"] = sd[lp + "ls2.gamma"]
        i += 1
    return out
