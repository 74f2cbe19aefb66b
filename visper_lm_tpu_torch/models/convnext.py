"""ConvNeXt trunk: the CLIP-ConvNeXt-XXL high-resolution vision tower
(counterpart of visper_lm_tpu/models/convnext.py).

stem (4x4 conv, stride 4, VALID; LayerNorm) -> four stages (from the second
on, LayerNorm + 2x2 conv stride 2; then blocks of 7x7 depthwise conv ->
LayerNorm -> fc1 (4x) -> exact GELU -> fc2 -> x gamma -> residual) ->
norm_pre on the last map. At 768 px the XXL trunk's final map is
(B, 24, 24, 3072), flattened to 576 tokens.

NHWC throughout, as in the JAX package: the LayerNorms and linears act on
the channel axis with no transposes; the convolutions run on a channels-last
view (utils/image.py). JAX stacks each stage's blocks along a leading depth
axis; the port keeps an `nn.ModuleList` per stage (weights.py unstacks).
The module names are the JAX tree's: stem_conv, stem_norm,
stages.{s}.downsample.{norm,conv}, stages.{s}.blocks.{i}.{dwconv,norm,fc1,
fc2,gamma}, norm_pre.

The trunk runs in its parameters' dtype: images are cast to it on entry, as
the ViT tower casts them (JAX's trunk lets f32 pixels promote a bf16 trunk
to f32; the port's bf16 trunk stays bf16).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from visper_lm_tpu_torch.config import ConvNeXtConfig
from visper_lm_tpu_torch.utils.image import conv2d, depthwise_conv2d, init_conv_, resize_bilinear
from visper_lm_tpu_torch.utils.param import LayerNorm, init_weights_


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dwconv = nn.Conv2d(dim, dim, 7, groups=dim, **kw)      # weight (dim, 1, 7, 7)
        self.norm = LayerNorm(dim, eps, **kw)
        self.fc1 = nn.Linear(dim, 4 * dim, **kw)
        self.fc2 = nn.Linear(4 * dim, dim, **kw)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = depthwise_conv2d(x, self.dwconv.weight, self.dwconv.bias, padding=3)
        y = self.fc2(F.gelu(self.fc1(self.norm(y)), approximate="none"))
        return x + y * self.gamma


class ConvNeXtDownsample(nn.Module):
    """LayerNorm then a 2x2 conv of stride 2 (VALID)."""

    def __init__(self, cin: int, cout: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.norm = LayerNorm(cin, eps, device=device, dtype=dtype)
        self.conv = nn.Conv2d(cin, cout, 2, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(self.norm(x), self.conv.weight, self.conv.bias, stride=2, padding="VALID")


class ConvNeXtStage(nn.Module):
    def __init__(self, cin: Optional[int], dim: int, depth: int, eps: float, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.downsample = None if cin is None else ConvNeXtDownsample(cin, dim, eps, **kw)
        self.blocks = nn.ModuleList(ConvNeXtBlock(dim, eps, **kw) for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        for block in self.blocks:
            x = block(x)
        return x


class ConvNeXt(nn.Module):
    """JAX `init_convnext` params; `convnext_forward` is its forward."""

    def __init__(self, cfg: ConvNeXtConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.stem_conv = nn.Conv2d(3, cfg.dims[0], 4, **kw)
        self.stem_norm = LayerNorm(cfg.dims[0], cfg.norm_eps, **kw)
        self.stages = nn.ModuleList(
            ConvNeXtStage(cfg.dims[s - 1] if s else None, dim, depth, cfg.norm_eps, **kw)
            for s, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims))
        )
        self.norm_pre = LayerNorm(cfg.dims[-1], cfg.norm_eps, **kw)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return convnext_forward(self, images)


@torch.no_grad()
def init_convnext_(tower: ConvNeXt, generator: torch.Generator) -> ConvNeXt:
    """Seeded random init in place with JAX `init_convnext`'s distributions:
    the stem and downsample convs as `init_conv` (uniform, bias 0), the
    depthwise kernels N(0, 0.02) with bias 0, linears uniform, norms 1/0,
    layer-scale gamma 1e-6."""
    init_weights_(tower, generator)
    init_conv_(tower.stem_conv, generator)
    for stage in tower.stages:
        if stage.downsample is not None:
            init_conv_(stage.downsample.conv, generator)
        for block in stage.blocks:
            block.dwconv.weight.normal_(0.0, 0.02, generator=generator)
            block.dwconv.bias.zero_()
            block.gamma.fill_(1e-6)
    return tower


def convnext_forward(
    tower: ConvNeXt, images: torch.Tensor, *, return_stages: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, List[torch.Tensor]]]:
    """images (B, H, W, 3) normalized -> the norm_pre'd final map
    (B, H/32, W/32, C) [and each stage's output map]."""
    x = images.to(tower.stem_conv.weight.dtype)
    x = conv2d(x, tower.stem_conv.weight, tower.stem_conv.bias, stride=4, padding="VALID")
    x = tower.stem_norm(x)
    stages = []
    for stage in tower.stages:
        x = stage(x)
        stages.append(x)
    out = tower.norm_pre(x)
    return (out, stages) if return_stages else out


def convnext_tower_features(
    tower: ConvNeXt, images: torch.Tensor, interp_tokens: Optional[int] = None
) -> torch.Tensor:
    """Tower features (B, N, C), N = (H/32)^2 (576 at 768 px), optionally
    bilinearly resampled (half-pixel, align_corners=False) to interp_tokens."""
    fmap = convnext_forward(tower, images)
    b, h, w, c = fmap.shape
    if interp_tokens is not None and interp_tokens != h * w:
        side = int(round(interp_tokens ** 0.5))
        fmap = resize_bilinear(fmap, (side, side), align_corners=False)
        h = w = side
    return fmap.reshape(b, h * w, c)


# ---------------------------------------------------------------------------
# OpenCLIP / timm key layout
# ---------------------------------------------------------------------------


def import_openclip_convnext(
    sd: Mapping[str, torch.Tensor], cfg: ConvNeXtConfig, prefix: str = "visual.trunk."
) -> Dict[str, torch.Tensor]:
    """An OpenCLIP ConvNeXt trunk state dict (timm keys: stem.{0,1},
    stages.S.downsample.{0,1}, stages.S.blocks.I.{conv_dw,norm,mlp.fc1,
    mlp.fc2,gamma}, norm_pre) -> `ConvNeXt` state-dict names. timm's convs
    and linears are the torch modules' layouts already, so this renames."""
    out: Dict[str, torch.Tensor] = {}

    def take(name: str, key: str, norm: bool = False) -> None:
        out[f"{name}.{'scale' if norm else 'weight'}"] = sd[f"{key}.weight"]
        if f"{key}.bias" in sd:
            out[f"{name}.bias"] = sd[f"{key}.bias"]

    take("stem_conv", prefix + "stem.0")
    take("stem_norm", prefix + "stem.1", norm=True)
    take("norm_pre", prefix + "norm_pre", norm=True)
    for s in range(len(cfg.depths)):
        sp, tp = f"{prefix}stages.{s}.", f"stages.{s}."
        if f"{sp}downsample.1.weight" in sd:
            take(tp + "downsample.norm", sp + "downsample.0", norm=True)
            take(tp + "downsample.conv", sp + "downsample.1")
        for i in range(cfg.depths[s]):
            bp, tb = f"{sp}blocks.{i}.", f"{tp}blocks.{i}."
            take(tb + "dwconv", bp + "conv_dw")
            take(tb + "norm", bp + "norm", norm=True)
            take(tb + "fc1", bp + "mlp.fc1")
            take(tb + "fc2", bp + "mlp.fc2")
            out[tb + "gamma"] = sd[bp + "gamma"]
    return out


def export_openclip_convnext(
    params: Mapping[str, torch.Tensor], cfg: ConvNeXtConfig, prefix: str = "visual.trunk."
) -> Dict[str, torch.Tensor]:
    """Inverse of `import_openclip_convnext`: `ConvNeXt` state-dict names ->
    timm-layout keys under prefix."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key: str, name: str, norm: bool = False) -> None:
        sd[f"{key}.weight"] = params[f"{name}.{'scale' if norm else 'weight'}"]
        if f"{name}.bias" in params:
            sd[f"{key}.bias"] = params[f"{name}.bias"]

    put(prefix + "stem.0", "stem_conv")
    put(prefix + "stem.1", "stem_norm", norm=True)
    put(prefix + "norm_pre", "norm_pre", norm=True)
    for s in range(len(cfg.depths)):
        sp, tp = f"{prefix}stages.{s}.", f"stages.{s}."
        if f"{tp}downsample.conv.weight" in params:
            put(sp + "downsample.0", tp + "downsample.norm", norm=True)
            put(sp + "downsample.1", tp + "downsample.conv")
        for i in range(cfg.depths[s]):
            bp, tb = f"{sp}blocks.{i}.", f"{tp}blocks.{i}."
            put(bp + "conv_dw", tb + "dwconv")
            put(bp + "norm", tb + "norm", norm=True)
            put(bp + "mlp.fc1", tb + "fc1")
            put(bp + "mlp.fc2", tb + "fc2")
            sd[bp + "gamma"] = params[tb + "gamma"]
    return sd
