"""DPT fusion decoder, the frozen DAv2 head that renders depth maps from ViT
features (counterpart of visper_lm_tpu/models/teachers/dpt.py).

DAv2-L's DPTHead: features 256, out_channels (256, 512, 1024, 1024), no
batch norm, no class-token readout, at 24 x 24 patches (336 px). It renders
the depth head's predictions for the training-time viz hook (train/viz.py)
and the demo. NHWC; the convolutions are `utils.image.conv2d` /
`conv_transpose2d` on the modules' weights cast to the features' dtype (as
JAX casts its kernels), every interpolation is
`resize_bilinear(align_corners=True)`.

`import_dpt_head` reads a DAv2 / OLA state dict into the JAX package's tree
layout (numpy), which `weights.dpt_from_jax_params` loads into a `DPTHead`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from visper_lm_tpu_torch.utils.image import conv2d, conv_transpose2d, resize_bilinear
from visper_lm_tpu_torch.utils.param import host_array

OUT_CHANNELS = (256, 512, 1024, 1024)
FEATURES = 256


def _conv(cin: int, cout: int, k: int, bias: bool = True, **kw) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, bias=bias, **kw)


class FusionBlock(nn.Module):
    """A refinenet: two residual conv units (rcu1 on the skip, rcu2) and a 1x1 out_conv."""

    def __init__(self, features: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.rcu1 = nn.ModuleList(_conv(features, features, 3, **kw) for _ in range(2))
        self.rcu2 = nn.ModuleList(_conv(features, features, 3, **kw) for _ in range(2))
        self.out_conv = _conv(features, features, 1, **kw)


class DPTHead(nn.Module):
    """JAX `init_dpt_head` params: projects, resize0/1 (transposed convs),
    resize3, layer_rn, refinenets, output_conv1, output_conv2a/b."""

    def __init__(self, in_channels: int = 1024, out_channels: Sequence[int] = OUT_CHANNELS,
                 features: int = FEATURES, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        oc = tuple(out_channels)
        self.projects = nn.ModuleList(_conv(in_channels, c, 1, **kw) for c in oc)
        self.resize0 = nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4, **kw)
        self.resize1 = nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2, **kw)
        self.resize3 = _conv(oc[3], oc[3], 3, **kw)
        self.layer_rn = nn.ModuleList(_conv(c, features, 3, bias=False, **kw) for c in oc)
        self.refinenets = nn.ModuleList(FusionBlock(features, **kw) for _ in range(4))
        self.output_conv1 = _conv(features, features // 2, 3, **kw)
        self.output_conv2a = _conv(features // 2, 32, 3, **kw)
        self.output_conv2b = _conv(32, 1, 1, **kw)


@torch.no_grad()
def init_dpt_(head: DPTHead, generator: torch.Generator) -> DPTHead:
    """JAX `init_dpt_head`'s distribution in place: every kernel U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) with fan_in = kh * kw * cin, every bias 0."""
    for m in head.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            cin = m.in_channels
            bound = 1.0 / math.sqrt(m.kernel_size[0] * m.kernel_size[1] * cin)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    return head


def init_dpt_head(
    in_channels: int = 1024, out_channels: Sequence[int] = OUT_CHANNELS,
    features: int = FEATURES, *, generator: torch.Generator, device=None, dtype=None,
) -> DPTHead:
    """A frozen DPTHead with seeded random weights (real use imports DAv2's)."""
    head = DPTHead(in_channels, out_channels, features, device=device, dtype=dtype)
    return init_dpt_(head, generator).requires_grad_(False).eval()


def _c(conv: nn.Conv2d, x: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    return conv2d(x, conv.weight, conv.bias, stride=stride, padding=padding)


def _residual_conv_unit(convs: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    out = _c(convs[0], F.relu(x), padding=1)
    out = _c(convs[1], F.relu(out), padding=1)
    return out + x


def _fusion(block: FusionBlock, x: torch.Tensor, skip=None, size=None) -> torch.Tensor:
    out = x
    if skip is not None:
        out = out + _residual_conv_unit(block.rcu1, skip)
    out = _residual_conv_unit(block.rcu2, out)
    if size is None:
        size = (out.shape[1] * 2, out.shape[2] * 2)
    out = resize_bilinear(out, tuple(size), align_corners=True)
    return _c(block.out_conv, out)


def dpt_forward(
    head: DPTHead,
    features: Sequence[torch.Tensor],     # 4 x (B, N, D) patch tokens, shallow -> deep
    patch_h: int = 24,
    patch_w: int = 24,
) -> torch.Tensor:
    """The relative depth map (B, patch_h * 14, patch_w * 14), ReLU'd."""
    outs = []
    for i, tokens in enumerate(features):
        b, _, d = tokens.shape
        x = _c(head.projects[i], tokens.reshape(b, patch_h, patch_w, d))
        if i == 0:
            x = conv_transpose2d(x, head.resize0.weight, head.resize0.bias, stride=4)
        elif i == 1:
            x = conv_transpose2d(x, head.resize1.weight, head.resize1.bias, stride=2)
        elif i == 3:
            x = _c(head.resize3, x, stride=2, padding=1)
        outs.append(x)
    rn = [_c(head.layer_rn[i], outs[i], padding=1) for i in range(4)]
    refs = head.refinenets
    path4 = _fusion(refs[3], rn[3], None, size=rn[2].shape[1:3])
    path3 = _fusion(refs[2], path4, rn[2], size=rn[1].shape[1:3])
    path2 = _fusion(refs[1], path3, rn[1], size=rn[0].shape[1:3])
    path1 = _fusion(refs[0], path2, rn[0])
    out = _c(head.output_conv1, path1, padding=1)
    out = resize_bilinear(out, (patch_h * 14, patch_w * 14), align_corners=True)
    out = F.relu(_c(head.output_conv2a, out, padding=1))
    out = F.relu(_c(head.output_conv2b, out))
    out = F.relu(out)                   # DAv2_Head's final relu
    return out[..., 0]


def normalized_depth(head: DPTHead, features: Sequence[torch.Tensor]) -> torch.Tensor:
    """The min-max normalised depth map (B, H, W) in f32, as the reference
    logs it; the patch grid is the square of the token count."""
    side = int(round(features[0].shape[1] ** 0.5))
    depth = dpt_forward(head, features, patch_h=side, patch_w=side).float()
    mn = depth.amin(dim=(1, 2), keepdim=True)
    mx = depth.amax(dim=(1, 2), keepdim=True)
    return (depth - mn) / torch.clamp(mx - mn, min=1e-8)


# ---------------------------------------------------------------------------
# Importer: DAv2 / OLA state dict -> the JAX package's tree layout (numpy)
# ---------------------------------------------------------------------------


def _conv_from_torch(sd: Mapping[str, Any], key: str) -> Dict[str, np.ndarray]:
    p = {"kernel": np.ascontiguousarray(np.transpose(host_array(sd[f"{key}.weight"]), (2, 3, 1, 0)))}
    if f"{key}.bias" in sd:
        p["bias"] = host_array(sd[f"{key}.bias"])
    return p


def _deconv_from_torch(sd: Mapping[str, Any], key: str) -> Dict[str, np.ndarray]:
    # torch ConvTranspose2d weight (in, out, kh, kw) -> (kh, kw, in, out)
    p = {"kernel": np.ascontiguousarray(np.transpose(host_array(sd[f"{key}.weight"]), (2, 3, 0, 1)))}
    if f"{key}.bias" in sd:
        p["bias"] = host_array(sd[f"{key}.bias"])
    return p


def import_dpt_head(sd: Mapping[str, Any], prefix: str = "depth_head.") -> Dict[str, Any]:
    """JAX `import_dpt_head`: a DAv2 checkpoint's 'depth_head.*' or an OLA
    checkpoint's 'da_v2_head.depth_head.*' -> the JAX tree (numpy)."""
    p: Dict[str, Any] = {
        "projects": [_conv_from_torch(sd, f"{prefix}projects.{i}") for i in range(4)],
        "resize0": _deconv_from_torch(sd, f"{prefix}resize_layers.0"),
        "resize1": _deconv_from_torch(sd, f"{prefix}resize_layers.1"),
        "resize3": _conv_from_torch(sd, f"{prefix}resize_layers.3"),
        "layer_rn": [_conv_from_torch(sd, f"{prefix}scratch.layer{i + 1}_rn") for i in range(4)],
        "refinenets": [],
        "output_conv1": _conv_from_torch(sd, f"{prefix}scratch.output_conv1"),
        "output_conv2a": _conv_from_torch(sd, f"{prefix}scratch.output_conv2.0"),
        "output_conv2b": _conv_from_torch(sd, f"{prefix}scratch.output_conv2.2"),
    }
    refs: List[Dict[str, Any]] = p["refinenets"]
    for i in range(1, 5):
        rp = f"{prefix}scratch.refinenet{i}."
        refs.append({
            "rcu1": [_conv_from_torch(sd, rp + "resConfUnit1.conv1"),
                     _conv_from_torch(sd, rp + "resConfUnit1.conv2")],
            "rcu2": [_conv_from_torch(sd, rp + "resConfUnit2.conv1"),
                     _conv_from_torch(sd, rp + "resConfUnit2.conv2")],
            "out_conv": _conv_from_torch(sd, rp + "out_conv"),
        })
    return p
