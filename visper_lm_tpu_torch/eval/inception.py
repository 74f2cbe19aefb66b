"""InceptionV3 (FID variant) in PyTorch: the canonical FID feature net (the
port's counterpart of visper_lm_tpu/eval/inception.py).

Port target: the reference's vendored pytorch-fid extractor
(ola_vlm/eval/inception.py:1-343): torchvision inception_v3 with the three
TF-compat patches (FIDInceptionA/C/E: branch-pool average pooling with
count_include_pad=False; the second InceptionE uses MAX pooling in its pool
branch), fed by a bilinear resize to 299 and [-1, 1] scaling, producing the
2048-d final-average-pool features (output block 3).

Functions on a tree of tensors, as the JAX package's are on a tree of arrays:
{module: {"kernel": (cout, cin, kh, kw), "bn": {scale, bias, mean, var}}} (a
BasicConv2d; a mixed block holds one per branch). Kernels keep torch's OIHW
layout (the JAX tree's HWIO transposed), activations are NCHW inside the net;
`inception_features` takes NHWC images, as the JAX package's does. Convolutions,
pools and the inference-mode BatchNorm (running stats, eps 1e-3) are stock
ops, in f32 with TF32 off. The resize is jax.image.resize's bilinear, which
antialiases when it downscales (`utils.image.resize_bilinear_jax`); pytorch-fid
resizes with F.interpolate, which does not (ROADMAP C17): the port follows JAX.

`import_inception(sd)` consumes the pt_inception-2015-12-05 state dict
(torchvision key layout: Conv2d_1a_3x3.conv/bn, Mixed_5b.branch1x1..., fc).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from visper_lm_tpu_torch.device import resolve_device
from visper_lm_tpu_torch.utils.image import resize_bilinear_jax

Params = Dict[str, object]
BN_EPS = 1e-3


# --------------------------------------------------------------- primitives


def basic_conv(p: Params, x: torch.Tensor, stride: int = 1,
               padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """BasicConv2d: conv (no bias) -> BN(eps 1e-3, running stats) -> relu.
    x (B, C, H, W); padding (rows, columns) on both sides."""
    y = F.conv2d(x, p["kernel"], stride=stride, padding=padding)
    bn = p["bn"]
    inv = torch.rsqrt(bn["var"] + BN_EPS) * bn["scale"]
    y = y * inv[:, None, None] + (bn["bias"] - bn["mean"] * inv)[:, None, None]
    return F.relu(y)


def max_pool(x: torch.Tensor, k: int = 3, stride: int = 2, pad: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, k, stride, pad)


def avg_pool_nocountpad(x: torch.Tensor, k: int = 3, stride: int = 1, pad: int = 1) -> torch.Tensor:
    """TF-style average pooling: padded zeros are NOT counted in the divisor
    (the FIDInception* patch, reference inception.py:236-242)."""
    return F.avg_pool2d(x, k, stride, pad, count_include_pad=False)


P0 = (0, 0)
P1 = (1, 1)
W7 = (0, 3)   # 1x7
H7 = (3, 0)   # 7x1


# ------------------------------------------------------------ mixed blocks


def inception_a(p: Params, x: torch.Tensor) -> torch.Tensor:
    b1 = basic_conv(p["branch1x1"], x)
    b5 = basic_conv(p["branch5x5_1"], x)
    b5 = basic_conv(p["branch5x5_2"], b5, padding=(2, 2))
    b3 = basic_conv(p["branch3x3dbl_1"], x)
    b3 = basic_conv(p["branch3x3dbl_2"], b3, padding=P1)
    b3 = basic_conv(p["branch3x3dbl_3"], b3, padding=P1)
    bp = basic_conv(p["branch_pool"], avg_pool_nocountpad(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def inception_b(p: Params, x: torch.Tensor) -> torch.Tensor:
    b3 = basic_conv(p["branch3x3"], x, stride=2)
    bd = basic_conv(p["branch3x3dbl_1"], x)
    bd = basic_conv(p["branch3x3dbl_2"], bd, padding=P1)
    bd = basic_conv(p["branch3x3dbl_3"], bd, stride=2)
    return torch.cat([b3, bd, max_pool(x)], dim=1)


def inception_c(p: Params, x: torch.Tensor) -> torch.Tensor:
    b1 = basic_conv(p["branch1x1"], x)
    b7 = basic_conv(p["branch7x7_1"], x)
    b7 = basic_conv(p["branch7x7_2"], b7, padding=W7)
    b7 = basic_conv(p["branch7x7_3"], b7, padding=H7)
    bd = basic_conv(p["branch7x7dbl_1"], x)
    bd = basic_conv(p["branch7x7dbl_2"], bd, padding=H7)
    bd = basic_conv(p["branch7x7dbl_3"], bd, padding=W7)
    bd = basic_conv(p["branch7x7dbl_4"], bd, padding=H7)
    bd = basic_conv(p["branch7x7dbl_5"], bd, padding=W7)
    bp = basic_conv(p["branch_pool"], avg_pool_nocountpad(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def inception_d(p: Params, x: torch.Tensor) -> torch.Tensor:
    b3 = basic_conv(p["branch3x3_1"], x)
    b3 = basic_conv(p["branch3x3_2"], b3, stride=2)
    b7 = basic_conv(p["branch7x7x3_1"], x)
    b7 = basic_conv(p["branch7x7x3_2"], b7, padding=W7)
    b7 = basic_conv(p["branch7x7x3_3"], b7, padding=H7)
    b7 = basic_conv(p["branch7x7x3_4"], b7, stride=2)
    return torch.cat([b3, b7, max_pool(x)], dim=1)


def inception_e(p: Params, x: torch.Tensor, pool: str) -> torch.Tensor:
    b1 = basic_conv(p["branch1x1"], x)
    b3 = basic_conv(p["branch3x3_1"], x)
    b3 = torch.cat([basic_conv(p["branch3x3_2a"], b3, padding=(0, 1)),
                    basic_conv(p["branch3x3_2b"], b3, padding=(1, 0))], dim=1)
    bd = basic_conv(p["branch3x3dbl_1"], x)
    bd = basic_conv(p["branch3x3dbl_2"], bd, padding=P1)
    bd = torch.cat([basic_conv(p["branch3x3dbl_3a"], bd, padding=(0, 1)),
                    basic_conv(p["branch3x3dbl_3b"], bd, padding=(1, 0))], dim=1)
    if pool == "max":  # FIDInceptionE_2 (reference inception.py:307-341)
        bp = max_pool(x, 3, 1, 1)
    else:
        bp = avg_pool_nocountpad(x)
    bp = basic_conv(p["branch_pool"], bp)
    return torch.cat([b1, b3, bd, bp], dim=1)


# ------------------------------------------------------------------ network


STEM = (
    ("Conv2d_1a_3x3", 2, P0),
    ("Conv2d_2a_3x3", 1, P0),
    ("Conv2d_2b_3x3", 1, P1),
)
STEM2 = (("Conv2d_3b_1x1", 1, P0), ("Conv2d_4a_3x3", 1, P0))
MIXED_C = ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e")


@contextlib.contextmanager
def _no_tf32():
    """f32 convolutions and products in full f32 (cuDNN's default is TF32)."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


@torch.no_grad()
def inception_features(params: Params, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) in [0, 1] -> pool3 features (B, 2048), f32.

    Matches InceptionV3(output_blocks=[3], resize_input=True, normalize_input=True)
    — the pytorch-fid default the reference uses — with JAX's resize.
    """
    with _no_tf32():
        x = resize_bilinear_jax(images.float(), (299, 299))
        x = (2.0 * x - 1.0).permute(0, 3, 1, 2).contiguous()
        for name, stride, pad in STEM:
            x = basic_conv(params[name], x, stride=stride, padding=pad)
        x = max_pool(x)
        for name, stride, pad in STEM2:
            x = basic_conv(params[name], x, stride=stride, padding=pad)
        x = max_pool(x)
        x = inception_a(params["Mixed_5b"], x)
        x = inception_a(params["Mixed_5c"], x)
        x = inception_a(params["Mixed_5d"], x)
        x = inception_b(params["Mixed_6a"], x)
        for name in MIXED_C:
            x = inception_c(params[name], x)
        x = inception_d(params["Mixed_7a"], x)
        x = inception_e(params["Mixed_7b"], x, pool="avg")
        x = inception_e(params["Mixed_7c"], x, pool="max")
        return x.mean(dim=(2, 3))  # adaptive avg pool to 1x1


# ------------------------------------------------------- init & importer


_A_BRANCHES = (
    "branch1x1", "branch5x5_1", "branch5x5_2",
    "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool",
)
_B_BRANCHES = ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3")
_C_BRANCHES = (
    "branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
    "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4",
    "branch7x7dbl_5", "branch_pool",
)
_D_BRANCHES = (
    "branch3x3_1", "branch3x3_2",
    "branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4",
)
_E_BRANCHES = (
    "branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
    "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a", "branch3x3dbl_3b",
    "branch_pool",
)


def module_branches() -> Dict[str, Sequence[str]]:
    """Full module -> BasicConv2d branch-name table (torchvision inception_v3)."""
    table: Dict[str, Sequence[str]] = {name: ("",) for name, _, _ in STEM + STEM2}
    for m in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        table[m] = _A_BRANCHES
    table["Mixed_6a"] = _B_BRANCHES
    for m in MIXED_C:
        table[m] = _C_BRANCHES
    table["Mixed_7a"] = _D_BRANCHES
    for m in ("Mixed_7b", "Mixed_7c"):
        table[m] = _E_BRANCHES
    return table


# (cin, cout, kh, kw) per BasicConv2d, derived from the torchvision architecture
def conv_shapes() -> Dict[str, Tuple[int, int, int, int]]:
    shapes: Dict[str, Tuple[int, int, int, int]] = {
        "Conv2d_1a_3x3": (3, 32, 3, 3),
        "Conv2d_2a_3x3": (32, 32, 3, 3),
        "Conv2d_2b_3x3": (32, 64, 3, 3),
        "Conv2d_3b_1x1": (64, 80, 1, 1),
        "Conv2d_4a_3x3": (80, 192, 3, 3),
    }

    def a(mod, cin, pool):
        shapes[f"{mod}.branch1x1"] = (cin, 64, 1, 1)
        shapes[f"{mod}.branch5x5_1"] = (cin, 48, 1, 1)
        shapes[f"{mod}.branch5x5_2"] = (48, 64, 5, 5)
        shapes[f"{mod}.branch3x3dbl_1"] = (cin, 64, 1, 1)
        shapes[f"{mod}.branch3x3dbl_2"] = (64, 96, 3, 3)
        shapes[f"{mod}.branch3x3dbl_3"] = (96, 96, 3, 3)
        shapes[f"{mod}.branch_pool"] = (cin, pool, 1, 1)

    a("Mixed_5b", 192, 32)
    a("Mixed_5c", 256, 64)
    a("Mixed_5d", 288, 64)
    shapes["Mixed_6a.branch3x3"] = (288, 384, 3, 3)
    shapes["Mixed_6a.branch3x3dbl_1"] = (288, 64, 1, 1)
    shapes["Mixed_6a.branch3x3dbl_2"] = (64, 96, 3, 3)
    shapes["Mixed_6a.branch3x3dbl_3"] = (96, 96, 3, 3)

    def c(mod, c7):
        shapes[f"{mod}.branch1x1"] = (768, 192, 1, 1)
        shapes[f"{mod}.branch7x7_1"] = (768, c7, 1, 1)
        shapes[f"{mod}.branch7x7_2"] = (c7, c7, 1, 7)
        shapes[f"{mod}.branch7x7_3"] = (c7, 192, 7, 1)
        shapes[f"{mod}.branch7x7dbl_1"] = (768, c7, 1, 1)
        shapes[f"{mod}.branch7x7dbl_2"] = (c7, c7, 7, 1)
        shapes[f"{mod}.branch7x7dbl_3"] = (c7, c7, 1, 7)
        shapes[f"{mod}.branch7x7dbl_4"] = (c7, c7, 7, 1)
        shapes[f"{mod}.branch7x7dbl_5"] = (c7, 192, 1, 7)
        shapes[f"{mod}.branch_pool"] = (768, 192, 1, 1)

    c("Mixed_6b", 128)
    c("Mixed_6c", 160)
    c("Mixed_6d", 160)
    c("Mixed_6e", 192)
    shapes["Mixed_7a.branch3x3_1"] = (768, 192, 1, 1)
    shapes["Mixed_7a.branch3x3_2"] = (192, 320, 3, 3)
    shapes["Mixed_7a.branch7x7x3_1"] = (768, 192, 1, 1)
    shapes["Mixed_7a.branch7x7x3_2"] = (192, 192, 1, 7)
    shapes["Mixed_7a.branch7x7x3_3"] = (192, 192, 7, 1)
    shapes["Mixed_7a.branch7x7x3_4"] = (192, 192, 3, 3)

    def e(mod, cin):
        shapes[f"{mod}.branch1x1"] = (cin, 320, 1, 1)
        shapes[f"{mod}.branch3x3_1"] = (cin, 384, 1, 1)
        shapes[f"{mod}.branch3x3_2a"] = (384, 384, 1, 3)
        shapes[f"{mod}.branch3x3_2b"] = (384, 384, 3, 1)
        shapes[f"{mod}.branch3x3dbl_1"] = (cin, 448, 1, 1)
        shapes[f"{mod}.branch3x3dbl_2"] = (448, 384, 3, 3)
        shapes[f"{mod}.branch3x3dbl_3a"] = (384, 384, 1, 3)
        shapes[f"{mod}.branch3x3dbl_3b"] = (384, 384, 3, 1)
        shapes[f"{mod}.branch_pool"] = (cin, 192, 1, 1)

    e("Mixed_7b", 1280)
    e("Mixed_7c", 2048)
    return shapes


def _tree(make_conv) -> Params:
    params: Params = {}
    for mod, brs in module_branches().items():
        if brs == ("",):
            params[mod] = make_conv(mod)
        else:
            params[mod] = {br: make_conv(f"{mod}.{br}") for br in brs}
    return params


def init_inception(generator: torch.Generator, device=None) -> Params:
    """Random-weight network with the exact architecture (tests / smoke):
    kernels N(0, 0.05^2) from `generator` in module order, BN at identity."""
    dev = resolve_device(device)
    shapes = conv_shapes()

    def conv(full: str) -> Params:
        cin, cout, kh, kw = shapes[full]
        kernel = torch.randn((cout, cin, kh, kw), generator=generator,
                             device=generator.device) * 0.05
        return {
            "kernel": kernel.to(dev),
            "bn": {
                "scale": torch.ones(cout, device=dev),
                "bias": torch.zeros(cout, device=dev),
                "mean": torch.zeros(cout, device=dev),
                "var": torch.ones(cout, device=dev),
            },
        }

    return _tree(conv)


def import_inception(sd: Dict[str, object], device=None) -> Params:
    """pt_inception / torchvision inception_v3 state dict -> params tree of
    f32 tensors on `device` (CUDA unless given).

    Keys: '{module}.conv.weight' (OIHW), '{module}.bn.{weight,bias,
    running_mean,running_var}' for every BasicConv2d; fc.* ignored (FID uses
    pool3 features only).
    """
    dev = resolve_device(device)

    def t(key: str) -> torch.Tensor:
        return torch.as_tensor(np.asarray(sd[key], dtype=np.float32)).to(dev)

    def conv(prefix: str) -> Params:
        return {
            "kernel": t(f"{prefix}.conv.weight").contiguous(),
            "bn": {
                "scale": t(f"{prefix}.bn.weight"),
                "bias": t(f"{prefix}.bn.bias"),
                "mean": t(f"{prefix}.bn.running_mean"),
                "var": t(f"{prefix}.bn.running_var"),
            },
        }

    return _tree(conv)


def inception_feature_fn(params: Params, batch_size: int = 32) -> Callable:
    """Batched (N, H, W, 3)-in-[0,1] -> (N, 2048) canonical FID features, on
    the params' device."""
    dev = params["Conv2d_1a_3x3"]["kernel"].device

    def fn(images: np.ndarray) -> np.ndarray:
        out: List[np.ndarray] = []
        for i in range(0, len(images), batch_size):
            x = torch.as_tensor(np.asarray(images[i:i + batch_size], np.float32), device=dev)
            out.append(inception_features(params, x).cpu().numpy())
        return np.concatenate(out, axis=0)

    return fn
