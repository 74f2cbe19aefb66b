"""Image-space ops on NHWC tensors (counterpart of visper_lm_tpu/utils/image.py).

  * convolutions: `conv2d`, `depthwise_conv2d`, `conv_transpose2d` take x as
    (B, H, W, C) and the weight in the layout of the torch module that holds
    it (`nn.Conv2d`: (out, in / groups, kh, kw); `nn.ConvTranspose2d`: (in,
    out, kh, kw)); `weights.py` carries the JAX package's HWIO kernels into
    that layout. They run `F.conv2d` / `F.conv_transpose2d` on a channels-last
    view, as the JAX package leaves its convolutions to XLA. `init_conv` makes
    an `nn.Conv2d` with JAX `init_conv`'s distribution.
  * resizes with the JAX package's semantics, which are not `F.interpolate`'s
    defaults: `resize_bilinear` (source coordinates clipped to [0, in - 1]
    before the floor, align_corners optional), `resize_bicubic` and
    `resize_area` (separable (out, in) weight matrices: Keys cubic a = -0.75
    with border replication, adaptive average bins), `grid_sample_bilinear`
    (zero padding, per-corner masks) and `resize_bicubic_pos_embed`
    (jax.image.resize's antialiased Keys cubic, a = -0.5, renormalised at the
    borders). Index and weight tables are computed on the host in numpy; the
    arithmetic on the tensor is in f32 and the result is cast back.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Padding = Union[str, int, Sequence[Tuple[int, int]]]


@torch.no_grad()
def init_conv_(conv: nn.Conv2d, generator: torch.Generator) -> nn.Conv2d:
    """JAX `init_conv`'s values in place: the kernel U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) with fan_in = kh * kw * cin / groups, the bias 0."""
    bound = 1.0 / math.sqrt(conv.weight[0].numel())
    conv.weight.uniform_(-bound, bound, generator=generator)
    if conv.bias is not None:
        conv.bias.zero_()
    return conv


def init_conv(
    kh: int, kw: int, cin: int, cout: int, use_bias: bool = True, *,
    generator: torch.Generator, device=None, dtype=None,
) -> nn.Conv2d:
    """An `nn.Conv2d(cin, cout, (kh, kw))` holding JAX `init_conv`'s values."""
    conv = nn.Conv2d(cin, cout, (kh, kw), bias=use_bias, device=device, dtype=dtype)
    return init_conv_(conv, generator)


def _pads(padding: Padding, size: Tuple[int, int], kernel: Tuple[int, int],
          stride: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """XLA's padding pairs ((top, bottom), (left, right)): "SAME" puts the
    odd pixel at the end, "VALID" none, an int on both sides."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        pairs = []
        for n, k in zip(size, kernel):
            total = max((-(-n // stride) - 1) * stride + k - n, 0)
            pairs.append((total // 2, total - total // 2))
        return tuple(pairs)
    (t, b), (l, r) = padding
    return (t, b), (l, r)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def conv2d(
    x: torch.Tensor,                  # (B, H, W, Cin)
    weight: torch.Tensor,             # (Cout, Cin / groups, kh, kw)
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: Padding = "SAME",
    groups: int = 1,
) -> torch.Tensor:
    """JAX `conv2d` (NHWC in and out); weight and bias cast to x's dtype."""
    (t, b), (l, r) = _pads(padding, x.shape[1:3], weight.shape[2:], stride)
    xc = _nchw(x)
    if t == b and l == r:
        pad = (t, l)
    else:
        xc, pad = F.pad(xc, (l, r, t, b)), (0, 0)
    y = F.conv2d(xc, weight.to(x.dtype), None, stride=stride, padding=pad, groups=groups)
    y = _nhwc(y)
    return y if bias is None else y + bias.to(y.dtype)


def depthwise_conv2d(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], padding: int
) -> torch.Tensor:
    """JAX `depthwise_conv2d` (ConvNeXt): weight (C, 1, kh, kw), one group per channel."""
    return conv2d(x, weight, bias, stride=1, padding=padding, groups=x.shape[-1])


def conv_transpose2d(
    x: torch.Tensor,                  # (B, H, W, Cin)
    weight: torch.Tensor,             # (Cin, Cout, kh, kw): nn.ConvTranspose2d's
    bias: Optional[torch.Tensor],
    stride: int,
) -> torch.Tensor:
    """JAX `conv_transpose2d` (torch ConvTranspose2d(k, s=stride, p=0)). JAX
    flips its HWIO kernel's spatial axes because lax.conv_transpose
    correlates; `F.conv_transpose2d` is the adjoint already, so the weight
    goes in as the torch module holds it (JAX kernel (kh, kw, in, out) ->
    (in, out, kh, kw))."""
    y = _nhwc(F.conv_transpose2d(_nchw(x), weight.to(x.dtype), None, stride=stride))
    return y if bias is None else y + bias.to(y.dtype)


# ---------------------------------------------------------------------------
# Resizes
# ---------------------------------------------------------------------------


def _resize_1d_indices(in_size: int, out_size: int, align_corners: bool):
    """(lo, hi, frac) of each output position, in f32 as JAX computes them."""
    idx = np.arange(out_size, dtype=np.float32)
    if align_corners and out_size > 1:
        coords = idx * np.float32(in_size - 1) / np.float32(out_size - 1)
    else:
        scale = np.float32(in_size / out_size)
        coords = (idx + np.float32(0.5)) * scale - np.float32(0.5)
        coords = np.clip(coords, np.float32(0.0), np.float32(in_size - 1))
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (coords - lo.astype(np.float32)).astype(np.float32)
    return lo, hi, frac


def resize_bilinear(
    x: torch.Tensor, size: Tuple[int, int], align_corners: bool = False
) -> torch.Tensor:
    """torch F.interpolate(mode='bilinear') as the JAX package computes it,
    for NHWC tensors: two gathers and a lerp per axis, in f32."""
    _, h, w, _ = x.shape
    oh, ow = size
    dev = x.device

    def t(a):
        return torch.from_numpy(a).to(dev)

    lo_h, hi_h, fh = map(t, _resize_1d_indices(h, oh, align_corners))
    lo_w, hi_w, fw = map(t, _resize_1d_indices(w, ow, align_corners))
    xf = x.float()
    top, bot = xf[:, lo_h], xf[:, hi_h]
    rows = top + (bot - top) * fh[None, :, None, None]
    left, right = rows[:, :, lo_w], rows[:, :, hi_w]
    return (left + (right - left) * fw[None, None, :, None]).to(x.dtype)


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel, torch's a = -0.75."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


def _bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) weights of torch F.interpolate(mode='bicubic',
    align_corners=False, antialias=False) along one axis: half-pixel source
    coordinates, 4 taps, indices clamped to the border."""
    coords = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
    i0 = np.floor(coords).astype(np.int64) - 1
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for k in range(4):
        idx = i0 + k
        np.add.at(mat, (np.arange(out_size), np.clip(idx, 0, in_size - 1)),
                  _cubic_kernel(coords - idx))
    return mat


def _area_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) weights of torch F.interpolate(mode='area') (adaptive average
    pooling): bin i averages [floor(i in / out), ceil((i + 1) in / out))."""
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        s = (i * in_size) // out_size
        e = -((-(i + 1) * in_size) // out_size)
        mat[i, s:e] = 1.0 / (e - s)
    return mat


def _resize_by_matrix(x: torch.Tensor, size: Tuple[int, int], make_mat) -> torch.Tensor:
    _, h, w, _ = x.shape
    oh, ow = size
    mh = torch.from_numpy(make_mat(h, oh)).to(device=x.device, dtype=torch.float32)
    mw = torch.from_numpy(make_mat(w, ow)).to(device=x.device, dtype=torch.float32)
    out = torch.einsum("Oh,bhwc->bOwc", mh, x.float())
    out = torch.einsum("Ow,bhwc->bhOc", mw, out)
    return out.to(x.dtype)


def resize_bicubic(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """torch F.interpolate(mode='bicubic', align_corners=False) for NHWC (the
    S2 tower's input-scale resize), as two matrix products."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    return _resize_by_matrix(x, size, _bicubic_matrix)


def resize_area(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """torch F.interpolate(mode='area') for NHWC (the S2 tower's output-grid
    downscale), as two matrix products."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    return _resize_by_matrix(x, size, _area_matrix)


def grid_sample_bilinear(
    value: torch.Tensor,      # (B, H, W, C)
    grid: torch.Tensor,       # (B, N, P, 2) normalized [-1, 1] (x, y)
    align_corners: bool = False,
) -> torch.Tensor:
    """torch F.grid_sample(mode='bilinear', padding_mode='zeros') for NHWC
    values -> (B, N, P, C). Out-of-bounds corners contribute zero."""
    b, h, w, c = value.shape
    gx, gy = grid[..., 0].float(), grid[..., 1].float()
    if align_corners:
        fx = (gx + 1.0) * 0.5 * (w - 1)
        fy = (gy + 1.0) * 0.5 * (h - 1)
    else:
        fx = ((gx + 1.0) * w - 1.0) * 0.5
        fy = ((gy + 1.0) * h - 1.0) * 0.5
    x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
    x1, y1 = x0 + 1, y0 + 1
    tx = (fx - x0)[..., None].to(value.dtype)
    ty = (fy - y0)[..., None].to(value.dtype)
    flat = value.reshape(b, h * w, c)

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)           # (B, N, P)
        out = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
        return out.reshape(idx.shape + (c,)) * inb[..., None].to(value.dtype)

    top = gather(y0, x0) * (1 - tx) + gather(y0, x1) * tx
    bot = gather(y1, x0) * (1 - tx) + gather(y1, x1) * tx
    return top * (1 - ty) + bot * ty


def _jax_cubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) weights of jax.image.resize(method='bicubic') along one axis:
    Keys cubic (a = -0.5) on half-pixel coordinates, the kernel widened by
    in / out when downsampling (antialias), each row renormalised to sum 1."""
    scale = np.float32(out_size / in_size)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).T.astype(np.float64)


def resize_bicubic_pos_embed(
    pos: torch.Tensor, src_grid: int, dst_grid: int, has_cls: bool = True
) -> torch.Tensor:
    """Interpolate a (N, D) ViT positional embedding between grid sizes
    (bicubic, DINOv2's interpolate_pos_encoding as jax.image.resize computes
    it). Used at import time."""
    if src_grid == dst_grid:
        return pos
    grid = pos[1:] if has_cls else pos
    d = grid.shape[-1]
    grid = grid.reshape(1, src_grid, src_grid, d).float()
    out = _resize_by_matrix(grid, (dst_grid, dst_grid), _jax_cubic_matrix)
    out = out.reshape(dst_grid * dst_grid, d)
    if has_cls:
        out = torch.cat([pos[:1].float(), out], dim=0)
    return out.to(pos.dtype)
