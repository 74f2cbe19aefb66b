"""visper_lm_tpu_torch/utils/image.py against visper_lm_tpu/utils/image.py.

Every function on the same seeded f32 inputs (np.random.default_rng), the
JAX side jitted, within rtol = atol = 1e-5. Convolution kernels are drawn in
JAX's HWIO layout and carried into the torch modules' layouts as weights.py
carries them (conv: OIHW; transposed conv: (in, out, kh, kw)).
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from visper_lm_tpu.utils import image as jimg
from visper_lm_tpu_torch.utils import image as timg

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("k,stride,padding,bias", [
    (3, 1, "SAME", True), (3, 2, "SAME", False), (4, 4, "VALID", True), (2, 2, "VALID", True),
    (4, 2, "SAME", True), (5, 1, 2, True), (3, 1, [(0, 2), (1, 0)], False),
])
def test_conv2d_equals_jax(k, stride, padding, bias):
    rng = _rng(k * 10 + stride)
    x = rng.normal(size=(2, 11, 13, 5)).astype(np.float32)
    p = {"kernel": rng.normal(size=(k, k, 5, 6)).astype(np.float32)}
    if bias:
        p["bias"] = rng.normal(size=(6,)).astype(np.float32)
    ref = jax.jit(lambda p, x: jimg.conv2d(p, x, stride=stride, padding=padding))(p, x)
    got = timg.conv2d(_t(x), _t(p["kernel"].transpose(3, 2, 0, 1)),
                      _t(p["bias"]) if bias else None, stride=stride, padding=padding)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("padding", [3, 1])
def test_depthwise_conv2d_equals_jax(padding):
    rng = _rng(padding)
    x = rng.normal(size=(2, 9, 10, 8)).astype(np.float32)
    p = {"kernel": rng.normal(size=(7, 7, 1, 8)).astype(np.float32),
         "bias": rng.normal(size=(8,)).astype(np.float32)}
    ref = jax.jit(lambda p, x: jimg.depthwise_conv2d(p, x, padding=padding))(p, x)
    got = timg.depthwise_conv2d(_t(x), _t(p["kernel"].transpose(3, 2, 0, 1)), _t(p["bias"]),
                                padding=padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("stride", [2, 4])
def test_conv_transpose2d_equals_jax_and_torch(stride):
    """JAX flips its kernel so lax.conv_transpose becomes torch's adjoint:
    both equal nn.ConvTranspose2d holding the same weight."""
    rng = _rng(stride)
    x = rng.normal(size=(2, 5, 6, 4)).astype(np.float32)
    kernel = rng.normal(size=(stride, stride, 4, 3)).astype(np.float32)   # (kh, kw, in, out)
    bias = rng.normal(size=(3,)).astype(np.float32)
    ref = jax.jit(lambda p, x: jimg.conv_transpose2d(p, x, stride))(
        {"kernel": kernel, "bias": bias}, x)
    w = _t(kernel.transpose(2, 3, 0, 1))                                  # (in, out, kh, kw)
    got = timg.conv_transpose2d(_t(x), w, _t(bias), stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    deconv = nn.ConvTranspose2d(4, 3, stride, stride)
    with torch.no_grad():
        deconv.weight.copy_(w)
        deconv.bias.copy_(_t(bias))
        module = deconv(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(module.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(got.numpy(), module.numpy(), **TOL)


def test_init_conv_draws_jax_init_conv_distribution():
    gen = torch.Generator().manual_seed(0)
    conv = timg.init_conv(3, 3, 16, 8, generator=gen)
    ref = jimg.init_conv(jax.random.PRNGKey(0), 3, 3, 16, 8)
    bound = 1 / np.sqrt(3 * 3 * 16)
    assert conv.weight.shape == (8, 16, 3, 3)
    assert tuple(np.asarray(ref["kernel"]).transpose(3, 2, 0, 1).shape) == tuple(conv.weight.shape)
    assert conv.weight.abs().max() <= bound and conv.weight.abs().max() > 0.9 * bound
    assert torch.equal(conv.bias, torch.zeros(8))
    assert timg.init_conv(2, 2, 4, 4, use_bias=False, generator=gen).bias is None


@pytest.mark.parametrize("src,dst", [((7, 9), (14, 12)), ((16, 16), (5, 7)), ((5, 6), (5, 6)),
                                     ((1, 4), (3, 8)), ((9, 9), (1, 1))])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bilinear_equals_jax(src, dst, align_corners):
    x = _rng(sum(src) + sum(dst)).normal(size=(2,) + src + (3,)).astype(np.float32)
    ref = jax.jit(lambda x: jimg.resize_bilinear(x, dst, align_corners))(x)
    got = timg.resize_bilinear(_t(x), dst, align_corners)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("src,dst", [((56, 56), (28, 28)), ((13, 17), (7, 9)), ((14, 14), (30, 22)),
                                     ((6, 6), (6, 6))])
def test_resize_bicubic_equals_jax(src, dst):
    x = _rng(sum(src)).normal(size=(2,) + src + (3,)).astype(np.float32)
    ref = jax.jit(lambda x: jimg.resize_bicubic(x, dst))(x)
    got = timg.resize_bicubic(_t(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("src,dst", [((72, 72), (24, 24)), ((13, 17), (5, 6)), ((5, 7), (9, 11)),
                                     ((4, 4), (4, 4))])
def test_resize_area_equals_jax(src, dst):
    x = _rng(sum(dst)).normal(size=(2,) + src + (4,)).astype(np.float32)
    ref = jax.jit(lambda x: jimg.resize_area(x, dst))(x)
    got = timg.resize_area(_t(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_bilinear_equals_jax(align_corners):
    rng = _rng(int(align_corners))
    value = rng.normal(size=(2, 7, 9, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(2, 5, 4, 2)).astype(np.float32)
    ref = jax.jit(lambda v, g: jimg.grid_sample_bilinear(v, g, align_corners))(value, grid)
    got = timg.grid_sample_bilinear(_t(value), _t(grid), align_corners)
    assert got.shape == (2, 5, 4, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    nchw = torch.nn.functional.grid_sample(
        _t(value).permute(0, 3, 1, 2), _t(grid), mode="bilinear", padding_mode="zeros",
        align_corners=align_corners).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), nchw.numpy(), **TOL)


@pytest.mark.parametrize("src,dst,has_cls", [(4, 6, True), (6, 4, True), (5, 8, False),
                                             (8, 3, False), (4, 4, True)])
def test_resize_bicubic_pos_embed_equals_jax(src, dst, has_cls):
    pos = _rng(src * dst).normal(size=(src * src + int(has_cls), 8)).astype(np.float32)
    ref = jax.jit(lambda p: jimg.resize_bicubic_pos_embed(p, src, dst, has_cls))(pos)
    got = timg.resize_bicubic_pos_embed(_t(pos), src, dst, has_cls)
    assert got.shape == (dst * dst + int(has_cls), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_bf16_inputs_come_back_in_bf16():
    x = torch.from_numpy(_rng(3).normal(size=(1, 6, 6, 2)).astype(np.float32)).bfloat16()
    for out in (timg.resize_bilinear(x, (3, 3)), timg.resize_bicubic(x, (9, 9)),
                timg.resize_area(x, (2, 2))):
        assert out.dtype == torch.bfloat16
