"""FID-InceptionV3 and FID in the port (visper_lm_tpu_torch/eval/{inception,fid}.py)
vs the JAX package's on the CPU.

  * `utils.image.resize_bilinear_jax` against jax.image.resize(method=
    "bilinear") up (96x80 -> 299) and down (600x520 -> 299: the antialiased
    triangle) at 1e-5 absolute on [0, 1] images;
  * the features of `import_inception` of one random pt_inception-layout
    state dict against JAX's `inception_features` on JAX's import of it:
    within 1e-4 x max|feature| (f32 through 94 convolutions whose sums the two
    frameworks take in other orders);
  * `fid_from_features` and its parts equal to JAX's (the numpy math is a
    copy), the weights-file loaders (.npz, .pth with weights_only) equal to
    the importer, the architecture's shapes and count, and `clip_feature_fn`
    against JAX's at the tiny ViT (1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu.eval import fid as jfid
from visper_lm_tpu.eval import inception as jinc

from visper_lm_tpu_torch.eval import fid as tfid
from visper_lm_tpu_torch.eval import inception as tinc
from visper_lm_tpu_torch.utils.image import resize_bilinear_jax

from test_inception import _synthetic_pt_state_dict

torch.set_num_threads(2)


@pytest.mark.parametrize("src,dst", [((96, 80), (299, 299)), ((600, 520), (299, 299)),
                                     ((512, 512), (299, 299)), ((33, 700), (299, 120)),
                                     ((299, 299), (299, 299))])
def test_resize_bilinear_jax_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(0).uniform(0, 1, (2,) + src + (3,)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jax.image.resize(a, (2,) + dst + (3,), method="bilinear"))(x))
    got = resize_bilinear_jax(torch.from_numpy(x), dst).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_downscale_antialiases_unlike_interpolate():
    """A 3x downscale of a one-pixel checkerboard: JAX's triangle kernel,
    widened to 5 taps, averages it to 4/9 .. 5/9 per axis; F.interpolate
    samples one pixel (0 or 1)."""
    x = np.indices((66, 66)).sum(axis=0) % 2
    x = torch.from_numpy(np.repeat(x[None, ..., None], 3, -1).astype(np.float32))
    inner = resize_bilinear_jax(x, (22, 22))[:, 1:-1, 1:-1].numpy()
    assert inner.min() >= 0.4 and inner.max() <= 0.6
    plain = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=(22, 22), mode="bilinear")
    assert set(np.unique(plain.numpy())) == {0.0, 1.0}


@pytest.fixture(scope="module")
def state_dict():
    return _synthetic_pt_state_dict()


def test_features_match_jax(state_dict):
    images = np.random.default_rng(1).uniform(0, 1, (2, 64, 48, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jinc.inception_features)(jinc.import_inception(state_dict),
                                                      jnp.asarray(images)))
    got = tinc.inception_feature_fn(tinc.import_inception(state_dict, device="cpu"),
                                    batch_size=1)(images)
    assert got.shape == ref.shape == (2, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def test_weight_files_load_as_the_importer(state_dict, tmp_path):
    images = np.random.default_rng(2).uniform(0, 1, (1, 40, 40, 3)).astype(np.float32)
    want = tinc.inception_feature_fn(tinc.import_inception(state_dict, device="cpu"))(images)
    npz = str(tmp_path / "pt_inception.npz")
    np.savez(npz, **state_dict)
    pth = str(tmp_path / "pt_inception.pth")
    torch.save({k: torch.from_numpy(v) for k, v in state_dict.items()}, pth)
    for path in (npz, pth):
        np.testing.assert_array_equal(tfid.inception_feature_fn(path, device="cpu")(images), want)


def test_import_layout_and_param_count(state_dict):
    params = tinc.import_inception(state_dict, device="cpu")
    np.testing.assert_array_equal(params["Conv2d_1a_3x3"]["kernel"].numpy(),
                                  state_dict["Conv2d_1a_3x3.conv.weight"])
    np.testing.assert_array_equal(params["Mixed_5b"]["branch5x5_2"]["bn"]["mean"].numpy(),
                                  state_dict["Mixed_5b.branch5x5_2.bn.running_mean"])
    assert tinc.module_branches() == jinc.module_branches()
    assert tinc.conv_shapes() == jinc.conv_shapes()
    g = torch.Generator().manual_seed(0)
    leaves = jax.tree_util.tree_leaves(tinc.init_inception(g, device="cpu"))
    n = sum(x.numel() for x in leaves)
    assert n == sum(kh * kw * cin * cout + 4 * cout for cin, cout, kh, kw in jinc.conv_shapes().values())
    assert 21_000_000 < n < 22_500_000


def test_stage_shapes():
    g = torch.Generator().manual_seed(1)
    p = tinc.init_inception(g, device="cpu")
    x = torch.zeros(1, 3, 299, 299)
    with torch.no_grad():
        for name, stride, pad in tinc.STEM:
            x = tinc.basic_conv(p[name], x, stride=stride, padding=pad)
        assert x.shape == (1, 64, 147, 147)
        x = tinc.max_pool(x)
        for name, stride, pad in tinc.STEM2:
            x = tinc.basic_conv(p[name], x, stride=stride, padding=pad)
        x = tinc.max_pool(x)
        assert x.shape == (1, 192, 35, 35)
        for name, c in (("Mixed_5b", 256), ("Mixed_5c", 288), ("Mixed_5d", 288)):
            x = tinc.inception_a(p[name], x)
            assert x.shape == (1, c, 35, 35)
        x = tinc.inception_b(p["Mixed_6a"], x)
        assert x.shape == (1, 768, 17, 17)
        for name in tinc.MIXED_C:
            x = tinc.inception_c(p[name], x)
        assert x.shape == (1, 768, 17, 17)
        x = tinc.inception_d(p["Mixed_7a"], x)
        assert x.shape == (1, 1280, 8, 8)
        x = tinc.inception_e(p["Mixed_7b"], x, pool="avg")
        x = tinc.inception_e(p["Mixed_7c"], x, pool="max")
        assert x.shape == (1, 2048, 8, 8)


def test_avg_pool_excludes_padding_as_jax():
    x = np.random.default_rng(3).normal(size=(1, 5, 6, 2)).astype(np.float32)
    ref = np.asarray(jinc.avg_pool_nocountpad(jnp.asarray(x)))
    got = tinc.avg_pool_nocountpad(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    ones = tinc.avg_pool_nocountpad(torch.ones(1, 1, 4, 4))
    assert float(ones[0, 0, 0, 0]) == 1.0


@pytest.mark.parametrize("case", ["same", "shift", "scale", "small"])
def test_fid_equal_jax(case):
    rng = np.random.default_rng({"same": 0, "shift": 1, "scale": 2, "small": 3}[case])
    x = rng.normal(size=(400, 12))
    y = {"same": x, "shift": x + 1.5, "scale": rng.normal(size=(400, 12)) * 2.0 + 0.3,
         "small": rng.normal(size=(6, 12))}[case]
    assert tfid.fid_from_features(x, y) == jfid.fid_from_features(x, y)
    for a, b in zip(tfid.compute_stats(y), jfid.compute_stats(y)):
        np.testing.assert_array_equal(a, b)
    s1, s2 = tfid.compute_stats(x)[1], tfid.compute_stats(y)[1]
    np.testing.assert_array_equal(tfid._sqrtm_product(s1, s2), jfid._sqrtm_product(s1, s2))


def test_clip_feature_fn_matches_jax():
    from visper_lm_tpu.config import tiny_test_vlm as jtiny
    from visper_lm_tpu.models.vlm import init_vlm as j_init_vlm

    from visper_lm_tpu_torch.config import tiny_test_vlm
    from visper_lm_tpu_torch.weights import from_jax_params

    params = j_init_vlm(jax.random.PRNGKey(0), jtiny())
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), tiny_test_vlm(),
                            device="cpu")
    images = np.random.default_rng(4).normal(size=(3, 28, 28, 3)).astype(np.float32)
    ref = jfid.clip_feature_fn(params["vision_tower"], jtiny().vision)(images)
    got = tfid.clip_feature_fn(model.vision_tower)(images)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)
