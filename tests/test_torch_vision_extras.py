"""The vision extras of visper_lm_tpu_torch vs the JAX package's on the CPU:
the S2 multiscale tower, towers with no class token, `attention_pool2d` and
the probe heads (and the depth head's intermediate pyramid). JAX's init,
carried over by weights.py (`vit_tree_to_state_dict`, `load_jax_tree`); seeded
f32 inputs; rtol = atol = 1e-4. The spec: tests/test_s2_parity.py and
tests/test_parity_fillers.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.checkpoint import hf_export as jexp
from visper_lm_tpu.checkpoint import hf_import as jimp
from visper_lm_tpu.models import heads as jheads
from visper_lm_tpu.models import resampler as jres
from visper_lm_tpu.models import vit as jvit

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.checkpoint import hf_export as texp
from visper_lm_tpu_torch.checkpoint import hf_import as timp
from visper_lm_tpu_torch.models import heads as theads
from visper_lm_tpu_torch.models import resampler as tres
from visper_lm_tpu_torch.models import vit as tvit
from visper_lm_tpu_torch.utils.image import resize_bicubic
from visper_lm_tpu_torch.weights import load_jax_tree, vit_tree_to_state_dict

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _vision(c, **kw):
    return c.VisionConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=3, num_heads=2,
                          mlp_dim=64, select_layer=-2, dtype="float32", **kw)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize(tree, seed):
    """Every leaf drawn anew (JAX's init zeros the position embedding and
    class token): N(0, 0.1^2) around the init."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), tree)


def _towers(seed, **kw):
    cfg_j, cfg_t = _vision(jconfig, **kw), _vision(tconfig, **kw)
    tree = _randomize(_numpy(jvit.init_vit(jax.random.PRNGKey(seed), cfg_j)), seed)
    tower = tvit.VisionTower(cfg_t)
    tower.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           vit_tree_to_state_dict(tree, cfg_t.num_layers).items()}, strict=True)
    return cfg_j, cfg_t, tree, tower.eval()


@pytest.mark.parametrize("use_class_token", [True, False])
@pytest.mark.parametrize("select_feature", ["patch", "cls_patch"])
def test_tower_features_with_and_without_class_token_equal_jax(use_class_token, select_feature):
    cfg_j, cfg_t, tree, tower = _towers(0, use_class_token=use_class_token,
                                        select_feature=select_feature)
    assert (tower.cls_token is None) == (not use_class_token)
    assert tower.pos_embed.shape[0] == cfg_t.num_patches + int(use_class_token)
    images = np.random.default_rng(1).normal(size=(2, 28, 28, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: jvit.clip_tower_features(p, cfg_j, x))(tree, images)
    ref_all = jax.jit(lambda p, x: jvit.vit_forward(p, cfg_j, x, output_layers=(0, 2)))(
        tree, images)
    with torch.no_grad():
        got = tvit.clip_tower_features(tower, torch.from_numpy(images))
        out = tower(torch.from_numpy(images), output_layers=(0, 2))
    n = cfg_t.num_patches + int(use_class_token and select_feature == "cls_patch")
    assert got.shape == ref.shape == (2, n, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out["last"].numpy(), np.asarray(ref_all["last"]), **TOL)
    for layer in (0, 2):
        np.testing.assert_allclose(out["taps"][layer].numpy(), np.asarray(ref_all["taps"][layer]),
                                   **TOL)
    assert ("cls" in out) == ("cls" in ref_all) == use_class_token


def test_class_token_free_tower_hf_import_and_export_equal_jax():
    cfg_j, cfg_t, tree, tower = _towers(2, use_class_token=False)
    hf = {k: np.asarray(v) for k, v in jexp.export_clip_vision(tree, cfg_j).items()}
    assert not any("class_embedding" in k for k in hf)
    ref = vit_tree_to_state_dict(_numpy(jimp.import_clip_vision(hf, cfg_j)), cfg_t.num_layers)
    got = timp.import_clip_vision({k: torch.from_numpy(v.copy()) for k, v in hf.items()}, cfg_t)
    assert sorted(got) == sorted(ref) == sorted(tower.state_dict())
    for k in ref:
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    back = texp.export_clip_vision(tower.state_dict(), cfg_t)
    assert sorted(back) == sorted(hf)
    for k in hf:
        assert np.array_equal(back[k].numpy(), hf[k]), k


@pytest.mark.parametrize("scales", [(28, 56), (28, 84), (28,)])
def test_s2_tower_features_equal_jax(scales):
    cfg_j, _, tree, tower = _towers(3)
    side = max(scales)
    images = np.random.default_rng(4).normal(size=(2, side, side, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: jvit.clip_tower_features_s2(p, cfg_j, x, scales))(tree, images)
    with torch.no_grad():
        got = tvit.clip_tower_features_s2(tower, torch.from_numpy(images), scales)
    assert got.shape == ref.shape == (2, 4, 32 * len(scales))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_s2_tower_at_the_base_scale_is_the_tower():
    _, _, _, tower = _towers(5)
    images = torch.from_numpy(
        np.random.default_rng(6).normal(size=(1, 56, 56, 3)).astype(np.float32))
    with torch.no_grad():
        s2 = tvit.clip_tower_features_s2(tower, images, (28, 56))
        base = tvit.clip_tower_features(tower, resize_bicubic(images, (28, 28)))
    np.testing.assert_allclose(s2[..., :32].numpy(), base.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("output_dim,heads", [(8, 2), (None, 4)])
def test_attention_pool2d_equals_jax(output_dim, heads):
    p = _randomize(_numpy(jres.init_attention_pool2d(jax.random.PRNGKey(0), seq_len=9,
                                                     embed_dim=16, output_dim=output_dim)), 7)
    pool = load_jax_tree(tres.AttentionPool2d(9, 16, output_dim), p, "cpu")
    x = np.random.default_rng(8).normal(size=(2, 9, 16)).astype(np.float32)
    for all_tokens in (False, True):
        ref = jax.jit(lambda p, x: jres.attention_pool2d(p, x, heads, all_tokens))(p, x)
        with torch.no_grad():
            got = tres.attention_pool2d(pool, torch.from_numpy(x), heads, all_tokens)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    with torch.no_grad():
        pooled = tres.attention_pool2d(pool, torch.from_numpy(x), heads)
        every = tres.attention_pool2d(pool, torch.from_numpy(x), heads, return_all_tokens=True)
    assert torch.equal(every[:, 0], pooled)


def test_init_attention_pool2d_draws_jax_distributions():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tres.init_attention_pool2d(9, 16, generator=torch.Generator())
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            theads.init_probe_head(8, 4, generator=torch.Generator())
    pool = tres.init_attention_pool2d(9, 16, 8, generator=torch.Generator().manual_seed(0),
                                      device="cpu")
    assert pool.pos_embed.shape == (10, 16) and pool.c_proj.weight.shape == (8, 16)
    assert 0.15 < float(pool.pos_embed.detach().std()) < 0.35          # N(0, 1) / 4
    assert float(pool.q_proj.weight.detach().abs().max()) <= 0.25
    assert torch.equal(pool.q_proj.bias.detach(), torch.zeros(16))


@pytest.mark.parametrize("levels", [4, 2])
def test_probe_head_equals_jax(levels):
    p = _numpy(jheads.init_probe_head(jax.random.PRNGKey(levels), 24, 12, num_levels=levels))
    head = load_jax_tree(theads.ProbeHead(24, 12, levels), p, "cpu")
    x = np.random.default_rng(9).normal(size=(2, 5, 24)).astype(np.float32)
    ref = jax.jit(jheads.probe_head_forward)(p, x)
    with torch.no_grad():
        got = theads.probe_head_forward(head, torch.from_numpy(x))
    assert len(got) == len(ref) == levels
    for a, b in zip(got, ref):
        assert a.shape == (2, 5, 12)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    fresh = theads.init_probe_head(24, 12, levels, generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    assert [n for n, _ in fresh.named_parameters()] == [n for n, _ in head.named_parameters()]


def test_depth_intermediate_features_equal_jax():
    cfg = jconfig.tiny_test_vlm(distill=True)
    tcfg_j = cfg.distill.get_task("depth")
    tcfg_t = tconfig.tiny_test_vlm(distill=True).distill.get_task("depth")
    p = _numpy(jheads.init_task_head(jax.random.PRNGKey(1), tcfg_j, 64, num_task_tokens=2,
                                     use_intermediate_depth=True))
    head = load_jax_tree(theads.TaskHead(tcfg_t, 64, num_task_tokens=2,
                                         use_intermediate_depth=True), p, "cpu")
    feats = np.random.default_rng(10).normal(size=(2, 4, tcfg_t.head.output_dim)).astype(np.float32)
    ref = jax.jit(jheads.depth_intermediate_features)(p, feats)
    with torch.no_grad():
        got = theads.depth_intermediate_features(head, torch.from_numpy(feats))
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    plain = dataclasses.replace(tcfg_t, task="seg")
    seg_head = theads.TaskHead(plain, 64, num_task_tokens=2, use_intermediate_depth=True)
    assert len(theads.depth_intermediate_features(seg_head, torch.from_numpy(feats))) == 1
