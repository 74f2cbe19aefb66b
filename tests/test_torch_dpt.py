"""The DPT depth decoder of visper_lm_tpu_torch vs the JAX package's on the
CPU (models/teachers/dpt.py): `dpt_forward` and `normalized_depth` on JAX's
init (its zero biases drawn from N(0, 0.1^2)) at DAv2-L's widths and at a narrow
test head (rtol = atol = 1e-4: many convolutions of f32 sums), `import_dpt_head`
bit-equal to JAX's on a synthetic DAv2 state dict, `module_to_jax_tree` back to
the same tree, and `teachers["dpt"]` carried through `weights` and built by
`init_teachers`. The spec: tests/test_viz_hook.py and tests/test_demo_viz.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.models import teachers as jteach
from visper_lm_tpu.models.teachers import dpt as jdpt

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.models import teachers as tteach
from visper_lm_tpu_torch.models.teachers import dpt as tdpt
from visper_lm_tpu_torch.weights import dpt_from_jax_params, module_to_jax_tree, teachers_from_jax_params

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _randomize(tree, seed):
    """JAX's kernels as drawn; its zero biases drawn from N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (np.asarray(a) + (0.1 * rng.standard_normal(np.shape(a))
                                          if getattr(path[-1], "key", "") == "bias" else 0)
                         ).astype(np.float32), tree)


def _jax_head(in_channels, out_channels=None, features=None, seed=1):
    """JAX init_dpt_head at the given widths (the module constants, patched as
    tests/test_viz_hook.py does)."""
    old = jdpt.OUT_CHANNELS, jdpt.FEATURES
    try:
        if out_channels is not None:
            jdpt.OUT_CHANNELS, jdpt.FEATURES = out_channels, features
        tree = _randomize(jdpt.init_dpt_head(jax.random.PRNGKey(seed), in_channels), seed)
        tree["output_conv2b"]["bias"] += 1.0    # a map the final ReLU does not zero
        return tree
    finally:
        jdpt.OUT_CHANNELS, jdpt.FEATURES = old


def _feats(b, side, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, side * side, d)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("widths", [None, ((8, 16, 16, 24), 16)], ids=["dav2_l", "narrow"])
def test_dpt_forward_and_normalized_depth(widths):
    oc, f = widths or (None, None)
    tree = _jax_head(24, oc, f)
    head = dpt_from_jax_params(tree, device="cpu")
    assert tuple(c.out_channels for c in head.projects) == (oc or jdpt.OUT_CHANNELS)
    feats = _feats(2, 4, 24, 2)
    ref = jdpt.dpt_forward(tree, feats, patch_h=4, patch_w=4)
    got = tdpt.dpt_forward(head, [torch.from_numpy(x) for x in feats], patch_h=4, patch_w=4)
    assert got.shape == (2, 56, 56)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    ref_n = jdpt.normalized_depth(tree, feats)
    got_n = tdpt.normalized_depth(head, [torch.from_numpy(x) for x in feats])
    np.testing.assert_allclose(got_n.numpy(), np.asarray(ref_n), **TOL)
    assert float(got_n.min()) == 0.0 and abs(float(got_n.max()) - 1.0) < 1e-6
    # the same features four times (the viz hook's [pred] * 4)
    same = [feats[3]] * 4
    np.testing.assert_allclose(
        tdpt.normalized_depth(head, [torch.from_numpy(x) for x in same]).numpy(),
        np.asarray(jdpt.normalized_depth(tree, same)), **TOL)


def _dav2_state_dict(tree, prefix):
    """A DAv2-layout state dict (torch OIHW convs, (in, out, kh, kw) transposed
    convs) holding `tree`'s values."""
    sd = {}

    def conv(key, p, deconv=False):
        k = np.asarray(p["kernel"])
        sd[f"{prefix}{key}.weight"] = np.ascontiguousarray(
            k.transpose(2, 3, 0, 1) if deconv else k.transpose(3, 2, 0, 1))
        if "bias" in p:
            sd[f"{prefix}{key}.bias"] = np.asarray(p["bias"])

    for i in range(4):
        conv(f"projects.{i}", tree["projects"][i])
        conv(f"scratch.layer{i + 1}_rn", tree["layer_rn"][i])
        r = tree["refinenets"][i]
        for u in (1, 2):
            for c in (1, 2):
                conv(f"scratch.refinenet{i + 1}.resConfUnit{u}.conv{c}", r[f"rcu{u}"][c - 1])
        conv(f"scratch.refinenet{i + 1}.out_conv", r["out_conv"])
    conv("resize_layers.0", tree["resize0"], deconv=True)
    conv("resize_layers.1", tree["resize1"], deconv=True)
    conv("resize_layers.3", tree["resize3"])
    conv("scratch.output_conv1", tree["output_conv1"])
    conv("scratch.output_conv2.0", tree["output_conv2a"])
    conv("scratch.output_conv2.2", tree["output_conv2b"])
    return sd


@pytest.mark.parametrize("prefix", ["depth_head.", "da_v2_head.depth_head."])
def test_import_dpt_head_bit_equal_and_back(prefix):
    tree = _jax_head(24, (8, 16, 16, 24), 16, seed=3)
    sd = _dav2_state_dict(tree, prefix)
    ref = jdpt.import_dpt_head(sd, prefix=prefix)
    got = tdpt.import_dpt_head({k: torch.from_numpy(v) for k, v in sd.items()}, prefix=prefix)
    ref_l = jax.tree_util.tree_flatten_with_path(ref)[0]
    got_l = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in got_l] == [p for p, _ in ref_l]
    for (path, a), (_, b) in zip(got_l, ref_l):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    # the imported tree equals the one the state dict was made from, and a
    # module's tree is that tree again (the bundle writer's path)
    back = module_to_jax_tree(dpt_from_jax_params(got, device="cpu"))
    for src in (tree, back):
        for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(src)[0], ref_l):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def _depth_only(c):
    cfg = c.tiny_test_vlm(distill=True)
    d = cfg.distill
    return dataclasses.replace(
        cfg, distill=dataclasses.replace(d, tasks=tuple(t for t in d.tasks if t.task == "depth")))


def test_teachers_carry_dpt():
    """JAX's init_teachers builds teachers["dpt"] (DAv2-L widths at DINOv2's
    width); `teachers_from_jax_params` carries it and `init_teachers` builds it."""
    tiny = dict(image_size=28, patch_size=14, hidden_size=24, num_layers=1, num_heads=2,
                mlp_dim=48, norm_eps=1e-6, hidden_act="gelu", use_pre_norm=False, dtype="float32")
    jt = jteach.TeacherConfigs(dinov2=jconfig.VisionConfig(**tiny))
    tt = tteach.TeacherConfigs(dinov2=tconfig.VisionConfig(**tiny))
    tree = jax.tree_util.tree_map(np.asarray, jteach.init_teachers(
        jax.random.PRNGKey(2), _depth_only(jconfig), dtype=np.float32, tcfgs=jt))
    assert sorted(tree) == ["dinov2", "dpt"]
    tree["dpt"] = _randomize(tree["dpt"], 4)
    port = teachers_from_jax_params(tree, _depth_only(tconfig), tt, device="cpu")
    assert sorted(port) == ["dinov2", "dpt"]
    assert not any(p.requires_grad for p in port.parameters())
    feats = _feats(1, 3, 24, 5)
    np.testing.assert_allclose(
        tdpt.normalized_depth(port["dpt"], [torch.from_numpy(x) for x in feats]).numpy(),
        np.asarray(jdpt.normalized_depth(tree["dpt"], feats)), **TOL)
    built = tteach.init_teachers(_depth_only(tconfig), tt, device="cpu", dtype=torch.float32)
    assert sorted(built) == ["dinov2", "dpt"]
    shapes = {k: tuple(v.shape) for k, v in port["dpt"].state_dict().items()}
    assert {k: tuple(v.shape) for k, v in built["dpt"].state_dict().items()} == shapes
    # JAX's init distribution: |kernel| <= 1 / sqrt(fan_in), biases 0
    w = built["dpt"].projects[0].weight
    assert float(w.abs().max()) <= 24 ** -0.5 and float(built["dpt"].projects[0].bias.abs().max()) == 0
