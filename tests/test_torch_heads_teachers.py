"""Port distillation heads, teacher towers and the teacher function vs their
JAX twins on the CPU (f32).

JAX params are carried onto the port's modules by `weights.load_jax_tree` and
`teachers_from_jax_params`; inputs are made with numpy from a seed.
Tolerances: atol 1e-5 / rtol 1e-4 per module (f32 sums in a different
order), 1e-4 / 1e-3 through the Swin backbone and the teacher targets (many
layers of such sums).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.models import heads as jheads
from visper_lm_tpu.models import resampler as jres
from visper_lm_tpu.models import teachers as jteach
from visper_lm_tpu.models import vit as jvit
from visper_lm_tpu.models.teachers import dinov2 as jdino
from visper_lm_tpu.models.teachers import swin as jswin
from visper_lm_tpu.models.teachers import unclip as junclip

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.models import heads as theads
from visper_lm_tpu_torch.models import resampler as tres
from visper_lm_tpu_torch.models import teachers as tteach
from visper_lm_tpu_torch.models import vit as tvit
from visper_lm_tpu_torch.models.teachers import dinov2 as tdino
from visper_lm_tpu_torch.models.teachers import swin as tswin
from visper_lm_tpu_torch.models.teachers import unclip as tunclip
from visper_lm_tpu_torch.weights import load_jax_tree, teachers_from_jax_params

torch.set_num_threads(2)


def _close(port, ref, atol=1e-5, rtol=1e-4):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _vision(cfg_j):
    return tconfig.VisionConfig(**{f: getattr(cfg_j, f) for f in cfg_j.__dataclass_fields__})


TINY_DINO = jconfig.VisionConfig(
    image_size=28, patch_size=14, hidden_size=24, num_layers=2, num_heads=2, mlp_dim=48,
    norm_eps=1e-6, hidden_act="gelu", use_pre_norm=False, dtype="float32",
)
TINY_CLIP_H = jconfig.VisionConfig(
    image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64,
    hidden_act="gelu", dtype="float32",
)
# two shifted stages: 64 px / 4 = 16x16 and 8x8, both > window 4
SHIFTED_SWIN = dict(embed_dim=8, depths=(2, 2), num_heads=(2, 4), window_size=4)


def test_teacher_tower_configs_match_jax():
    import dataclasses

    for name in ("DINOV2_VIT_L", "CLIP_VIT_H_224"):
        assert dataclasses.asdict(getattr(tconfig, name)) == dataclasses.asdict(getattr(jconfig, name))
    assert dataclasses.asdict(tswin.SWIN_L) == dataclasses.asdict(jswin.SWIN_L)


@pytest.mark.parametrize("task", ["gen", "depth", "seg"])
def test_resampler_and_task_head_match_jax(task):
    """Task-token heads at the tiny config's gen / depth / seg shapes (depth
    runs at the LLM width and carries its intermediate MLPs), and the
    resampler with learned latents."""
    cfg = jconfig.tiny_test_vlm(distill=True)
    tcfg_j = cfg.distill.get_task(task)
    tcfg_t = tconfig.tiny_test_vlm(distill=True).distill.get_task(task)
    p = _np(jheads.init_task_head(
        jax.random.PRNGKey(1), tcfg_j, 64, num_task_tokens=2, use_intermediate_depth=True,
    ))
    head = load_jax_tree(
        theads.TaskHead(tcfg_t, 64, num_task_tokens=2, use_intermediate_depth=True), p, "cpu",
    )
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 10, 64)).astype(np.float32)
    lat = rng.standard_normal((2, 2 if task == "gen" else tcfg_j.head.num_tokens, 64)).astype(np.float32)
    got = theads.task_head_forward(head, _t(x), _t(lat))
    assert tuple(got.shape) == (2, tcfg_j.head.num_tokens, tcfg_j.head.output_dim)
    _close(got, jheads.task_head_forward(p, tcfg_j, x, lat))
    if task == "depth":  # the intermediate MLPs are carried (visualisation path only)
        for i, mlp in enumerate(head.intermediate):
            _close(mlp(got), jheads._build_mlp(p["intermediate"][i], np.asarray(got.detach())))
    # tiled latents (num_tokens a multiple of M) and learned latents
    pr = _np(jres.init_resampler(jax.random.PRNGKey(2), tcfg_j.head, 64))
    res = load_jax_tree(tres.Resampler(tcfg_t.head, 64), pr, "cpu")
    _close(res(_t(x)), jres.resampler_forward(pr, tcfg_j.head, x))
    if tcfg_j.head.num_tokens > 1:
        lat2 = lat[:, :2]
        prt = _np(jres.init_resampler(jax.random.PRNGKey(3), tcfg_j.head, 64, task_token=True))
        rt = load_jax_tree(tres.Resampler(tcfg_t.head, 64, task_token=True), prt, "cpu")
        _close(rt(_t(x), _t(lat2)), jres.resampler_forward(prt, tcfg_j.head, x, lat2))


@pytest.fixture(scope="module")
def tiny_teachers():
    """JAX tiny teachers (the shapes of tests/test_train_e2e.py) and the port's
    copies; CLIP-H's projection is 24 wide, the tiny gen target's width."""
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    jt = jteach.TeacherConfigs(
        dinov2=TINY_DINO, clip_h=TINY_CLIP_H,
        swin=jswin.SwinConfig(embed_dim=2, depths=(1, 1, 1, 1), num_heads=(1, 1, 1, 2), window_size=2),
    )
    old = junclip.GEN_EMBED_DIM
    junclip.GEN_EMBED_DIM = 24
    try:
        tree = _np(jteach.init_teachers(jax.random.PRNGKey(1), cfg_j, dtype=jnp.float32, tcfgs=jt))
    finally:
        junclip.GEN_EMBED_DIM = old
    rng = np.random.default_rng(5)
    for ls in ("ls1", "ls2"):  # layerscale away from its 1e-5 init, so the branch shows
        g = tree["dinov2"]["blocks"][ls]["gamma"]
        tree["dinov2"]["blocks"][ls]["gamma"] = rng.standard_normal(g.shape).astype(np.float32)
    tt = tteach.TeacherConfigs(
        dinov2=_vision(TINY_DINO), clip_h=_vision(TINY_CLIP_H),
        swin=tswin.SwinConfig(embed_dim=2, depths=(1, 1, 1, 1), num_heads=(1, 1, 1, 2), window_size=2),
        gen_embed_dim=24,
    )
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    port = teachers_from_jax_params(tree, cfg_t, tt, device="cpu")
    return cfg_j, jt, tree, cfg_t, tt, port


@pytest.mark.parametrize("tower", ["dinov2", "clip_h"])
def test_teacher_towers_match_jax(tiny_teachers, tower):
    """DINOv2 (layerscale, no pre-norm, exact gelu) with its depth target, and
    CLIP-H (visual projection of the CLS token) with its gen target."""
    cfg_j, jt, tree, cfg_t, tt, port = tiny_teachers
    vcfg = getattr(jt, tower)
    p, mod = tree[tower], port[tower]
    assert (mod.pre_norm is None) == (tower == "dinov2")
    images = np.random.default_rng(4).standard_normal((2, 28, 28, 3)).astype(np.float32)
    ref = jvit.vit_forward(p, vcfg, images, output_layers=(0, 1))
    out = mod(_t(images), output_layers=(0, 1))
    for layer in (0, 1):
        _close(out["taps"][layer], ref["taps"][layer])
    _close(out["last"], ref["last"])
    _close(out["cls"], ref["cls"])
    if tower == "dinov2":
        _close(tdino.dav2_depth_target(mod, _t(images)), jdino.dav2_depth_target(p, vcfg, images))
    else:
        assert tuple(out["cls"].shape) == (2, 24)
        _close(tunclip.gen_target(mod, _t(images)), junclip.gen_target(p, vcfg, images))


def test_swin_forward_with_shifted_stages_matches_jax():
    """Two stages, both shifted (16x16 and 8x8 maps, window 4), non-zero
    relative-position tables; every stage's normed map (seg_target, the
    4-stage map, is held in test_make_teacher_fn_matches_jax)."""
    cfg_j = jswin.SwinConfig(**SHIFTED_SWIN)
    p = _np(jswin.init_swin(jax.random.PRNGKey(3), cfg_j))
    rng = np.random.default_rng(6)
    for stage in p["stages"]:
        rb = stage["blocks"]["rel_bias"]
        stage["blocks"]["rel_bias"] = rng.standard_normal(rb.shape).astype(np.float32)
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    tt = tteach.TeacherConfigs(swin=tswin.SwinConfig(**SHIFTED_SWIN))
    mod = teachers_from_jax_params({"swin": p}, cfg_t, tt, device="cpu")["swin"]
    images = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = jswin.swin_forward(p, cfg_j, images)
    got = tswin.swin_forward(mod, _t(images))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _close(g, r, 1e-4, 1e-3)
    # the helpers the kernel path relies on are the JAX ones
    np.testing.assert_array_equal(tswin._rel_pos_index(4), jswin._rel_pos_index(4))
    np.testing.assert_array_equal(tswin._shift_attn_mask(8, 8, 4, 2), jswin._shift_attn_mask(8, 8, 4, 2))


@pytest.mark.parametrize("microbatch", [2, None])
def test_make_teacher_fn_matches_jax(tiny_teachers, microbatch):
    """All three targets, micro-batched in chunks of 2 or run whole."""
    cfg_j, jt, tree, cfg_t, tt, port = tiny_teachers
    rng = np.random.default_rng(7)
    batch = {
        "depth_images": rng.standard_normal((4, 28, 28, 3)).astype(np.float32),
        "gen_images": rng.standard_normal((4, 28, 28, 3)).astype(np.float32),
        "seg_images": rng.standard_normal((4, 64, 64, 3)).astype(np.float32),
    }
    ref = jteach.make_teacher_fn(cfg_j, jt, microbatch=microbatch)(
        jax.tree_util.tree_map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()}
    )
    got = tteach.make_teacher_fn(cfg_t, tt, microbatch=microbatch)(port, batch)
    assert sorted(got) == sorted(ref) == ["depth", "gen", "seg"]
    for task in got:
        assert got[task].dtype == torch.float32 and not got[task].requires_grad
        _close(got[task], ref[task], 1e-4, 1e-3)
