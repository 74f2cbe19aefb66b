"""The whole PT distillation step of the port vs the JAX package's, on the
CPU: `tiny_test_vlm(distill=True)` with the tiny teachers of
tests/test_train_e2e.py computing their targets in the step (micro-batches of
2), NTP + smooth-L1 + contrastive, AdamW on the trainable subset; the JAX step
on a single-device CPU mesh as bench.py builds it, with the XLA attention.

f32 throughout. Tolerances: loss and metrics rtol 1e-5; step-1 gradients
atol 1e-4 x the tensor's largest |grad| + rtol 1e-3 (the decoder's sums, as
through the decoder in tests/test_torch_models.py); trainables after three
updates atol 2e-5 / rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from visper_lm_tpu.data.collate import build_splice_plan
from visper_lm_tpu.models import teachers as jteach
from visper_lm_tpu.models import vlm as jvlm
from visper_lm_tpu.models.teachers import swin as jswin
from visper_lm_tpu.models.teachers import unclip as junclip
from visper_lm_tpu.parallel.mesh import make_mesh
from visper_lm_tpu.train import optimizer as jopt
from visper_lm_tpu.train import train_step as jts

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.data.collate import collate_plans
from visper_lm_tpu_torch.models import teachers as tteach
from visper_lm_tpu_torch.models.teachers import swin as tswin
from visper_lm_tpu_torch.train import optimizer as topt
from visper_lm_tpu_torch.train import train_step as tts
from visper_lm_tpu_torch.weights import from_jax_params, teachers_from_jax_params

torch.set_num_threads(2)

STEPS = 3
OPT = dict(learning_rate=3e-3, total_steps=30, warmup_ratio=0.1, stage="pretrain")
TINY_TEACHERS = dict(
    dinov2=dict(image_size=28, patch_size=14, hidden_size=24, num_layers=2, num_heads=2,
                mlp_dim=48, norm_eps=1e-6, hidden_act="gelu", use_pre_norm=False, dtype="float32"),
    clip_h=dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=2,
                mlp_dim=64, hidden_act="gelu", dtype="float32"),
    swin=dict(embed_dim=2, depths=(1, 1, 1, 1), num_heads=(1, 1, 1, 2), window_size=2),
)


def _batch(cfg, bsz=4, seq=64):
    rng = np.random.default_rng(0)
    plans = []
    for b in range(bsz):
        ids = [1, 2, 3] + [IMAGE_TOKEN_INDEX] + list(rng.integers(3, 400, size=8 + b))
        labels = [IGNORE_INDEX] * 4 + ids[4:]
        plans.append(build_splice_plan(
            ids, labels, seq, num_image_tokens=cfg.num_image_tokens, num_task_tokens=2, num_tasks=3,
        ))
    img = rng.normal(size=(bsz, 28, 28, 3)).astype(np.float32)
    batch = collate_plans(plans, images=img)
    batch["depth_images"] = img
    batch["gen_images"] = rng.normal(size=(bsz, 28, 28, 3)).astype(np.float32)
    batch["seg_images"] = rng.normal(size=(bsz, 64, 64, 3)).astype(np.float32)
    for t in cfg.distill.tasks:
        batch[f"{t.task}_mask"] = np.ones((bsz,), np.float32)
    return batch


def _flat(tree):
    return {
        jopt._path_str(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _port_view(name, arr):
    return arr.T if topt.jax_path(name).endswith("/kernel") else arr


@pytest.fixture(scope="module")
def runs():
    """Both steps on the same weights and batch: JAX's step-1 loss, metrics
    and grads (jit of value_and_grad) and its trainables after STEPS updates;
    the port's step-1 grads, per-step metrics, and frozen parameters before
    and after."""
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    jt = jteach.TeacherConfigs(
        dinov2=jconfig.VisionConfig(**TINY_TEACHERS["dinov2"]),
        clip_h=jconfig.VisionConfig(**TINY_TEACHERS["clip_h"]),
        swin=jswin.SwinConfig(**TINY_TEACHERS["swin"]),
    )
    tt = tteach.TeacherConfigs(
        dinov2=tconfig.VisionConfig(**TINY_TEACHERS["dinov2"]),
        clip_h=tconfig.VisionConfig(**TINY_TEACHERS["clip_h"]),
        swin=tswin.SwinConfig(**TINY_TEACHERS["swin"]),
        gen_embed_dim=24,
    )
    params = jvlm.init_vlm(jax.random.PRNGKey(0), cfg_j)
    old = junclip.GEN_EMBED_DIM
    junclip.GEN_EMBED_DIM = 24
    try:
        teachers = jteach.init_teachers(jax.random.PRNGKey(1), cfg_j, dtype=jnp.float32, tcfgs=jt)
    finally:
        junclip.GEN_EMBED_DIM = old
    batch = _batch(cfg_j)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    # JAX: step-1 loss, metrics, grads; then STEPS updates
    tfn_j = jteach.make_teacher_fn(cfg_j, jt)
    loss_fn = jts.make_loss_fn(cfg_j, teacher_fn=tfn_j, use_pallas=False)
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, jbatch, teachers)
    mesh = make_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    metrics_j = []
    with mesh:
        step_j, state, _ = jts.make_train_step(
            cfg_j, jopt.OptimizerConfig(**OPT), params, mesh,
            teacher_fn=tfn_j, teacher_params=teachers, use_pallas=False,
        )
        dbatch = jts.shard_batch(batch, mesh)
        for _ in range(STEPS):
            state, m = step_j(state, dbatch)
            metrics_j.append({k: float(v) for k, v in m.items()})

    # port
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    tch = teachers_from_jax_params(jax.tree_util.tree_map(np.asarray, teachers), cfg_t, tt, device="cpu")
    step = tts.make_train_step(
        cfg_t, topt.OptimizerConfig(**OPT), model,
        teacher_fn=tteach.make_teacher_fn(cfg_t, tt), teacher_params=tch,
    )
    frozen_before = {
        n: p.detach().clone() for n, p in list(model.named_parameters()) + [
            ("teachers." + n, p) for n, p in tch.named_parameters()]
        if n not in step.trainable
    }
    met_t, grads_t = step.loss_and_grads(batch)
    metrics_t = [step(batch) for _ in range(STEPS)]
    frozen_after = {
        n: p.detach() for n, p in list(model.named_parameters()) + [
            ("teachers." + n, p) for n, p in tch.named_parameters()]
        if n not in step.trainable
    }
    return dict(
        loss_j=float(loss_j), met_j={k: float(v) for k, v in met_j.items()},
        grads_j=_flat(grads_j), params_j=_flat(state.params), metrics_j=metrics_j,
        met_t=met_t, grads_t=grads_t, metrics_t=metrics_t, step=step,
        frozen_before=frozen_before, frozen_after=frozen_after,
    )


def test_first_step_loss_and_metrics_match_jax(runs):
    met_t, met_j = runs["met_t"], runs["met_j"]
    assert sorted(met_t) == sorted(met_j)
    for k in met_j:
        np.testing.assert_allclose(float(met_t[k]), met_j[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(met_t["loss"]), runs["loss_j"], rtol=1e-5)


def test_first_step_trainable_grads_match_jax(runs):
    """Every trainable: projector, task tokens (reached through the splice
    and as head latents), heads, logit scales. The depth heads'
    intermediate MLPs get zero gradients on both sides."""
    grads_t, grads_j = runs["grads_t"], runs["grads_j"]
    assert len(grads_t) == 90
    for name, g in grads_t.items():
        ref = grads_j[topt.jax_path(name)]
        got = _port_view(name, g.numpy())
        np.testing.assert_allclose(
            got, ref, atol=1e-4 * float(np.abs(ref).max()) + 1e-12, rtol=1e-3, err_msg=name,
        )
    assert any(n.startswith("special_tokens.") for n in grads_t)
    assert float(grads_t["heads.depth.0.intermediate.0.fc1.weight"].abs().max()) == 0.0


def test_trainables_after_three_steps_match_jax(runs):
    """lr 0 on update 1 (warmup starts at 0), so steps 1 and 2 see the same
    loss; every metric of every step and the trainables after the third."""
    for m_t, m_j in zip(runs["metrics_t"], runs["metrics_j"]):
        for k in m_j:
            np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert runs["metrics_t"][0]["loss"] == runs["metrics_t"][1]["loss"]
    assert runs["metrics_t"][2]["loss"] != runs["metrics_t"][1]["loss"]
    for name, p in runs["step"].trainable.items():
        ref = runs["params_j"][topt.jax_path(name)]
        np.testing.assert_allclose(
            _port_view(name, p.detach().numpy()), ref, atol=2e-5, rtol=1e-4, err_msg=name,
        )


def test_frozen_parameters_are_unchanged_bit_for_bit(runs):
    before, after = runs["frozen_before"], runs["frozen_after"]
    assert any(n.startswith("decoder.") for n in before)
    assert any(n.startswith("teachers.swin.") for n in before)
    assert not any(n.startswith("decoder.") or n.startswith("vision_tower.") for n in runs["step"].trainable)
    for n, p in before.items():
        assert not after[n].requires_grad, n
        assert torch.equal(p, after[n]), n


def test_loss_raises_where_the_chunked_cross_entropy_would_run():
    cfg = tconfig.tiny_test_vlm(distill=True)
    loss_fn = tts.make_loss_fn(cfg)
    with pytest.raises(NotImplementedError, match="chunked"):
        loss_fn(None, {"labels": torch.zeros((4, 65536), dtype=torch.int32)})
