"""The whole PT distillation step of the port vs the JAX package's, on the
CPU: `tiny_test_vlm(distill=True)` with the tiny teachers of
tests/test_train_e2e.py computing their targets in the step (micro-batches of
2), NTP + smooth-L1 + contrastive, AdamW on the trainable subset; the JAX step
on a single-device CPU mesh as bench.py builds it, with the XLA attention.

f32 throughout. Tolerances: loss and metrics rtol 1e-5; step-1 gradients
atol 1e-4 x the tensor's largest |grad| + rtol 1e-3 (the decoder's sums, as
through the decoder in tests/test_torch_models.py); trainables after three
updates atol 2e-5 / rtol 1e-4.

Also: the chunked cross-entropy (against `ntp_loss` and JAX's, and its
switch in the loss), gradient accumulation (identical micro-batches against
one step; distinct ones against JAX's accumulated update) and f32 master
weights (against optax over three updates of bf16 parameters); each test
states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from visper_lm_tpu.data.collate import build_splice_plan
from visper_lm_tpu.models import teachers as jteach
from visper_lm_tpu.models import vlm as jvlm
from visper_lm_tpu.models.teachers import swin as jswin
from visper_lm_tpu.models.teachers import unclip as junclip
from visper_lm_tpu.parallel.mesh import make_mesh
from visper_lm_tpu.train import losses as jloss
from visper_lm_tpu.train import optimizer as jopt
from visper_lm_tpu.train import train_step as jts

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.data.collate import collate_plans
from visper_lm_tpu_torch.models import teachers as tteach
from visper_lm_tpu_torch.models.teachers import swin as tswin
from visper_lm_tpu_torch.train import losses as tloss
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


# ---------------------------------------------------------------------------
# The chunked cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t, tied", [(257, False), (300, False), (700, False), (513, True)])
def test_chunked_cross_entropy_matches_ntp_loss_and_jax(t, tied):
    """ntp_loss_chunked against ntp_loss on the full logits (loss and the
    gradients to hidden and to the head) and JAX's ntp_loss_chunked, rtol
    1e-6 (gradients 1e-5 relative to their largest value). t - 1 is a
    multiple of 256 (257, 513) or not (300, 700: padded with IGNORE_INDEX);
    tied: hidden is drawn from the head's own rows (a tied embedding), so the
    head's gradient comes by both paths."""
    rng = np.random.default_rng(t)
    b, d, v = 2, 16, 40
    weight = rng.standard_normal((v, d)).astype(np.float32)
    ids = rng.integers(0, v, size=(b, t))
    labels = rng.integers(0, v, size=(b, t)).astype(np.int32)
    labels[0, : t // 3] = IGNORE_INDEX
    labels[1, -5:] = IGNORE_INDEX
    hidden = rng.standard_normal((b, t, d)).astype(np.float32)
    lab = torch.from_numpy(labels)

    def port(chunked):
        w = torch.from_numpy(weight).requires_grad_(True)
        h0 = torch.from_numpy(hidden).requires_grad_(True)
        h = 1.5 * w[torch.from_numpy(ids)] + h0 if tied else h0
        loss = (tloss.ntp_loss_chunked(h, w, lab) if chunked
                else tloss.ntp_loss(h @ w.T, lab))
        return (loss.detach(), *torch.autograd.grad(loss, [w, h0]))

    got, ref = port(True), port(False)
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-6)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-5 * float(r.abs().max()))
    h_in = 1.5 * weight[ids] + hidden if tied else hidden
    ref_j = jloss.ntp_loss_chunked(jnp.asarray(h_in), jnp.asarray(weight.T), jnp.asarray(labels))
    np.testing.assert_allclose(float(got[0]), float(ref_j), rtol=1e-6)


def test_loss_takes_the_chunked_cross_entropy_where_jax_does(monkeypatch):
    """The step's switch (B * T * vocab >= 2^27, JAX's) and its wiring: with
    the switch forced on, the tiny step's loss and trainable gradients equal
    those of the full logits (rtol 1e-6), without computing the logits."""
    cfg = tconfig.tiny_test_vlm(distill=True)
    assert not tts.uses_chunked_ce(cfg, 4, 64)
    phi3 = tconfig.phi3_clip_vlm(distill=True)
    assert not tts.uses_chunked_ce(phi3, 4, 1024) and tts.uses_chunked_ce(phi3, 8, 1024)
    params = jvlm.init_vlm(jax.random.PRNGKey(0), jconfig.tiny_test_vlm(distill=True))
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    batch = _batch(jconfig.tiny_test_vlm(distill=True))
    for t in cfg.distill.tasks:
        batch[f"{t.task}_target"] = np.random.default_rng(5).normal(
            size=(4, t.target_tokens, t.target_dim)).astype(np.float32)
    step = tts.make_train_step(cfg, topt.OptimizerConfig(**OPT), model)
    met_full, grads_full = step.loss_and_grads(batch)
    seen = []
    orig = tloss.ntp_loss_chunked
    monkeypatch.setattr(tts, "uses_chunked_ce", lambda *a: True)
    monkeypatch.setattr(tts, "ntp_loss_chunked", lambda *a, **k: seen.append(1) or orig(*a, **k))
    met_chunk, grads_chunk = step.loss_and_grads(batch)
    assert seen
    for k in met_full:
        np.testing.assert_allclose(float(met_chunk[k]), float(met_full[k]), rtol=1e-6, err_msg=k)
    for n, g in grads_full.items():
        np.testing.assert_allclose(grads_chunk[n].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(g.abs().max()), err_msg=n)


# ---------------------------------------------------------------------------
# Gradient accumulation
# ---------------------------------------------------------------------------


def _targets(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    out = dict(batch)
    for t in cfg.distill.tasks:
        out[f"{t.task}_target"] = rng.normal(size=(4, t.target_tokens, t.target_dim)).astype(np.float32)
    return out


ACC_OPT = dict(learning_rate=5e-3, total_steps=20, warmup_ratio=0.0, stage="pretrain")


@pytest.fixture(scope="module")
def accum_runs():
    """Two accumulated updates over distinct micro-batches (targets in the
    batch), JAX's and the port's, from the same weights: per-step metrics
    and the trainables after; and the port's single step on one micro-batch
    beside its accumulated step over two copies of it."""
    cfg_j, cfg_t = jconfig.tiny_test_vlm(distill=True), tconfig.tiny_test_vlm(distill=True)
    params = jvlm.init_vlm(jax.random.PRNGKey(0), cfg_j)
    b0 = _targets(cfg_j, _batch(cfg_j), 7)
    b1 = _targets(cfg_j, _batch(cfg_j), 3)
    b1["images"] = np.random.default_rng(9).normal(size=b1["images"].shape).astype(np.float32)
    stacked = {k: np.stack([b0[k], b1[k]]) for k in b0}
    mesh = make_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    with mesh:
        step_j, state, _ = jts.make_train_step(
            cfg_j, jopt.OptimizerConfig(**ACC_OPT), params, mesh, use_pallas=False, accum_steps=2,
        )
        dbatch = jts.shard_batch(stacked, mesh, leading_accum=True)
        metrics_j = []
        for _ in range(2):
            state, m = step_j(state, dbatch)
            metrics_j.append({k: float(v) for k, v in m.items()})
    host = jax.tree_util.tree_map(np.asarray, params)

    def port(accum, batch):
        model = from_jax_params(host, cfg_t, device="cpu")
        step = tts.make_train_step(cfg_t, topt.OptimizerConfig(**ACC_OPT), model, accum_steps=accum)
        metrics = [step(batch) for _ in range(2)]
        return metrics, {n: p.detach().clone() for n, p in step.trainable.items()}, step.step

    return dict(
        metrics_j=metrics_j, params_j=_flat(state.params), step_j=int(state.step),
        accum=port(2, stacked), single=port(1, b0),
        twice=port(2, {k: np.stack([v, v]) for k, v in b0.items()}),
    )


def test_accumulating_identical_micro_batches_equals_a_single_step(accum_runs):
    (m_single, p_single, _), (m_twice, p_twice, _) = accum_runs["single"], accum_runs["twice"]
    for a, b in zip(m_twice, m_single):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    for n, p in p_single.items():
        np.testing.assert_allclose(p_twice[n].numpy(), p.numpy(), rtol=1e-6, atol=1e-7, err_msg=n)


def test_accumulated_update_over_distinct_micro_batches_matches_jax(accum_runs):
    """One update on the mean of two micro-batches' gradients (summed in
    f32), metrics averaged over them; update 1 has lr 0, so the trainables
    after update 2 show the accumulated gradient. Tolerances as the single
    step's: metrics rtol 1e-5, trainables atol 2e-5 / rtol 1e-4."""
    metrics, params, steps = accum_runs["accum"]
    assert steps == accum_runs["step_j"] == 2
    for m_t, m_j in zip(metrics, accum_runs["metrics_j"]):
        assert sorted(m_t) == sorted(m_j)
        for k in m_j:
            np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert metrics[1]["loss"] == metrics[0]["loss"]          # lr 0 on update 1
    for n, p in params.items():
        np.testing.assert_allclose(_port_view(n, p.numpy()), accum_runs["params_j"][topt.jax_path(n)],
                                   atol=2e-5, rtol=1e-4, err_msg=n)
    single = accum_runs["single"][1]
    assert any(not torch.equal(params[n], single[n]) for n in params)


# ---------------------------------------------------------------------------
# f32 master weights
# ---------------------------------------------------------------------------


def test_master_weights_match_optax_over_three_updates():
    """f32 master weights (JAX `with_master_weights`, on a bf16 param tree,
    last in `make_optimizer`'s chain) over three updates of the same f32
    gradients: the master copies match optax's (rtol 1e-6, atol 1e-7: the
    schedule is f32 there and double here, XLA divides the first moment by
    bc1 x (sqrt + eps), and where a parameter differs by an ulp (below) its
    weight decay term differs by wd x lr x that ulp), every parameter is
    its master rounded to bf16, and so is optax's except where JAX's delta
    round(master) - p, added in bf16, rounds. Those elements are worked out
    from JAX's previous parameter (float64 sums, one rounding to bf16 each),
    none lies within a factor 2 of its previous value (where the delta is
    exact), and the port's parameter equals optax's everywhere else. The port keeps both moments in f32 whatever the parameter dtype,
    so optax's state is made from f32 copies of the parameters (its second
    moment then is f32 too) and it updates the bf16 parameters."""
    rng = np.random.default_rng(11)
    shapes = {"mm_projector.layers.0.weight": (24, 16), "mm_projector.layers.0.bias": (24,),
              "special_tokens.gen": (2, 16), "heads.gen.0.proj_out.weight": (8, 16),
              "logit_scales.gen": ()}
    init = {n: np.asarray(0.05 * rng.standard_normal(s), np.float32) for n, s in shapes.items()}
    cfg = dict(learning_rate=2e-3, total_steps=10, warmup_ratio=0.0, weight_decay=0.1,
               stage="pretrain", master_weights=True)

    def tree(flat):
        out = {}
        for n, a in flat.items():
            node = out
            parts = topt.jax_path(n).split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = _port_view(n, a)
        return out

    def bf16(a):
        """float64 values held exactly in f32, rounded once to bf16 (as f64)."""
        a = np.asarray(a, np.float64)
        assert np.array_equal(a.astype(np.float32), a)
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).double().numpy()

    bf = {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in init.items()}
    init32 = {n: t.float().numpy() for n, t in bf.items()}      # the bf16 values, in f32
    port = topt.AdamW(list((n, torch.nn.Parameter(t)) for n, t in bf.items()),
                      topt.OptimizerConfig(**cfg))
    jcfg = jopt.OptimizerConfig(**cfg)
    params_j = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree(init32))
    tx = jopt.make_optimizer(tree(init32), jcfg)
    state_j = tx.init(jax.tree_util.tree_map(jnp.asarray, tree(init32)))
    update = jax.jit(tx.update)
    rounded_off = 0
    for _ in range(3):
        prev_j = {k: np.asarray(v, np.float64) for k, v in _flat(params_j).items()}
        grads = {n: np.asarray(rng.standard_normal(s), np.float32) for n, s in shapes.items()}
        port.step({n: torch.from_numpy(g) for n, g in grads.items()})
        upd, state_j = update(jax.tree_util.tree_map(jnp.asarray, tree(grads)), state_j, params_j)
        params_j = optax.apply_updates(params_j, upd)
        masters = [s for s in jax.tree_util.tree_leaves(
            state_j, is_leaf=lambda x: isinstance(x, dict) and "master" in x)
            if isinstance(s, dict) and "master" in s]
        master_j = {}
        for s in masters:
            master_j.update({k: np.asarray(v) for k, v in _flat(s["master"]).items()
                             if hasattr(v, "shape")})
        flat_j = _flat(params_j)
        for n, p in port.params.items():
            key = topt.jax_path(n)
            m_t = port.master[n]
            np.testing.assert_allclose(_port_view(n, m_t.numpy()), master_j[key], rtol=1e-6,
                                       atol=1e-7, err_msg=n)
            assert torch.equal(p.detach(), m_t.to(torch.bfloat16)), n
            p_t = _port_view(n, p.detach().double().numpy())
            p_j, prev = flat_j[key].astype(np.float64), prev_j[key]
            target = bf16(master_j[key])
            snapped = bf16(prev + bf16(target - prev)) == target
            np.testing.assert_array_equal(p_j == target, snapped, err_msg=n)
            # Sterbenz: target - prev is exact in bf16 where they are within a factor 2
            exact = (prev * target > 0) & (np.abs(target) * 2 >= np.abs(prev)) & (
                np.abs(target) <= 2 * np.abs(prev))
            assert not (exact & ~snapped).any(), n
            np.testing.assert_array_equal(p_t[snapped], p_j[snapped], err_msg=n)
            rounded_off += int((~snapped).sum())
    moved = sum(int((p.detach().float().numpy() != init32[n]).sum())
                for n, p in port.params.items())
    assert moved > 0
    assert rounded_off < moved
