"""Port losses, schedule, AdamW and stage masks vs the JAX package (optax) on
the CPU, f32. Tolerances: atol 1e-6 / rtol 1e-5 for the losses and the
schedule (f32 reductions in a different order), 1e-6 / 1e-5 for parameters
after three AdamW updates.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.models import vlm as jvlm
from visper_lm_tpu.train import losses as jloss
from visper_lm_tpu.train import optimizer as jopt

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.models import vlm as tvlm
from visper_lm_tpu_torch.train import losses as tloss
from visper_lm_tpu_torch.train import optimizer as topt

torch.set_num_threads(2)


def _close(port, ref, atol=1e-6, rtol=1e-5):
    np.testing.assert_allclose(
        port.detach().numpy() if torch.is_tensor(port) else port, np.asarray(ref),
        atol=atol, rtol=rtol,
    )


def _t(x):
    return torch.from_numpy(np.array(x))


def test_ntp_smooth_l1_and_contrastive_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 9, 17)).astype(np.float32)
    labels = rng.integers(0, 17, size=(3, 9)).astype(np.int32)
    labels[0, :4] = -100
    labels[2, :] = -100
    _close(tloss.ntp_loss(_t(logits), _t(labels)), jloss.ntp_loss(logits, labels))
    pred = (2 * rng.standard_normal((4, 5, 6))).astype(np.float32)
    tgt = rng.standard_normal((4, 5, 6)).astype(np.float32)
    _close(tloss.smooth_l1(_t(pred), _t(tgt)), jloss.smooth_l1(pred, tgt))
    for scale in (2.0, 5.0):  # exp(5) > 100 is clamped
        s = np.float32(scale)
        _close(tloss.contrastive_loss(_t(pred), _t(tgt), torch.tensor(s)),
               jloss.contrastive_loss(pred, tgt, jnp.asarray(s)))
    mask = np.array([1, 0, 1, 1], np.float32)
    for scale in (None, np.float32(2.0)):
        got = tloss.emb_loss(_t(pred), _t(tgt), _t(mask), None if scale is None else torch.tensor(scale), 0.3)
        ref = jloss.emb_loss(pred, tgt, mask, None if scale is None else jnp.asarray(scale), 0.3)
        for g, r in zip(got, ref):
            _close(g, r)


@pytest.mark.parametrize("mask_bug", [False, True])
def test_distill_losses_and_metrics_match_jax(mask_bug):
    import dataclasses

    cfg_j = jconfig.tiny_test_vlm(distill=True)
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    if mask_bug:
        cfg_j = dataclasses.replace(cfg_j, distill=dataclasses.replace(cfg_j.distill, replicate_mask_zero_bug=True))
        cfg_t = dataclasses.replace(cfg_t, distill=dataclasses.replace(cfg_t.distill, replicate_mask_zero_bug=True))
    rng = np.random.default_rng(1)
    preds, targets, masks = {}, {}, {}
    for tc in cfg_j.distill.tasks:
        shape = (3, tc.target_tokens, tc.target_dim)
        preds[tc.task] = [rng.standard_normal(shape).astype(np.float32) for _ in tc.layer_indices]
        targets[tc.task] = rng.standard_normal(shape).astype(np.float32)
        masks[tc.task] = np.array([1, 1, 0], np.float32)
    scales = {"gen": np.float32(2.0), "depth": np.float32(1.5), "seg": np.float32(2.5)}
    tot_j, met_j = jloss.distill_losses(cfg_j, preds, targets, masks, {k: jnp.asarray(v) for k, v in scales.items()})
    tot_t, met_t = tloss.distill_losses(
        cfg_t, {k: [_t(x) for x in v] for k, v in preds.items()},
        {k: _t(v) for k, v in targets.items()}, {k: _t(v) for k, v in masks.items()},
        {k: torch.tensor(v) for k, v in scales.items()},
    )
    _close(tot_t, tot_j)
    assert sorted(met_t) == sorted(met_j)
    for k in met_j:
        _close(met_t[k], met_j[k])


@pytest.mark.parametrize("warmup_ratio,total", [(0.03, 1000), (0.0, 30), (0.1, 30), (0.5, 7)])
def test_schedule_matches_optax(warmup_ratio, total):
    """Including lr 0 on the first update, even with warmup_ratio 0."""
    cj = jopt.OptimizerConfig(learning_rate=1e-3, warmup_ratio=warmup_ratio, total_steps=total)
    ct = topt.OptimizerConfig(learning_rate=1e-3, warmup_ratio=warmup_ratio, total_steps=total)
    ref = jopt.cosine_schedule(cj, 1e-3)
    got = topt.cosine_schedule(ct, 1e-3)
    assert got(0) == 0.0
    for count in list(range(0, min(total, 40))) + [total - 1, total, total + 5]:
        np.testing.assert_allclose(got(count), float(ref(count)), rtol=1e-5, atol=1e-9)


def test_adamw_updates_match_optax():
    """Three updates on a small tree: clipping on (norm > 1) and off, weight
    decay on matrices only, a projector group with its own learning rate."""
    rng = np.random.default_rng(2)
    params = {
        "mm_projector": {"layers": [{"kernel": rng.standard_normal((4, 3)).astype(np.float32),
                                     "bias": rng.standard_normal((3,)).astype(np.float32)}]},
        "heads": {"gen": [{"resampler": {"norm_out": {"scale": np.ones((3,), np.float32)},
                                         "proj_in": {"kernel": rng.standard_normal((3, 5)).astype(np.float32)}}}]},
        "logit_scales": {"gen": np.float32(2.0)},
    }
    kw = dict(learning_rate=1e-2, mm_projector_lr=3e-2, weight_decay=0.1, warmup_ratio=0.2,
              total_steps=10, max_grad_norm=1.0, stage="pretrain")
    cj, ct = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    tx = jopt.make_optimizer(params, cj)
    state = tx.init(params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    names = {
        "mm_projector.layers.0.weight": ("mm_projector", "layers", 0, "kernel"),
        "mm_projector.layers.0.bias": ("mm_projector", "layers", 0, "bias"),
        "heads.gen.0.resampler.norm_out.scale": ("heads", "gen", 0, "resampler", "norm_out", "scale"),
        "heads.gen.0.resampler.proj_in.weight": ("heads", "gen", 0, "resampler", "proj_in", "kernel"),
        "logit_scales.gen": ("logit_scales", "gen"),
    }

    def get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def port_view(a, path):
        return np.ascontiguousarray(np.asarray(a).T) if path[-1] == "kernel" else np.asarray(a)

    tparams = {n: _t(port_view(get(params, p), p)).clone() for n, p in names.items()}
    opt = topt.AdamW(tparams.items(), ct)
    assert opt.group["mm_projector.layers.0.weight"] == "projector"
    assert opt.decay == {n: n.endswith("proj_in.weight") or n.endswith("layers.0.weight") for n in names}
    for step, gscale in enumerate((0.1, 3.0, 0.5)):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(gscale * rng.standard_normal(np.shape(x)).astype(np.float32)), params
        )
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        gnorm = opt.step({n: _t(port_view(get(grads, p), p)) for n, p in names.items()})
        _close(gnorm, optax.global_norm(grads))
        for n, p in names.items():
            _close(tparams[n], port_view(get(jp, p), p))


@pytest.mark.parametrize("stage", ["pretrain", "finetune", "probe"])
def test_trainable_mask_and_paths_match_jax(stage):
    """The stage policies over the port's parameter names give the JAX masks
    on the tiny VLM, leaf for leaf (JAX stacks blocks: one leaf per port
    block parameter)."""
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    params = jvlm.init_vlm(jax.random.PRNGKey(0), cfg_j)
    ref = {
        jopt._path_str(p): bool(v)
        for p, v in jax.tree_util.tree_flatten_with_path(jopt.trainable_mask(params, stage))[0]
    }
    model = tvlm.init_vlm(tconfig.tiny_test_vlm(distill=True), device="cpu")
    got = topt.trainable_mask(model.named_parameters(), stage)
    paths = {n: topt.jax_path(n) for n in got}
    assert set(paths.values()) == set(ref)
    for n, path in paths.items():
        assert got[n] == ref[path], (n, path)
