"""Every training stage of the port against the JAX package's `make_train_step`
on the CPU, f32, with the JAX weights carried over: finetune and vpt (all but
the tower train), vision_tower (tower + projector), lora (adapters +
projector, LoraConfig(r=4, alpha=8)), probe (one tiny head per decoder layer,
targets in the batch) and full (pretrain_full: the PT losses with everything
trainable). For the first time the decoder's weights train: its flash
backward (the plain version here) carries weight gradients, through the
stashed linears under the remat policies.

Two updates each (update 1 has lr 0: optax's warmup starts at 0). Tolerances
(test_torch_train_step.py's): every metric of both steps rtol 1e-5; the
trainables after the second update atol 2e-5 / rtol 1e-4 wherever the
step's gradient is above 1e-5 of its tensor's largest (below it Adam's
g / |g| follows f32 rounding: there, and for under 1 % of the elements, the
bound is one update, lr x 1.01); frozen parameters bit-equal to their values
before the steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from visper_lm_tpu.data.collate import build_splice_plan
from visper_lm_tpu.models import vlm as jvlm
from visper_lm_tpu.parallel.mesh import make_mesh
from visper_lm_tpu.train import optimizer as jopt
from visper_lm_tpu.train import train_step as jts

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.data.collate import collate_plans
from visper_lm_tpu_torch.train import optimizer as topt
from visper_lm_tpu_torch.train import train_step as tts
from visper_lm_tpu_torch.utils.param import jax_path, split_layer
from visper_lm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

STEPS = 2
OPT = dict(learning_rate=3e-3, total_steps=30, warmup_ratio=0.1)
TINY_HEAD = dict(num_tokens=4, output_dim=24, dim_head=8, num_heads=2)


def _cfg(C, stage):
    """The tiny config of a stage, built the same way from either package."""
    if stage in ("full",):
        return C.tiny_test_vlm(distill=True)
    cfg = C.tiny_test_vlm(distill=False)
    if stage == "lora":
        return dataclasses.replace(cfg, lora=C.LoraConfig(r=4, alpha=8))
    if stage == "probe":
        d = C.probe_distill_config("depth", cfg.decoder.num_layers)
        task = dataclasses.replace(d.tasks[0], head=C.ResamplerConfig(**TINY_HEAD),
                                   target_dim=24, target_tokens=4)
        return dataclasses.replace(cfg, distill=dataclasses.replace(d, tasks=(task,)))
    return cfg


def _batch(cfg, bsz=2, seq=48):
    rng = np.random.default_rng(0)
    d = cfg.distill
    plans = []
    for b in range(bsz):
        ids = [1, 2, 3, IMAGE_TOKEN_INDEX] + list(rng.integers(3, 400, size=8 + 3 * b))
        plans.append(build_splice_plan(
            ids, [IGNORE_INDEX] * 4 + ids[4:], seq, num_image_tokens=cfg.num_image_tokens,
            num_task_tokens=d.num_task_tokens if d else 0,
            num_tasks=len(d.task_order()) if d and d.num_task_tokens else 0))
    batch = collate_plans(plans, images=rng.normal(size=(bsz, 28, 28, 3)).astype(np.float32))
    if d is not None:
        for t in d.tasks:
            batch[f"{t.task}_mask"] = np.ones((bsz,), np.float32)
            batch[f"{t.task}_target"] = rng.normal(
                size=(bsz, t.target_tokens, t.target_dim)).astype(np.float32)
    return batch


def _flat(tree):
    return {jopt._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0] if v is not None}


def _jax_view(name, flat):
    path = jax_path(name)
    ref = flat[path]
    layer = split_layer(name)[1]
    if layer is not None:
        ref = ref[layer]
    return ref.T if path.endswith("/kernel") else ref


CASES = [("finetune", None), ("finetune", "save_qkv_mlp"), ("vpt", "save_gate"),
         ("vision_tower", None), ("lora", None), ("lora", "save_qkv_mlp"), ("probe", None),
         ("full", "save_mlp")]


@pytest.mark.parametrize("stage,policy", CASES)
def test_stage_step_matches_jax(stage, policy):
    cfg_j, cfg_t = _cfg(jconfig, stage), _cfg(tconfig, stage)
    params = jvlm.init_vlm(jax.random.PRNGKey(0), cfg_j)
    if stage == "lora":
        rng = np.random.default_rng(1)       # a B that is not zero: the side path is live
        params["lora"] = {k: {"a": ab["a"], "b": jnp.asarray(
            rng.normal(0, 0.05, ab["b"].shape).astype(np.float32))} for k, ab in params["lora"].items()}
    batch = _batch(cfg_j)
    opt = dict(OPT, stage=stage)

    mesh = make_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    metrics_j = []
    with mesh:
        step_j, state, _ = jts.make_train_step(cfg_j, jopt.OptimizerConfig(**opt), params, mesh,
                                               use_pallas=False, remat_policy=policy)
        dbatch = jts.shard_batch(batch, mesh)
        for _ in range(STEPS):
            state, m = step_j(state, dbatch)
            metrics_j.append({k: float(v) for k, v in m.items()})
    params_j = _flat(state.params)

    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    step = tts.make_train_step(cfg_t, topt.OptimizerConfig(**opt), model, remat_policy=policy)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n not in step.trainable}
    _, grads = step.loss_and_grads(batch)
    metrics_t = [step(batch) for _ in range(STEPS)]

    mask = topt.trainable_mask(model.named_parameters(), stage)
    assert set(step.trainable) == {n for n, on in mask.items() if on}
    expect = {"finetune": "decoder.", "vpt": "decoder.", "vision_tower": "vision_tower.",
              "lora": "lora.", "probe": "heads.", "full": "vision_tower."}[stage]
    assert any(n.startswith(expect) for n in step.trainable)
    if stage in ("vision_tower", "lora", "probe"):
        assert not any(n.startswith("decoder.") for n in step.trainable)
    for m_t, m_j in zip(metrics_t, metrics_j):
        assert sorted(m_t) == sorted(m_j)
        for k in m_j:
            np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert metrics_t[0]["loss"] == metrics_t[1]["loss"]            # update 1: lr 0
    # Adam divides by |g|: where a gradient is at the level of f32 rounding
    # (below 1e-5 of its tensor's largest) the update's size follows that
    # rounding, so there only the bound of one update holds (lr x 1.01)
    lr2 = OPT["learning_rate"] / max(int(OPT["warmup_ratio"] * OPT["total_steps"]), 1)
    n_noise = 0
    for name, p in step.trainable.items():
        got, ref, g = p.detach().numpy(), _jax_view(name, params_j), grads[name].abs().numpy()
        sure = (g == 0) | (g > 1e-5 * g.max())
        n_noise += int((~sure).sum())
        np.testing.assert_allclose(got[sure], ref[sure], atol=2e-5, rtol=1e-4, err_msg=name)
        assert np.abs(got - ref).max() <= 1.01 * lr2 + 2e-5, name
    assert n_noise < 0.01 * sum(p.numel() for p in step.trainable.values())
    start = _flat(params)
    moved = [n for n, p in step.trainable.items()
             if not np.array_equal(p.detach().numpy(), _jax_view(n, start))]
    assert any(n.startswith(expect) for n in moved), stage
    for n, before in frozen.items():
        after = dict(model.named_parameters())[n]
        assert not after.requires_grad and torch.equal(before, after.detach()), n
