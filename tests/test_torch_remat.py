"""Rematerialisation in the port (models/decoder.py `REMAT_POLICIES`) vs its
own no-remat step and vs the JAX package's remat policies, on the CPU.

`tiny_test_vlm(distill=True)` in f32, PT stage (frozen decoder: gradients
pass through it to the projector and the task tokens), targets in the batch.
Tolerances: every exact policy against the port's no-remat loss and
gradients rtol 1e-6 (the same ops run again: the recompute reproduces the
forward); against JAX (`make_loss_fn(remat=True, remat_policy=...)`), loss
rtol 1e-5 and gradients atol 1e-4 x the tensor's largest |grad| + rtol 1e-3,
as tests/test_torch_train_step.py; save_mlp_q8's int8 values and scales
bit-equal to JAX's `_quant_saved`, its MLP bit-equal on the same input, and
the gradients that cross its backward held to a relative Frobenius error
(see test_policy_matches_jax).
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
from visper_lm_tpu.models import decoder as jdec
from visper_lm_tpu.models import vlm as jvlm
from visper_lm_tpu.train import optimizer as jopt
from visper_lm_tpu.train import train_step as jts

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.data.collate import collate_plans
from visper_lm_tpu_torch.models import decoder as tdec
from visper_lm_tpu_torch.ops import attention as tatt
from visper_lm_tpu_torch.ops import flash_attention as tflash
from visper_lm_tpu_torch.train import optimizer as topt
from visper_lm_tpu_torch.train import train_step as tts
from visper_lm_tpu_torch.utils.param import init_weights_
from visper_lm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

EXACT = ("none", "save_flash", "save_mlp", "save_qkv_mlp", "save_gate", "save_gate_flash")
AGAINST_JAX = ("none", "save_gate", "save_mlp_q8")


def _batch(cfg, bsz=2, seq=64):
    rng = np.random.default_rng(0)
    plans = []
    for b in range(bsz):
        ids = [5, 6, IMAGE_TOKEN_INDEX] + list(rng.integers(7, 400, size=9 + 3 * b))
        labels = [IGNORE_INDEX] * 3 + ids[3:]
        plans.append(build_splice_plan(
            ids, labels, seq, num_image_tokens=cfg.num_image_tokens,
            num_task_tokens=cfg.distill.num_task_tokens, num_tasks=len(cfg.distill.task_order()),
        ))
    img = rng.normal(size=(bsz, cfg.vision.image_size, cfg.vision.image_size, 3))
    batch = collate_plans(plans, images=img.astype(np.float32))
    for t in cfg.distill.tasks:
        batch[f"{t.task}_mask"] = np.ones((bsz,), np.float32)
        batch[f"{t.task}_target"] = rng.normal(
            size=(bsz, t.target_tokens, t.target_dim)).astype(np.float32)
    return batch


def _flat(tree):
    return {
        jopt._path_str(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _port_view(name, arr):
    return arr.T if topt.jax_path(name).endswith("/kernel") else arr


@pytest.fixture(scope="module")
def setup():
    """JAX's loss and trainable gradients under each AGAINST_JAX policy, the
    port's model on the same weights, and the batch."""
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    params = jvlm.init_vlm(jax.random.PRNGKey(0), cfg_j)
    batch = _batch(cfg_j)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    mask = jopt.trainable_mask(params, "pretrain")
    jax_runs = {}
    for policy in AGAINST_JAX:
        loss_fn = jts.make_loss_fn(cfg_j, remat=True, remat_policy=policy, use_pallas=False)
        (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, jbatch)
        flat_mask = _flat(mask)
        jax_runs[policy] = (float(loss), {k: v for k, v in _flat(grads).items() if flat_mask[k]})
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                            tconfig.tiny_test_vlm(distill=True), device="cpu")
    return dict(jax=jax_runs, model=model, batch=batch)


def _port_loss_and_grads(setup, remat, policy):
    cfg = tconfig.tiny_test_vlm(distill=True)
    step = tts.make_train_step(cfg, topt.OptimizerConfig(stage="pretrain"), setup["model"],
                               remat=remat, remat_policy=policy)
    metrics, grads = step.loss_and_grads(setup["batch"])
    return float(metrics["loss"]), grads


@pytest.fixture(scope="module")
def no_remat(setup):
    return _port_loss_and_grads(setup, False, None)


@pytest.mark.parametrize("policy", EXACT)
def test_exact_policy_gives_the_no_remat_loss_and_gradients(setup, no_remat, policy):
    loss, grads = _port_loss_and_grads(setup, True, policy)
    base_loss, base_grads = no_remat
    np.testing.assert_allclose(loss, base_loss, rtol=1e-6)
    assert any(float(g.abs().max()) > 0 for g in base_grads.values())
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), base_grads[name].numpy(), rtol=1e-6,
                                   atol=1e-7 * float(base_grads[name].abs().max()), err_msg=name)


# The trainables upstream of the decoder: their gradient crosses every
# block's backward, so under save_mlp_q8 it passes the int8 cast.
THROUGH_THE_DECODER = ("mm_projector.", "special_tokens.")
Q8_FROBENIUS = 1e-2


def _frobenius(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("policy", AGAINST_JAX)
def test_policy_matches_jax(setup, policy):
    """save_mlp_q8 included: the forward sees the dequantized bf16 gate/up,
    and, as in JAX, the int8 cast passes no gradient (only the scale's amax
    does). Its loss and the gradients of the heads and logit scales are held
    as the other policies'. The seven gradients that cross the q8 backward
    (THROUGH_THE_DECODER) are held to a relative Frobenius error of 1e-2
    (measured 0.9e-3 to 1.5e-3): the port rounds the backward's bf16
    cotangents where XLA on the CPU keeps them in f32.
    test_q8_limit_catches_a_straight_through_gradient shows the limit
    below what a gradient through the int8 cast reads on each of them."""
    loss, grads = _port_loss_and_grads(setup, True, policy)
    ref_loss, ref_grads = setup["jax"][policy]
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert len(grads) == len(ref_grads)
    for name, g in grads.items():
        ref = ref_grads[topt.jax_path(name)]
        got = _port_view(name, g.numpy())
        if policy == "save_mlp_q8" and name.startswith(THROUGH_THE_DECODER):
            assert _frobenius(got, ref) <= Q8_FROBENIUS, name
        else:
            np.testing.assert_allclose(got, ref, atol=1e-4 * float(np.abs(ref).max()) + 1e-12,
                                       rtol=1e-3, err_msg=f"{policy} {name}")


def test_q8_limit_catches_a_straight_through_gradient(setup, monkeypatch):
    """The fault the q8 limit is for: a gradient that passes the int8 cast
    (straight through the rounding) reads far above Q8_FROBENIUS against
    JAX on every gradient that crosses the decoder (measured 0.42 to 1.44)."""
    orig = tdec.quant_saved

    def straight_through(x):
        q, scale = orig(x)
        xs = x.float() / scale.detach()
        return xs + (q.float() - xs).detach(), scale

    monkeypatch.setattr(tdec, "quant_saved", straight_through)
    _, grads = _port_loss_and_grads(setup, True, "save_mlp_q8")
    ref_grads = setup["jax"]["save_mlp_q8"][1]
    through = [n for n in grads if n.startswith(THROUGH_THE_DECODER)]
    assert len(through) == 7
    for name in through:
        got = _port_view(name, grads[name].numpy())
        assert _frobenius(got, ref_grads[topt.jax_path(name)]) > 20 * Q8_FROBENIUS, name


def test_q8_mlp_is_bit_equal_to_jax_on_the_same_input(setup):
    """gate and up through `quant_saved` / `dequant_saved`, silu, gate x up:
    every bf16 value equal to the jitted JAX block's (`_quant_saved`,
    `_dequant_saved`, jax.nn.silu), from the same mlp-norm output."""
    from visper_lm_tpu.utils.param import linear

    params = jvlm.init_vlm(jax.random.PRNGKey(0), jconfig.tiny_test_vlm(distill=True))
    blk = jax.tree_util.tree_map(lambda a: a[1], params["decoder"]["blocks"])
    x = np.random.default_rng(4).standard_normal((2, 64, 64)).astype(np.float32)

    def mlp(xm):
        gp = jdec._dequant_saved(*jdec._quant_saved(linear(blk["gate_proj"], xm), "g"))
        up = jdec._dequant_saved(*jdec._quant_saved(linear(blk["up_proj"], xm), "u"))
        return jax.nn.silu(gp) * up

    ref = np.asarray(jax.jit(mlp)(jnp.asarray(x)).astype(jnp.float32))
    b1 = setup["model"].decoder.blocks[1]
    with torch.no_grad():
        xt = torch.from_numpy(x)
        gp = tdec.dequant_saved(*tdec.quant_saved(b1.gate_proj(xt)))
        up = tdec.dequant_saved(*tdec.quant_saved(b1.up_proj(xt)))
        got = (tdec.silu_per_op(gp) * up).float().numpy()
    np.testing.assert_array_equal(got, ref)


def test_q8_gradients_differ_from_the_exact_policies_in_both_packages(setup):
    """The fault recorded in ROADMAP C: JAX's save_mlp_q8 cuts the gradient
    through gate/up to the scale's amax; the port reproduces it."""
    for proj in ("mm_projector/layers/0/kernel", "special_tokens/gen"):
        exact, q8 = setup["jax"]["none"][1][proj], setup["jax"]["save_mlp_q8"][1][proj]
        rel = np.linalg.norm(q8 - exact) / np.linalg.norm(exact)
        assert rel > 5e-2, (proj, rel)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quant_saved_is_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 5, 96)) * rng.uniform(0.01, 30, size=(3, 5, 1))).astype(np.float32)
    x[1, 2] = 0.0                                  # amax 0: scale 1
    x[2, 0, :3] = [0.5, -0.5, 127.0 / 2]           # rounding ties
    xj = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    # jitted, as the train step runs it: XLA folds amax / 127 into a multiply
    qj, sj = jax.jit(lambda a: jdec._quant_saved(a, "t"))(xj)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)))
    xt = xt.to(torch.bfloat16) if dtype == "bfloat16" else xt
    qt, st = tdec.quant_saved(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    deq_j = np.asarray(jdec._dequant_saved(qj, sj).astype(jnp.float32))
    np.testing.assert_array_equal(tdec.dequant_saved(qt, st).float().numpy(), deq_j)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        tdec.remat_saves("save_everything")
    assert tdec.remat_saves(None) == frozenset()
    assert set(tdec.REMAT_POLICIES) == {
        "none", "save_flash", "save_mlp", "save_qkv_mlp", "save_gate", "save_gate_flash",
        "save_mlp_q8"}


# Flash-forward runs per layer and per step, and the block linears the
# backward's recompute runs, for a frozen decoder (the PT stage). On the card
# each flash forward is a launch of B1; chip_smoke.py checks the counts.
RECOMPUTE = {
    None: (1, ()),
    "none": (2, ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj")),
    "save_flash": (1, ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj")),
    "save_mlp": (2, ("q_proj", "k_proj", "v_proj", "o_proj")),
    "save_qkv_mlp": (2, ("o_proj",)),
    "save_gate": (2, ("q_proj", "k_proj", "v_proj", "o_proj", "up_proj")),
    "save_gate_flash": (1, ("q_proj", "k_proj", "v_proj", "o_proj", "up_proj")),
    "save_mlp_q8": (2, ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj")),
}


@pytest.mark.parametrize("policy", list(RECOMPUTE))
def test_what_the_recompute_runs(policy, monkeypatch):
    """Head dim 64 and T 128 take the flash path on the CPU when asked
    (use_kernel=True: the Function with its plain versions). down_proj is
    never run again: the recompute stops at its weight, the last tensor the
    backward needs; o_proj is, as in JAX: its output is the MLP norm's input."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = dataclasses.replace(tconfig.tiny_test_vlm(distill=True).decoder, head_dim=64, num_layers=2)
    dec = tdec.Decoder(cfg)
    init_weights_(dec, torch.Generator().manual_seed(0))
    dec.requires_grad_(False)
    fwd = []
    orig = tflash.flash_attention_fwd
    monkeypatch.setattr(tflash, "flash_attention_fwd", lambda *a, **k: fwd.append(1) or orig(*a, **k))
    plain = []
    orig_plain = tatt.mha_plain
    monkeypatch.setattr(tatt, "mha_plain", lambda *a, **k: plain.append(1) or orig_plain(*a, **k))
    weights = {m.weight.untyped_storage().data_ptr(): (n, m.weight.shape[0])
               for n, m in dec.blocks[0].named_children() if isinstance(m, torch.nn.Linear)}
    ran = []

    class Linears(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                for a in args:
                    hit = torch.is_tensor(a) and weights.get(a.untyped_storage().data_ptr())
                    if hit and out.shape[-1] == hit[1]:      # x @ W.T, not g @ W
                        ran.append(hit[0])
            return out

    x = torch.randn(2, 128, cfg.hidden_size, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    with Linears():
        out = dec(x, kv_lengths=torch.tensor([128, 101]), remat=policy is not None,
                  remat_policy=policy, use_kernel=True, compute_logits=False)
        forward_runs = list(ran)
        out["hidden"].square().mean().backward()
    per_layer, again = RECOMPUTE[policy]
    assert len(fwd) == per_layer * cfg.num_layers
    assert not plain
    assert sorted(forward_runs) == sorted(tdec.LINEAR_NAMES)
    assert sorted(ran[len(forward_runs):]) == sorted(again)
    assert float(x.grad.abs().max()) > 0


@pytest.mark.parametrize("policy", EXACT)
def test_trainable_decoder_weights_get_the_no_remat_gradients(policy):
    """With the decoder trainable (IFT), a kept linear's backward also gives
    dW, and rope's transpose carries q/k's gradient; the flash path
    (head dim 64, T 128, use_kernel=True) and the plain path (T 64)."""
    cfg = dataclasses.replace(tconfig.tiny_test_vlm(distill=True).decoder, head_dim=64, num_layers=2)
    dec = tdec.Decoder(cfg)
    init_weights_(dec, torch.Generator().manual_seed(0))
    for t, use_kernel in ((128, True), (64, None)):
        x0 = torch.randn(2, t, cfg.hidden_size, generator=torch.Generator().manual_seed(2))
        lens = torch.tensor([t, t - 9])
        res = []
        for remat in (False, True):
            x = x0.clone().requires_grad_(True)
            out = dec(x, kv_lengths=lens, remat=remat, remat_policy=policy, use_kernel=use_kernel,
                      tap_layers=(0,))
            loss = out["logits"].square().mean() + 1e-3 * out["taps"][0].sum()
            params = [p for n, p in dec.named_parameters() if n != "embed_tokens.weight"]
            res.append(torch.autograd.grad(loss, [x] + params))
        for a, b in zip(*res):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                       atol=1e-7 * float(a.abs().max()))
