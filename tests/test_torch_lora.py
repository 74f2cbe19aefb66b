"""LoRA in the port (models/lora.py, the side path in models/decoder.py) against
the JAX package's (models/lora.py, decoder `_lora_linear`), on
`tiny_test_vlm` with LoraConfig(r=4, alpha=8) and the JAX weights carried
over (`from_jax_params` carries params["lora"]), f32 on the CPU.

Tolerances: logits atol 1e-5 / rtol 1e-4 (as through the decoder in
tests/test_torch_models.py) against a float64 run of the port, 5e-5 against
JAX (whose f32 logits are 2.8e-5 from the float64 run here); gradients atol 1e-4 x the tensor's largest
|grad| + rtol 1e-3 with a random B, 1e-4 x the largest |grad| of a float64
run with the large delta; merged against runtime logits atol 2e-4 (JAX's
test_lora.py bound); merged weights rtol 1e-6. The remat policies (every one
keeping a LoRA-fed linear's output in a stash) hold the port's no-remat
loss and gradients in float64 within rtol 1e-10; save_qkv_mlp and
save_mlp_q8 also hold JAX's remat step (save_mlp_q8: the loss, rtol 1e-4).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.constants import IMAGE_TOKEN_INDEX
from visper_lm_tpu.data.collate import build_splice_plan, collate_plans
from visper_lm_tpu.models import lora as jlora
from visper_lm_tpu.models import vlm as jvlm
from visper_lm_tpu.train import optimizer as jopt

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.models import lora as tlora
from visper_lm_tpu_torch.models import vlm as tvlm
from visper_lm_tpu_torch.models.decoder import REMAT_POLICIES
from visper_lm_tpu_torch.train import optimizer as topt
from visper_lm_tpu_torch.utils.param import jax_path, split_layer
from visper_lm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

LORA = dict(r=4, alpha=8)


def _close_grad(got, ref, name):
    np.testing.assert_allclose(got, ref, atol=1e-4 * float(np.abs(ref).max()) + 1e-12, rtol=1e-3,
                               err_msg=name)


def _port_view(name, tree):
    """The JAX leaf of port parameter `name` (its layer of a stacked leaf),
    in the port's layout."""
    path = jax_path(name)
    ref = tree[path]
    layer = split_layer(name)[1]
    if layer is not None:
        ref = ref[layer]
    return ref.T if path.endswith("/kernel") else ref


def _flat(tree):
    return {jopt._path_str(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(jconfig.tiny_test_vlm(), lora=jconfig.LoraConfig(**LORA))
    cfg_t = dataclasses.replace(tconfig.tiny_test_vlm(), lora=tconfig.LoraConfig(**LORA))
    params = jvlm.init_vlm(jax.random.PRNGKey(0), cfg_j)
    # a nonzero B (and A moved too), so the side path carries a delta
    params["lora"] = jax.tree_util.tree_map(lambda x: x + 0.05, params["lora"])
    rng = np.random.default_rng(0)
    plans = [
        build_splice_plan([1, 2, IMAGE_TOKEN_INDEX] + list(rng.integers(3, 400, size=6 + 3 * b)),
                          None, 32, num_image_tokens=cfg_j.num_image_tokens)
        for b in range(2)
    ]
    batch = collate_plans(plans, images=rng.normal(size=(2, 28, 28, 3)).astype(np.float32))
    return cfg_j, cfg_t, params, batch


def _port(cfg_t, params):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_from_jax_params_carries_the_factors(setup):
    cfg_j, cfg_t, params, _ = setup
    model = _port(cfg_t, params)
    assert sorted(model.lora) == sorted(cfg_t.lora.targets)
    for name, ab in params["lora"].items():
        for k in ("a", "b"):
            got = getattr(model.lora[name], k)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ab[k]), err_msg=name)


def test_init_lora_distributions():
    cfg = tconfig.tiny_test_vlm()
    lcfg = tconfig.LoraConfig(r=16, alpha=4)
    lora = tlora.init_lora(cfg.decoder, lcfg, device="cpu", seed=3)
    again = tlora.init_lora(cfg.decoder, lcfg, device="cpu", seed=3)
    for name, f in lora.items():
        din, dout = tlora.kernel_dims(cfg.decoder, name)
        assert f.a.shape == (cfg.decoder.num_layers, din, 16) and f.b.shape == (4, 16, dout)
        assert f.a.dtype == f.b.dtype == torch.float32
        assert float(f.b.detach().abs().max()) == 0.0
        assert abs(float(f.a.detach().std()) - 16 ** -0.5) < 0.05 * 16 ** -0.5 * 4
        assert torch.equal(f.a, again[name].a)
    ref = jlora.init_lora(jax.random.PRNGKey(0), jconfig.tiny_test_vlm().decoder,
                          jconfig.LoraConfig(r=16, alpha=4))
    assert {k: {n: v.shape for n, v in ab.items()} for k, ab in ref.items()} == {
        k: {"a": tuple(f.a.shape), "b": tuple(f.b.shape)} for k, f in lora.items()}
    model = tvlm.init_vlm(dataclasses.replace(cfg, lora=lcfg), device="cpu", seed=1)
    assert float(model.lora["q_proj"].b.detach().abs().max()) == 0.0


def test_zero_delta_is_the_base_model(setup):
    cfg_j, cfg_t, params, batch = setup
    p0 = dict(params)
    p0["lora"] = jax.tree_util.tree_map(
        lambda x: x, jlora.init_lora(jax.random.PRNGKey(1), cfg_j.decoder, cfg_j.lora))
    with_lora = _port(cfg_t, p0)
    base = from_jax_params(jax.tree_util.tree_map(np.asarray, {k: v for k, v in params.items()
                                                               if k != "lora"}),
                           dataclasses.replace(cfg_t, lora=None), device="cpu")
    with torch.no_grad():
        a = tvlm.vlm_forward(with_lora, cfg_t, _tbatch(batch))["logits"]
        b = tvlm.vlm_forward(base, base.cfg, _tbatch(batch))["logits"]
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_forward_with_a_nonzero_delta_matches_jax(setup):
    cfg_j, cfg_t, params, batch = setup
    model = _port(cfg_t, params)
    with torch.no_grad():
        got = tvlm.vlm_forward(model, cfg_t, _tbatch(batch))["logits"].numpy()
    ref = np.asarray(jax.jit(lambda p, b: jvlm.vlm_forward(p, cfg_j, b, use_pallas=False)["logits"])(
        params, {k: jnp.asarray(v) for k, v in batch.items()}))
    # +0.05 on every factor makes a large delta: JAX's own f32 logits are then
    # 2.8e-5 from a float64 run of the same weights (the port's 6e-6), so the
    # port is held to the float64 run at 1e-5 and to JAX at 5e-5
    m64 = _port(cfg_t, params).double()
    with torch.no_grad():
        ref64 = tvlm.vlm_forward(m64, cfg_t, {k: v.double() if v.is_floating_point() else v
                                              for k, v in _tbatch(batch).items()})["logits"]
    np.testing.assert_allclose(got, ref64.numpy(), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)
    base = {k: v for k, v in params.items() if k != "lora"}
    ref0 = np.asarray(jvlm.vlm_forward(base, dataclasses.replace(cfg_j, lora=None),
                                       {k: jnp.asarray(v) for k, v in batch.items()},
                                       use_pallas=False)["logits"])
    assert np.abs(got - ref0).max() > 1e-3                     # the delta is visible


def _jax_grads(cfg_j, params, batch, remat=False, policy=None):
    def loss(lora, rest, jb):
        out = jvlm.vlm_forward({**rest, "lora": lora}, cfg_j, jb, use_pallas=False,
                               remat=remat, remat_policy=policy)
        return jnp.sum(out["logits"].astype(jnp.float32) ** 2)

    rest = {k: v for k, v in params.items() if k != "lora"}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    val, (g_lora, g_rest) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(params["lora"], rest, jb)
    return float(val), _flat({"lora": g_lora, **g_rest})


def _port_grads(model, cfg_t, batch, names, remat=False, policy=None):
    params = [dict(model.named_parameters())[n] for n in names]
    for p in model.parameters():
        p.requires_grad_(False)
    for p in params:
        p.requires_grad_(True)
    out = tvlm.vlm_forward(model, cfg_t, _tbatch(batch), remat=remat, remat_policy=policy)
    loss = out["logits"].float().square().sum()
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), {n: g.numpy() for n, g in zip(names, grads)}


def _names(model):
    """The adapters, and one layer's base weights through every stashed kind."""
    return [n for n, _ in model.named_parameters()
            if n.startswith("lora.") or n.startswith("decoder.blocks.1.")
            or n.startswith("mm_projector.")]


def _random_b(params):
    """B drawn N(0, 0.05^2) as a trained adapter's, A as initialised."""
    rng = np.random.default_rng(3)
    return {**params, "lora": {
        k: {"a": ab["a"] - 0.05, "b": jnp.asarray(rng.normal(0, 0.05, ab["b"].shape).astype(np.float32))}
        for k, ab in params["lora"].items()}}


@pytest.mark.parametrize("policy", [None, "save_qkv_mlp", "save_mlp_q8"])
def test_grads_match_jax(setup, policy):
    """dA, dB, the base weights of one layer (trainable: the stashed linears'
    dW beside the LoRA factors) and the projector; with a remat policy on
    both sides. B is drawn at random here: with the fixture's +0.05 on every
    factor JAX's own f32 gradients are 2.9e-4 of their largest value from a
    float64 run (the port's 4.7e-5; test_grads_with_a_large_delta)."""
    cfg_j, cfg_t, params, batch = setup
    params = _random_b(params)
    model = _port(cfg_t, params)
    names = _names(model)
    remat = policy is not None
    val_t, got = _port_grads(model, cfg_t, batch, names, remat=remat, policy=policy)
    val_j, ref = _jax_grads(cfg_j, params, batch, remat=remat, policy=policy)
    np.testing.assert_allclose(val_t, val_j, rtol=1e-4 if policy == "save_mlp_q8" else 1e-5)
    if policy == "save_mlp_q8":
        # its int8 rounding is discontinuous: the loss holds to 1e-4 (tests/test_torch_remat.py)
        return
    for n, g in got.items():
        _close_grad(g, _port_view(n, ref), n)
    assert float(np.abs(got["lora.q_proj.a"]).max()) > 0 and float(np.abs(got["lora.down_proj.b"]).max()) > 0


def test_grads_with_a_large_delta_match_float64(setup):
    """The fixture's +0.05 delta: the port's f32 gradients within 1e-4 of
    their largest value of a float64 run of the port."""
    _, cfg_t, params, batch = setup
    model = _port(cfg_t, params)
    names = _names(model)
    _, got = _port_grads(model, cfg_t, batch, names)
    b64 = {k: np.asarray(v, np.float64) if np.asarray(v).dtype == np.float32 else v
           for k, v in batch.items()}
    _, ref = _port_grads(_port(cfg_t, params).double(), cfg_t, b64, names)
    for n in names:
        np.testing.assert_allclose(got[n], ref[n], rtol=0, atol=1e-4 * float(np.abs(ref[n]).max()),
                                   err_msg=n)


@pytest.mark.parametrize("policy", sorted(p for p in REMAT_POLICIES if p != "save_mlp_q8"))
def test_remat_policies_keep_the_lora_term(setup, policy):
    """Every exact policy against the port's no-remat step, in float64 (the
    large delta leaves f32 gradients 5e-5 of their largest value from the
    float64 ones whatever the policy; in float64 the policies agree to the
    last bits): the stashed q/k/v and gate/up values include the side path,
    and dA / dB still flow, rtol 1e-10."""
    _, cfg_t, params, batch = setup
    model = _port(cfg_t, params).double()
    b64 = {k: np.asarray(v, np.float64) if np.asarray(v).dtype == np.float32 else v
           for k, v in batch.items()}
    names = _names(model)
    ref_loss, ref = _port_grads(model, cfg_t, b64, names)
    loss, got = _port_grads(model, cfg_t, b64, names, remat=True, policy=policy)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-12)
    for n in names:
        np.testing.assert_allclose(got[n], ref[n], rtol=1e-10,
                                   atol=1e-12 * float(np.abs(ref[n]).max()), err_msg=n)
        assert float(np.abs(got[n]).max()) > 0, n


def test_merge_equals_jax_and_the_runtime_side_path(setup):
    cfg_j, cfg_t, params, batch = setup
    model = _port(cfg_t, params)
    with torch.no_grad():
        runtime = tvlm.vlm_forward(model, cfg_t, _tbatch(batch))["logits"].numpy()
    merged_j = jlora.merge_lora_into_decoder(params["decoder"], params["lora"], cfg_j.lora)
    tlora.apply_lora(model)
    assert model.lora is None
    for i, block in enumerate(model.decoder.blocks):
        for name in cfg_t.lora.targets:
            np.testing.assert_allclose(getattr(block, name).weight.detach().numpy(),
                                       np.asarray(merged_j["blocks"][name]["kernel"][i]).T,
                                       rtol=1e-6, atol=1e-7, err_msg=f"{i}.{name}")
    with torch.no_grad():
        baked = tvlm.vlm_forward(model, dataclasses.replace(cfg_t, lora=None), _tbatch(batch))["logits"]
    np.testing.assert_allclose(baked.numpy(), runtime, atol=2e-4)


def test_lora_stage_trains_the_adapters_and_the_projector(setup):
    cfg_j, cfg_t, params, _ = setup
    model = _port(cfg_t, params)
    mask = topt.trainable_mask(model.named_parameters(), "lora")
    jmask = _flat(jopt.trainable_mask(params, "lora"))
    for n, on in mask.items():
        assert on == (n.startswith("lora.") or n.startswith("mm_projector.")), n
        assert on == bool(jmask[jax_path(n)]), n
    assert sum(mask.values()) == 2 * len(cfg_t.lora.targets) + 4


def test_c13_jax_apply_lora_keeps_the_factors(setup):
    """C13 (ROADMAP §C, a limit of the reference): JAX's `apply_lora` folds the
    adapters into the decoder but leaves params["lora"] in the tree, so a
    `vlm_forward` with cfg.lora adds the side path a second time on the
    merged weights. The port's `apply_lora` drops the factors: its forward
    equals JAX's merged decoder without them (atol 2e-4, JAX's bound)."""
    cfg_j, cfg_t, params, batch = setup
    applied = jlora.apply_lora(params, cfg_j.lora)
    assert "lora" in applied
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    twice = np.asarray(jvlm.vlm_forward(applied, cfg_j, jb, use_pallas=False)["logits"])
    once = np.asarray(jvlm.vlm_forward({k: v for k, v in applied.items() if k != "lora"},
                                       dataclasses.replace(cfg_j, lora=None), jb,
                                       use_pallas=False)["logits"])
    assert np.abs(twice - once).max() > 1e-2
    model = tlora.apply_lora(_port(cfg_t, params))
    with torch.no_grad():
        got = tvlm.vlm_forward(model, cfg_t, _tbatch(batch))["logits"].numpy()
    np.testing.assert_allclose(got, once, atol=2e-4)
