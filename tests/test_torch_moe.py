"""The port's mixture-of-experts layer (visper_lm_tpu_torch/ops/moe.py) and
MoE decoder against the JAX package's, on the CPU in f32.

Every case of tests/test_moe.py that runs in one process becomes a parity
case: the same JAX-initialised weights and inputs through JAX's `moe_mlp` /
`decoder_forward` and the port's. Tolerances: outputs and aux losses rtol
2e-5 / atol 2e-6 (the expert products summed in another order); gradients
atol 1e-5 x the tensor's largest |grad| + rtol 1e-4; integer results (which
routes are dropped, which rows are exactly zero, dropped_frac) exactly.
Also: ties go to the lowest expert index as `jax.lax.top_k` breaks them;
the quantized trees (int8 attention projections bit-equal to JAX's, the
banks and the router untouched); the f32 router in a bf16 model; a MoE VLM
through JAX's `make_train_step` (loss, MoE metrics and the update); and the
limits (sequence parallelism without the routing group, the streamed
layout) beside the plain loop a pipeline runs.
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
from visper_lm_tpu.ops import moe as jmoe
from visper_lm_tpu.parallel.mesh import make_mesh
from visper_lm_tpu.train import optimizer as jopt
from visper_lm_tpu.train import train_step as jts
from visper_lm_tpu.utils import param as jparam

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.data.collate import collate_plans
from visper_lm_tpu_torch.models import decoder as tdec
from visper_lm_tpu_torch.models import vlm as tvlm
from visper_lm_tpu_torch.ops import moe as tmoe
from visper_lm_tpu_torch.train import optimizer as topt
from visper_lm_tpu_torch.train import train_step as tts
from visper_lm_tpu_torch.utils.param import jax_flat_arrays, widen_bf16
from visper_lm_tpu_torch.weights import decoder_from_jax_params, from_jax_params

torch.set_num_threads(2)

OPT = dict(learning_rate=3e-3, total_steps=30, warmup_ratio=0.1, stage="finetune")
STEPS = 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(params):
    return {k: _t(v) for k, v in params.items()}


def _close(got, want, rtol=2e-5, atol=2e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _grad_close(got, want, msg=""):
    want = np.asarray(want, np.float64)
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-4, atol=atol,
                               err_msg=msg)


def _both(params, x, **kw):
    """JAX's jitted moe_mlp and the port's on the same weights and input."""
    out_j, aux_j = jax.jit(lambda p, xx: jmoe.moe_mlp(p, xx, **kw))(params, x)
    out_t, aux_t = tmoe.moe_mlp(_tree(params), _t(x), **kw)
    return (np.asarray(out_j), {k: float(v) for k, v in aux_j.items()},
            out_t.numpy(), {k: float(v) for k, v in aux_t.items()})


def _check_aux(aux_t, aux_j):
    for k in aux_j:
        _close(aux_t[k], aux_j[k], msg=k)


def test_single_expert_equals_dense_mlp_as_jax():
    params = jmoe.init_moe_mlp(jax.random.PRNGKey(0), 32, 64, 1, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 16, 32), jnp.float32)
    out_j, aux_j, out_t, aux_t = _both(params, x, top_k=1, capacity_factor=2.0)
    _close(out_t, out_j)
    _check_aux(aux_t, aux_j)
    assert aux_t["dropped_frac"] == 0.0 and aux_t["lb_loss"] == pytest.approx(1.0)


def test_topk_all_experts_ample_capacity_as_jax():
    params = jmoe.init_moe_mlp(jax.random.PRNGKey(2), 16, 32, 4, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(3), (2, 8, 16), jnp.float32)
    out_j, aux_j, out_t, aux_t = _both(params, x, top_k=4, capacity_factor=5.0)
    _close(out_t, out_j)
    _check_aux(aux_t, aux_j)


def test_capacity_overflow_drops_the_same_tokens():
    """A capacity of ~1 slot per expert: the same routes dropped (the same
    rows exactly zero, the same dropped_frac) and the kept rows' outputs."""
    params = jmoe.init_moe_mlp(jax.random.PRNGKey(4), 16, 32, 2, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(5), (1, 32, 16), jnp.float32)
    out_j, aux_j, out_t, aux_t = _both(params, x, top_k=1, capacity_factor=0.1)
    assert aux_t["dropped_frac"] == aux_j["dropped_frac"] > 0.5
    zero_j, zero_t = np.all(out_j == 0.0, -1), np.all(out_t == 0.0, -1)
    assert zero_t.sum() > 0 and np.array_equal(zero_t, zero_j)
    _close(out_t, out_j)
    _check_aux(aux_t, aux_j)
    # top-2 with overflow: priority is token-major over the (N K) routes
    params = jmoe.init_moe_mlp(jax.random.PRNGKey(6), 16, 32, 4, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(7), (2, 24, 16), jnp.float32)
    out_j, aux_j, out_t, aux_t = _both(params, x, top_k=2, capacity_factor=0.5)
    assert 0 < aux_t["dropped_frac"] == aux_j["dropped_frac"]
    assert np.array_equal(np.all(out_t == 0.0, -1), np.all(out_j == 0.0, -1))
    _close(out_t, out_j)
    _check_aux(aux_t, aux_j)


def test_gradients_match_jax_grad():
    """d(mean(out^2) + 0.01 lb) / d(router, gate, up, down) and d/dx against
    jax.grad, with and without dropped routes."""
    params = jmoe.init_moe_mlp(jax.random.PRNGKey(8), 16, 32, 4, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(9), (2, 16, 16), jnp.float32)
    for cf in (2.0, 0.5):
        def loss_j(p, xx):
            out, aux = jmoe.moe_mlp(p, xx, top_k=2, capacity_factor=cf)
            return jnp.mean(jnp.square(out)) + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]

        gp_j, gx_j = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(params, x)
        p_t = {k: v.requires_grad_(True) for k, v in _tree(params).items()}
        x_t = _t(x).requires_grad_(True)
        out, aux = tmoe.moe_mlp(p_t, x_t, top_k=2, capacity_factor=cf)
        (out.square().mean() + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]).backward()
        for name in ("router", "gate", "up", "down"):
            g = p_t[name].grad.numpy()
            assert np.all(np.isfinite(g)) and np.any(g != 0), name
            _grad_close(g, gp_j[name], msg=f"cf {cf} {name}")
        _grad_close(x_t.grad.numpy(), gx_j, msg=f"cf {cf} x")


def test_uniform_router_ties_go_to_the_lowest_expert():
    """A zero router: every probability 1/E, all ties. JAX's top_k takes the
    lowest indices, so does the port (a stable sort): the same outputs, and
    the Switch loss at its minimum 1 with ample capacity."""
    params = jmoe.init_moe_mlp(jax.random.PRNGKey(8), 16, 32, 4, dtype=jnp.float32)
    params = dict(params, router=jnp.zeros_like(params["router"]))
    x = jax.random.normal(jax.random.PRNGKey(9), (2, 16, 16), jnp.float32)
    for k, cf in ((1, 4.0), (2, 4.0), (2, 1.0)):
        out_j, aux_j, out_t, aux_t = _both(params, x, top_k=k, capacity_factor=cf)
        _close(out_t, out_j)
        _check_aux(aux_t, aux_j)
    _, idx = tmoe.route(torch.full((3, 4), 0.25), 2)
    assert idx.tolist() == [[0, 1]] * 3
    _, aux_j, _, aux_t = _both(params, x, top_k=1, capacity_factor=4.0)
    assert aux_t["lb_loss"] == pytest.approx(1.0, abs=0.15)
    assert aux_t["lb_loss"] == aux_j["lb_loss"]


def test_bf16_rounding_points_follow_jax():
    """In bf16 the port rounds where JAX does (rows dispatched in bf16,
    products in f32, silu(g) u to bf16, one rounding after the f32 combine):
    within a bf16 ulp of JAX's output on the CPU."""
    params = jmoe.init_moe_mlp(jax.random.PRNGKey(10), 32, 64, 4, dtype=jnp.bfloat16)
    x = jax.random.normal(jax.random.PRNGKey(11), (2, 8, 32), jnp.float32).astype(jnp.bfloat16)
    out_j, aux_j = jax.jit(lambda p, xx: jmoe.moe_mlp(p, xx, top_k=2, capacity_factor=1.25))(
        params, x)
    p_t = {k: torch.from_numpy(widen_bf16(np.asarray(v).view("V2")) if v.dtype == jnp.bfloat16
                               else np.array(v)).to(torch.bfloat16 if v.dtype == jnp.bfloat16
                                                    else torch.float32)
           for k, v in params.items()}
    x_t = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    out_t, aux_t = tmoe.moe_mlp(p_t, x_t, top_k=2, capacity_factor=1.25)
    assert out_t.dtype == torch.bfloat16 and p_t["router"].dtype == torch.float32
    want = np.asarray(out_j.astype(jnp.float32))
    np.testing.assert_allclose(out_t.float().numpy(), want, rtol=1e-2,
                               atol=1e-2 * np.abs(want).max())
    _check_aux({k: float(v) for k, v in aux_t.items()}, {k: float(v) for k, v in aux_j.items()})


# ---------------------------------------------------------------------------
# the MoE decoder
# ---------------------------------------------------------------------------


def _cfgs(**kw):
    j = jconfig.DecoderConfig(
        vocab_size=128, hidden_size=32, num_layers=4, num_heads=4, num_kv_heads=2, head_dim=8,
        mlp_dim=64, dtype="float32", max_seq_len=64, moe_experts=4, moe_top_k=2,
        moe_capacity_factor=4.0, **kw)
    return j, tconfig.DecoderConfig(**dataclasses.asdict(j))


def _decoder(seed, **kw):
    cfg_j, cfg_t = _cfgs(**kw)
    params = jdec.init_decoder(jax.random.PRNGKey(seed), cfg_j)
    dec = decoder_from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    return cfg_j, cfg_t, params, dec


def test_moe_decoder_forward_taps_and_aux_match_jax():
    cfg_j, cfg_t, params, dec = _decoder(0)
    assert "moe_router" in params["blocks"] and not hasattr(dec.blocks[0], "gate_proj")
    assert dec.blocks[0].moe_router.weight.dtype == torch.float32
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 10, cfg_j.hidden_size))
    for cf in (4.0, 0.5):                       # ample, and with drops in every layer
        cj, ct = (dataclasses.replace(c, moe_capacity_factor=cf) for c in (cfg_j, cfg_t))
        dec.cfg = ct
        for block in dec.blocks:
            block.cfg = ct
        for taps in ((), (1, 3)):
            want = jdec.decoder_forward(params, cj, x, tap_layers=taps)
            with torch.no_grad():
                got = dec(_t(x), tap_layers=taps, use_kernel=False)
            _close(got["logits"], want["logits"], rtol=2e-5, atol=2e-5)
            for k in ("lb_loss", "z_loss", "dropped_frac"):
                _close(got["moe_aux"][k], want["moe_aux"][k], rtol=1e-5, atol=1e-6, msg=k)
            for a, b in zip(got["taps"], want["taps"] or ()):
                _close(a, b, rtol=2e-5, atol=2e-5)
        if cf == 0.5:
            assert float(got["moe_aux"]["dropped_frac"]) > 0


def test_moe_decoder_cached_decode_matches_jax_stepped_decode():
    cfg_j, cfg_t, params, dec = _decoder(2)
    b, t = 2, 8
    x = jax.random.normal(jax.random.PRNGKey(3), (b, t, cfg_j.hidden_size))
    cache_j = jdec.init_kv_cache(cfg_j, b, t, dtype=jnp.float32)
    cache_t = tdec.init_kv_cache(cfg_t, b, t, dtype=torch.float32, device="cpu")
    full = jdec.decoder_forward(params, cfg_j, x)["logits"]
    for i in range(t):
        out_j = jdec.decoder_forward(params, cfg_j, x[:, i:i + 1], cache=cache_j, q_offset=i,
                                     kv_lengths=jnp.full((b,), i + 1, jnp.int32))
        cache_j = out_j["cache"]
        with torch.no_grad():
            out_t = dec(_t(x[:, i:i + 1]), cache=cache_t, q_offset=i,
                        kv_lengths=torch.full((b,), i + 1, dtype=torch.int32), use_kernel=False)
        _close(out_t["logits"], out_j["logits"], rtol=2e-5, atol=2e-5, msg=f"step {i}")
        _close(out_t["logits"][:, 0], np.asarray(full)[:, i], rtol=2e-4, atol=2e-4)
        # the cache path returns the aux too (JAX drops it there)
        assert out_j["moe_aux"] is None and float(out_t["moe_aux"]["dropped_frac"]) == 0.0
    _close(cache_t.k, np.asarray(cache_j.k), rtol=1e-5, atol=1e-6)


def test_moe_train_loss_gradients_match_jax():
    """JAX's test loss with a fixed random readout of the hidden state (the
    mean of its squares is ~1 after the final norm whatever the weights, so
    its gradients are cancellation noise) + moe_aux_weight lb + 1e-3 z
    through the whole decoder: the router's and the banks' gradients (all
    four nonzero) against jax.grad, with remat and without."""
    cfg_j, cfg_t, params, dec = _decoder(4)
    x = jax.random.normal(jax.random.PRNGKey(5), (2, 6, cfg_j.hidden_size))
    r = jax.random.normal(jax.random.PRNGKey(6), (2, 6, cfg_j.hidden_size))

    def loss_j(p):
        out = jdec.decoder_forward(p, cfg_j, x)
        aux = out["moe_aux"]
        return (jnp.mean(out["hidden"] * r) + cfg_j.moe_aux_weight * aux["lb_loss"]
                + 1e-3 * aux["z_loss"])

    want = jax_flat = jax.jit(jax.grad(loss_j))(params)
    want = {f"decoder/blocks/{n}/kernel": np.asarray(jax_flat["blocks"][n]["kernel"])
            for n in tdec.MOE_NAMES}
    want["decoder/blocks/q_proj/kernel"] = np.asarray(jax_flat["blocks"]["q_proj"]["kernel"])
    for remat in (False, True):
        dec.zero_grad(set_to_none=True)
        out = dec(_t(x), use_kernel=False, compute_logits=False, remat=remat,
                  remat_policy="save_gate" if remat else None)
        aux = out["moe_aux"]
        ((out["hidden"] * _t(r)).mean() + cfg_t.moe_aux_weight * aux["lb_loss"]
         + 1e-3 * aux["z_loss"]).backward()
        got = jax_flat_arrays({"decoder." + n: p.grad for n, p in dec.named_parameters()})
        for path, w in want.items():
            assert np.any(got[path] != 0), path
            _grad_close(got[path], w, msg=f"remat {remat} {path}")


def test_moe_banks_stay_dense_under_serving_quantization():
    """int8 / int4: the attention projections and the head quantized as JAX
    quantizes them (int8 arrays bit-equal), the router and the banks left
    dense (the same tensors), and the quantized decoder runs."""
    cfg_j, cfg_t, params, dec = _decoder(10)
    x = jax.random.normal(jax.random.PRNGKey(11), (1, 6, cfg_j.hidden_size))
    ref = jdec.decoder_forward(params, cfg_j, x)["logits"]
    q8_j = jax.jit(jparam.quantize_linear_weights)(params)
    q8 = tdec.quantize_decoder(dec, "int8")
    for i, block in enumerate(q8.blocks):
        for name in tdec.MOE_NAMES:
            assert getattr(block, name) is getattr(dec.blocks[i], name), name
            assert "kernel" in q8_j["blocks"][name]
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            np.testing.assert_array_equal(getattr(block, name).weight_q8.numpy(),
                                          np.asarray(q8_j["blocks"][name]["kernel_q8"][i]))
    with torch.no_grad():
        got = q8(_t(x), use_kernel=False)["logits"].numpy()
    want = np.asarray(jdec.decoder_forward(q8_j, cfg_j, x)["logits"])
    _close(got, want, rtol=2e-5, atol=2e-5)
    assert np.corrcoef(got.ravel(), np.asarray(ref).ravel())[0, 1] > 0.99
    q4_j = jax.jit(jparam.quantize_linear_weights_int4)(params)
    q4 = tdec.quantize_decoder(dec, "int4")
    for name in tdec.MOE_NAMES:
        assert "kernel_q4p" not in q4_j["blocks"][name]
        assert getattr(q4.blocks[0], name) is getattr(dec.blocks[0], name)
    np.testing.assert_array_equal(q4.blocks[1].q_proj.weight_q4p.numpy(),
                                  np.asarray(q4_j["blocks"]["q_proj"]["kernel_q4p"][1]))
    with torch.no_grad():
        assert torch.isfinite(q4(_t(x), use_kernel=False)["logits"]).all()


class _Stage:
    """A pipeline stage of two whose foreign blocks are already whole: it
    counts the plain loop's gathers around each block and has no
    collective."""

    size, rank, group = 2, 0, None

    def __init__(self):
        self.entered = []

    def enter(self, i, h):
        self.entered.append(i)
        return h

    def leave(self, i, h):
        return h


def test_moe_limits_raise():
    """What a MoE decoder still refuses, and why: under sequence parallelism
    a forward without the data x seq routing group (a rank's rows alone
    would give the slice's capacity); the streamed layout (JAX's assert).
    Under a pipeline it runs JAX's plain loop, never the schedule: every
    block gathered around its use, the output the one-process output. A
    whole model builds, its router f32 in bf16."""
    from visper_lm_tpu_torch.parallel.distributed import AxisGroup
    from visper_lm_tpu_torch.parallel.sequence import SequenceParallel

    _, cfg_t = _cfgs()
    dec = tdec.Decoder(cfg_t, device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in dec.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    x = torch.randn(2, 4, cfg_t.hidden_size, generator=gen)
    dec.seq = SequenceParallel(None, 0, 2)
    for group in (None, AxisGroup(None, 0, 2)):           # no group; the data group alone
        with pytest.raises(ValueError, match="routes over the data x seq group"):
            dec(x, use_kernel=False, moe_data=group)
    dec.seq = None
    with torch.no_grad():
        want = dec(x, use_kernel=False)
        dec.pipe = _Stage()
        got = dec(x, use_kernel=False)
    assert dec.pipe.entered == list(range(cfg_t.num_layers))
    assert torch.isfinite(want["logits"]).all()
    assert torch.equal(got["logits"], want["logits"])
    for k in tdec.MOE_AUX_KEYS:
        assert torch.equal(got["moe_aux"][k], want["moe_aux"][k]), k
    dec.pipe = None
    vcfg = tconfig.tiny_test_vlm()
    vcfg = dataclasses.replace(vcfg, decoder=dataclasses.replace(vcfg.decoder, moe_experts=4,
                                                                 dtype="bfloat16"))
    model = tvlm.init_vlm(vcfg, device="cpu", seed=0)
    blk = model.decoder.blocks[0]
    assert blk.moe_router.weight.dtype == torch.float32
    assert blk.moe_gate.kernel.dtype == torch.bfloat16 and blk.moe_gate.kernel.shape == (4, 64, 128)
    assert abs(float(blk.moe_router.weight.detach().std()) - 0.02) < 0.005
    assert float(blk.moe_down.kernel.detach().abs().max()) <= 128 ** -0.5
    # JAX init_moe_mlp's tree: shapes, dtypes and distributions
    tree = tmoe.init_moe_mlp(64, 128, 4, generator=torch.Generator().manual_seed(0))
    want = jmoe.init_moe_mlp(jax.random.PRNGKey(0), 64, 128, 4)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tree.items()} == {
        k: (tuple(v.shape), torch.float32 if v.dtype == jnp.float32 else torch.bfloat16)
        for k, v in want.items()}
    assert abs(float(tree["router"].std()) - 0.02) < 0.005
    assert float(tree["up"].float().abs().max()) <= 64 ** -0.5
    from visper_lm_tpu_torch.models.decoder import GradStream

    stream = GradStream(model, ((0, 2), (2, 4)), torch.device("cpu"))
    stream.arm()
    with pytest.raises(ValueError, match="no cache/MoE"):
        model.decoder(torch.zeros(1, 4, 64, dtype=torch.bfloat16), use_kernel=False)
    stream.close()


# ---------------------------------------------------------------------------
# a MoE VLM through the train step
# ---------------------------------------------------------------------------


def _vlm_batch(cfg, bsz=4, seq=64):
    rng = np.random.default_rng(0)
    plans = []
    for b in range(bsz):
        ids = [1, 2, 3] + [IMAGE_TOKEN_INDEX] + list(rng.integers(3, 400, size=8 + 3 * b))
        labels = [IGNORE_INDEX] * 4 + ids[4:]
        plans.append(build_splice_plan(ids, labels, seq, num_image_tokens=cfg.num_image_tokens))
    img = rng.normal(size=(bsz, 28, 28, 3)).astype(np.float32)
    return collate_plans(plans, images=img)


def moe_vlm_configs(cf=1.25):
    """tiny_test_vlm with JAX's dry-run MoE (E 4, top-2) at capacity factor cf."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.tiny_test_vlm(distill=False)
        out.append(dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, moe_experts=4, moe_top_k=2, moe_capacity_factor=cf)))
    return out


def test_moe_finetune_step_matches_jax():
    """The finetune step of a MoE VLM (E 4, top-2, cf 1.25: tokens dropped)
    against JAX's make_train_step: the step-1 loss with the aux terms and
    the MoE metrics (rtol 1e-5), the step-1 gradients of the router and the
    banks, every later step's loss and MoE metrics, and every trainable
    after 3 updates (atol 5e-5 / rtol 1e-4)."""
    cfg_j, cfg_t = moe_vlm_configs()
    params = jvlm.init_vlm(jax.random.PRNGKey(2), cfg_j)
    batch = _vlm_batch(cfg_j)
    loss_fn = jts.make_loss_fn(cfg_j, use_pallas=False)
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    # JAX's rules name the 'expert' axis for a MoE tree, so its step needs a
    # mesh that has one: ep 2 over two of the suite's virtual devices
    # (GSPMD's result is the one-device step's)
    mesh = make_mesh(dp=1, ep=2, tp=1, devices=jax.devices()[:2])
    metrics_j = []
    with mesh:
        step_j, state, _ = jts.make_train_step(cfg_j, jopt.OptimizerConfig(**OPT), params, mesh,
                                               use_pallas=False)
        dbatch = jts.shard_batch(batch, mesh)
        for _ in range(STEPS):
            state, m = step_j(state, dbatch)
            metrics_j.append({k: float(v) for k, v in m.items()})
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    step = tts.make_train_step(cfg_t, topt.OptimizerConfig(**OPT), model)
    met_t, grads_t = step.loss_and_grads(batch)
    for k in ("loss", "text_loss", "moe_lb_loss", "moe_z_loss", "moe_dropped_frac"):
        _close(float(met_t[k]), float(met_j[k]), rtol=1e-5, atol=1e-7, msg=k)
    assert float(met_t["moe_dropped_frac"]) > 0
    g_t = jax_flat_arrays(grads_t)
    g_j = {jopt._path_str(p): np.asarray(v)
           for p, v in jax.tree_util.tree_flatten_with_path(grads_j)[0]}
    for n in tdec.MOE_NAMES:
        path = f"decoder/blocks/{n}/kernel"
        _grad_close(g_t[path], g_j[path], msg=path)
    metrics_t = [step(batch) for _ in range(STEPS)]
    for m_t, m_j in zip(metrics_t, metrics_j):
        for k in ("loss", "moe_lb_loss", "moe_z_loss", "moe_dropped_frac"):
            _close(m_t[k], m_j[k], rtol=1e-5, atol=1e-7, msg=k)
    p_t = jax_flat_arrays(step.trainable)
    p_j = {jopt._path_str(p): np.asarray(v)
           for p, v in jax.tree_util.tree_flatten_with_path(state.params)[0]}
    for path, a in p_t.items():
        # atol 5e-5, a sixtieth of the largest move (3e-3 over the three
        # updates): Adam's normalised step turns the f32 difference of a
        # near-zero gradient element into a larger difference of its move
        np.testing.assert_allclose(a, p_j[path], atol=5e-5, rtol=1e-4, err_msg=path)
    assert model.decoder.blocks[0].moe_router.weight.dtype == torch.float32
