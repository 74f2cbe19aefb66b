"""Quantized serving, the whole slice: the port vs the JAX package on the CPU.

tiny_test_vlm(distill=True) with the JAX init_vlm weights carried over by
`weights.from_jax_params` (f32). The int8 KV cache through prefill and
teacher-forced decode, with dense and with JAX-quantized w8a16 weights; the
AWQ activation statistics; and the Generator's greedy tokens for int8 KV +
w8a16 and for int8 KV + AWQ-calibrated w4a16.

Tolerances: logits 1e-4 x max|logits| (four layers of f32 sums taken in
another order); cache int8 values within +-1 of JAX's, with mismatches in
fewer than 0.1 % of the entries (a value at a rounding tie may land on
either side), scales rtol 1e-5; activation RMS rtol 1e-5; greedy tokens
identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.data.collate import build_splice_plan as j_build_splice_plan
from visper_lm_tpu.models import decoder as jdec
from visper_lm_tpu.models.vlm import init_vlm as j_init_vlm
from visper_lm_tpu.serve import generate as jgen
from visper_lm_tpu.serve.calibrate import decoder_act_rms as j_decoder_act_rms
from visper_lm_tpu.utils.param import quantize_linear_weights

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.constants import IMAGE_TOKEN_INDEX
from visper_lm_tpu_torch.data.collate import build_splice_plan
from visper_lm_tpu_torch.models import decoder as tdec
from visper_lm_tpu_torch.serve import generate as tgen
from visper_lm_tpu_torch.serve.calibrate import decoder_act_rms
from visper_lm_tpu_torch.utils.param import QuantLinear
from visper_lm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

PROMPT_LEN = 128


@pytest.fixture(scope="module")
def setup():
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    params = jax.tree_util.tree_map(np.asarray, j_init_vlm(jax.random.PRNGKey(0), cfg_j))
    model = from_jax_params(params, cfg_t, device="cpu")
    rng = np.random.default_rng(0)
    raw = [
        [1, 2, 3, IMAGE_TOKEN_INDEX] + list(rng.integers(4, 400, size=5 + 9 * b))
        for b in range(2)
    ]
    kw = dict(num_image_tokens=cfg_t.num_image_tokens, num_task_tokens=2, num_tasks=3)
    plans = [build_splice_plan(ids, None, PROMPT_LEN, **kw) for ids in raw]
    batch = tgen.left_pad_plans(plans, PROMPT_LEN)
    batch["images"] = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    j_plans = [j_build_splice_plan(ids, None, PROMPT_LEN, **kw) for ids in raw]
    return cfg_j, cfg_t, params, model, batch, plans, j_plans


@pytest.mark.parametrize("weights", ["dense", "w8a16"])
def test_quant_cache_prefill_and_decode_match_jax(setup, weights):
    """Left-padded prefill into the int8 cache, then 8 decode steps fed JAX's
    greedy tokens: logits, cache values and scales agree with JAX."""
    cfg_j, cfg_t, params, model = setup[:4]
    dec_j = params["decoder"]
    decoder = model.decoder
    if weights == "w8a16":
        dec_j = jax.tree_util.tree_map(np.asarray, quantize_linear_weights(dec_j))
        decoder = from_jax_params({**params, "decoder": dec_j}, cfg_t, device="cpu").decoder
        assert isinstance(decoder.blocks[0].q_proj, QuantLinear)
    table = np.asarray(params["decoder"]["embed_tokens"]["embedding"])
    rng = np.random.default_rng(4)
    b, t, max_len, steps = 2, 16, 32, 8
    embeds = (0.5 * rng.standard_normal((b, t, 64))).astype(np.float32)
    offsets = np.array([0, 5], np.int32)
    positions = np.maximum(np.arange(t)[None, :] - offsets[:, None], 0)
    lens = np.full((b,), t, np.int32)

    cache_j = jdec.init_quant_kv_cache(cfg_j.decoder, b, max_len)
    ref = jdec.decoder_forward(
        dec_j, cfg_j.decoder, embeds, positions=jnp.asarray(positions),
        kv_lengths=jnp.asarray(lens), kv_starts=jnp.asarray(offsets), cache=cache_j,
        q_offset=0, use_pallas=False,
    )
    cache_t = tdec.init_quant_kv_cache(cfg_t.decoder, b, max_len, device="cpu")
    with torch.no_grad():
        out = decoder(
            torch.from_numpy(embeds), positions=torch.from_numpy(positions),
            kv_lengths=torch.from_numpy(lens), kv_starts=torch.from_numpy(offsets),
            cache=cache_t, q_offset=0,
        )
    for i in range(b):  # pad rows are don't-care
        r = np.asarray(ref["logits"])[i, offsets[i]:]
        assert np.abs(out["logits"][i, offsets[i]:].numpy() - r).max() <= 1e-4 * np.abs(r).max()
    cache_j = ref["cache"]
    logits = np.asarray(ref["logits"])[:, -1]
    for step in range(steps):
        slot = t + step
        tok = table[np.argmax(logits, axis=-1)][:, None]          # teacher: JAX's greedy token
        pos = (slot - offsets)[:, None]
        ref = jdec.decoder_forward(
            dec_j, cfg_j.decoder, tok, positions=jnp.asarray(pos),
            kv_lengths=jnp.full((b,), slot + 1, jnp.int32), kv_starts=jnp.asarray(offsets),
            cache=cache_j, q_offset=slot, use_pallas=False,
        )
        with torch.no_grad():
            out = decoder(
                torch.from_numpy(tok), positions=torch.from_numpy(pos),
                kv_starts=torch.from_numpy(offsets), cache=cache_t, q_offset=slot,
            )
        logits = np.asarray(ref["logits"])[:, 0]
        assert np.abs(out["logits"][:, 0].numpy() - logits).max() <= 1e-4 * np.abs(logits).max(), step
        cache_j = ref["cache"]
    for i in range(b):  # the valid slots, written in place by the port
        sl = slice(int(offsets[i]), t + steps)
        for name in ("k", "v"):
            got = getattr(cache_t, name)[:, sl, i].numpy().astype(np.int32)
            want = np.asarray(getattr(cache_j, name))[:, sl, i].astype(np.int32)
            assert np.abs(got - want).max() <= 1
            assert (got != want).mean() < 1e-3
            np.testing.assert_allclose(
                getattr(cache_t, f"{name}_scale")[:, sl, i].numpy(),
                np.asarray(getattr(cache_j, f"{name}_scale"))[:, sl, i], rtol=1e-5,
            )


def test_decoder_act_rms_matches_jax(setup):
    cfg_j, cfg_t, params, model = setup[:4]
    rng = np.random.default_rng(5)
    batches = [rng.standard_normal(s).astype(np.float32) for s in ((2, 16, 64), (3, 8, 64))]
    ref = j_decoder_act_rms(params["decoder"], cfg_j.decoder, [jnp.asarray(x) for x in batches])
    got = decoder_act_rms(model.decoder, cfg_t.decoder, [torch.from_numpy(x) for x in batches])
    assert set(got) == set(ref) == set(tdec.LINEAR_NAMES) | {"lm_head"}
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("weight_quant", [True, "int4"])
def test_quantized_generator_tokens_match_jax(setup, weight_quant):
    """int8 KV + w8a16, and int8 KV + w4a16 with AWQ calibration (the same
    act-RMS dict on both sides): 10 greedy tokens in chunks of 4, identical.
    The port quantizes its own copy: the caller's model keeps its weights."""
    cfg_j, cfg_t, params, model, batch = setup[:5]
    calibration = None
    if weight_quant == "int4":
        rng = np.random.default_rng(6)
        embeds = [jnp.asarray(0.5 * rng.standard_normal((4, 32, 64)), jnp.float32)]
        calibration = {k: np.asarray(v) for k, v in
                       j_decoder_act_rms(params["decoder"], cfg_j.decoder, embeds).items()}
    kw = dict(max_new_tokens=10, decode_chunk=4, kv_quant=True, weight_quant=weight_quant,
              calibration=calibration)
    ref = jgen.Generator(params, cfg_j, jgen.GenerationConfig(**kw), 2, PROMPT_LEN).generate(dict(batch))
    before = model.decoder.blocks[0].q_proj.weight.detach().clone()
    gen = tgen.Generator(model, cfg_t, tgen.GenerationConfig(**kw), 2, PROMPT_LEN, device="cpu")
    assert isinstance(gen.decoder.blocks[0].q_proj, QuantLinear)
    assert isinstance(gen.decoder.lm_head, QuantLinear)
    if weight_quant == "int4":
        assert gen.decoder.blocks[0].q_proj.q4_in_scale is not None
    out = gen.generate(dict(batch))
    assert out == ref
    assert all(len(o) == 10 for o in out)
    assert model.decoder.blocks[0].q_proj is not gen.decoder.blocks[0].q_proj
    assert torch.equal(model.decoder.blocks[0].q_proj.weight, before)
    _, cache = gen.prefill(dict(batch))
    assert isinstance(cache, tdec.QuantKVCache) and cache.k.dtype == torch.int8


class _LetterTokenizer:
    """Token id -> one letter."""

    def decode(self, ids, skip_special_tokens=False):
        return "".join(chr(97 + i % 26) for i in ids)


@pytest.mark.parametrize("quant", [None, True])
def test_greedy_decode_text_matches_jax(setup, quant):
    """plans + images -> strings; None takes each side's default, which is the
    unquantized path on the CPU for both (JAX: "on a TPU"; the port: "CUDA
    present"), True the int8 KV + w8a16 configuration."""
    cfg_j, cfg_t, params, model, batch, plans, j_plans = setup
    tok = _LetterTokenizer()
    kw = dict(max_new_tokens=6, kv_quant=quant, weight_quant=quant)
    ref = jgen.greedy_decode_text(params, cfg_j, j_plans, batch["images"], tok, **kw)
    out = tgen.greedy_decode_text(model, cfg_t, plans, batch["images"], tok, device="cpu", **kw)
    assert out == ref and all(len(o) == 6 for o in out)
