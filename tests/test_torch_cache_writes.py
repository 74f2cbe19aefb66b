"""The decoder's cache offsets: per-slot KV cache writes and the offset routing,
port vs the JAX package on the CPU.

A write is a copy, so it is held bit for bit: the port's `write_cache_chunk`
against the writes JAX's `decoder_forward` makes into one layer of its
stacked cache (`dynamic_update_slice` for one offset, a scatter with
mode="drop" for an offset per sample), on the same chunk and the same
starting cache, dropped writes past max_len included; the int8 cache's
values and scales come from each package's own quantizer (bit-equal, jitted).
Through the whole decoder (tiny_test_vlm's, f32 weights from the JAX
tree): an int, a 0-d and a (B,) offset give the port the same logits and
cache bit for bit, as JAX's test_per_slot_cache_write_matches_scalar holds
for JAX; against JAX the logits and caches agree within atol 1e-5 / rtol
1e-4 (sums in another order), and the written slots are exactly JAX's. The
cache attention with an f32 query over a bf16 cache (JAX's engine under an
f32 model) matches `mha_xla_cache` within atol 2e-6 / rtol 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.models import decoder as jdec
from visper_lm_tpu.models.vlm import init_vlm as j_init_vlm

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.models import decoder as tdec
from visper_lm_tpu_torch.weights import decoder_from_jax_params

torch.set_num_threads(2)

S, B, NKV, H = 24, 3, 2, 16

# name -> (q_offset: an int for one position, a list for one per sample, chunk length)
WRITE_CASES = {
    "scalar": (5, 4),
    "per_sample": ([2, 10, 17], 3),
    "at_max_len": ([S - 2, S, 20], 3),     # sample 0 keeps 2 rows, sample 1 none
    "all_dropped": ([S, S, S], 2),         # empty slots of the engine (kv_starts = S)
}


def _jax_write(c, u, q_offset):
    """JAX `decoder_forward`'s `_write_new_kv` on one layer (S, B, ...)."""
    if np.ndim(q_offset) == 0:
        start = jnp.asarray(q_offset, jnp.int32)
        return jax.lax.dynamic_update_slice(c, u.astype(c.dtype), (start,) + (0,) * (c.ndim - 1))
    starts = jnp.asarray(q_offset, jnp.int32)
    t_, b_ = u.shape[0], u.shape[1]
    pos = starts[None, :] + jnp.arange(t_, dtype=jnp.int32)[:, None]
    bidx = jnp.broadcast_to(jnp.arange(b_)[None, :], (t_, b_))
    return c.at[pos, bidx].set(u.astype(c.dtype), mode="drop")


def _port_offset(q_offset):
    return torch.tensor(q_offset, dtype=torch.long)


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_float_cache_write_matches_jax_bit_for_bit(case):
    q_offset, t = WRITE_CASES[case]
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((S, B, NKV, H)).astype(np.float32)
    new = rng.standard_normal((t, B, NKV, H)).astype(np.float32)
    ref = np.asarray(_jax_write(jnp.asarray(cache), jnp.asarray(new), q_offset))
    got = torch.from_numpy(cache.copy())
    tdec.write_cache_chunk(got, torch.from_numpy(new), _port_offset(q_offset))
    np.testing.assert_array_equal(got.numpy(), ref)
    if case == "all_dropped":
        np.testing.assert_array_equal(got.numpy(), cache)


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_int8_cache_write_matches_jax_bit_for_bit(case):
    """Values and scales of the int8 cache, each package quantizing the chunk."""
    q_offset, t = WRITE_CASES[case]
    rng = np.random.default_rng(1)
    values = rng.integers(-127, 128, size=(S, B, NKV, H)).astype(np.int8)
    scales = rng.uniform(0.01, 1.0, size=(S, B, NKV)).astype(np.float32)
    new = rng.standard_normal((t, B, NKV, H)).astype(np.float32)
    jq, js = jax.jit(jdec._quantize_head_vectors)(jnp.asarray(new))
    tq, ts = tdec.quantize_head_vectors(torch.from_numpy(new))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    ref_v = np.asarray(_jax_write(jnp.asarray(values), jq, q_offset))
    ref_s = np.asarray(_jax_write(jnp.asarray(scales), js[..., 0], q_offset))
    got_v, got_s = torch.from_numpy(values.copy()), torch.from_numpy(scales.copy())
    tdec.write_cache_chunk(got_v, tq, _port_offset(q_offset))
    tdec.write_cache_chunk(got_s, ts[..., 0], _port_offset(q_offset))
    np.testing.assert_array_equal(got_v.numpy(), ref_v)
    np.testing.assert_array_equal(got_s.numpy(), ref_s)


def test_int_offset_write_is_the_scalar_tensor_write():
    rng = np.random.default_rng(2)
    cache = torch.from_numpy(rng.standard_normal((S, B, NKV, H)).astype(np.float32))
    new = torch.from_numpy(rng.standard_normal((4, B, NKV, H)).astype(np.float32))
    a, b = cache.clone(), cache.clone()
    tdec.write_cache_chunk(a, new, 7)
    tdec.write_cache_chunk(b, new, torch.tensor(7))
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def decoders():
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    params = j_init_vlm(jax.random.PRNGKey(3), cfg_j)["decoder"]
    port = decoder_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg_t.decoder, device="cpu"
    )
    return params, cfg_j.decoder, port, cfg_t.decoder


def _port_prefill_and_step(port, dcfg, embeds, tok, q_offset, quant):
    b, p = embeds.shape[:2]
    s = 64
    if quant:
        cache = tdec.init_quant_kv_cache(dcfg, b, s, device="cpu")
    else:
        cache = tdec.init_kv_cache(dcfg, b, s, dtype=torch.float32, device="cpu")
    zeros = torch.zeros((b,), dtype=torch.long)
    with torch.no_grad():
        port(embeds, kv_lengths=torch.full((b,), p), kv_starts=zeros, cache=cache,
             q_offset=0, compute_logits=False)
        out = port(tok, positions=torch.full((b, 1), p), kv_lengths=torch.full((b,), p + 1),
                   kv_starts=zeros, cache=cache, q_offset=q_offset)
    return out["logits"], cache


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_per_slot_decoder_step_matches_scalar(decoders, quant):
    """A step at an int, a 0-d tensor and a uniform (B,) tensor offset gives
    the same logits and cache bit for bit; the f32 case also matches JAX's."""
    params, jcfg, port, dcfg = decoders
    b, p = 2, 16
    rng = np.random.default_rng(0)
    embeds = rng.standard_normal((b, p, dcfg.hidden_size)).astype(np.float32)
    tok = rng.standard_normal((b, 1, dcfg.hidden_size)).astype(np.float32)
    runs = {
        name: _port_prefill_and_step(port, dcfg, torch.from_numpy(embeds),
                                     torch.from_numpy(tok), off, quant)
        for name, off in (("int", p), ("scalar", torch.tensor(p)),
                          ("vector", torch.full((b,), p)))
    }
    ref_logits, ref_cache = runs["int"]
    for name in ("scalar", "vector"):
        logits, cache = runs[name]
        assert torch.equal(logits, ref_logits), name
        for x, y in zip(vars(cache).values(), vars(ref_cache).values()):
            assert torch.equal(x, y), name
    if quant:
        return
    cache = jdec.init_kv_cache(jcfg, b, 64, dtype=jnp.float32)
    out = jdec.decoder_forward(
        params, jcfg, jnp.asarray(embeds), kv_lengths=jnp.full((b,), p, jnp.int32),
        kv_starts=jnp.zeros((b,), jnp.int32), cache=cache, q_offset=0, compute_logits=False,
    )
    out = jdec.decoder_forward(
        params, jcfg, jnp.asarray(tok), positions=jnp.full((b, 1), p, jnp.int32),
        kv_lengths=jnp.full((b,), p + 1, jnp.int32), kv_starts=jnp.zeros((b,), jnp.int32),
        cache=out["cache"], q_offset=jnp.full((b,), p, jnp.int32),
    )
    np.testing.assert_allclose(ref_logits.numpy(), np.asarray(out["logits"]), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(ref_cache.k.numpy(), np.asarray(out["cache"].k), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_per_slot_decoder_write_heterogeneous(decoders, quant):
    """Each sample's K/V lands at ITS position only (JAX's
    test_per_slot_cache_write_heterogeneous), and a sample at max_len writes
    nothing and raises nothing. The written slots are JAX's."""
    params, jcfg, port, dcfg = decoders
    s = 64
    starts = [5, 20, 33, s]
    b = len(starts)
    tok = np.random.default_rng(1).standard_normal((b, 1, dcfg.hidden_size)).astype(np.float32)
    if quant:
        cache = tdec.init_quant_kv_cache(dcfg, b, s, device="cpu")
        jcache = jdec.init_quant_kv_cache(jcfg, b, s)
    else:
        cache = tdec.init_kv_cache(dcfg, b, s, dtype=torch.float32, device="cpu")
        jcache = jdec.init_kv_cache(jcfg, b, s, dtype=jnp.float32)
    off = torch.tensor(starts)
    with torch.no_grad():
        port(torch.from_numpy(tok), positions=off[:, None], kv_lengths=off + 1,
             kv_starts=torch.zeros((b,), dtype=torch.long), cache=cache, q_offset=off,
             compute_logits=False)
    jstarts = jnp.asarray(starts, jnp.int32)
    ref = jdec.decoder_forward(
        params, jcfg, jnp.asarray(tok), positions=jstarts[:, None], kv_lengths=jstarts + 1,
        kv_starts=jnp.zeros((b,), jnp.int32), cache=jcache, q_offset=jstarts,
        compute_logits=False,
    )["cache"]
    k = cache.k.float().numpy()
    written = np.abs(k).sum(axis=(0, 3, 4)) > 0                       # (S, B)
    np.testing.assert_array_equal(written, np.abs(np.asarray(ref.k, np.float32)).sum(axis=(0, 3, 4)) > 0)
    for i, st in enumerate(starts):
        expect = np.zeros(s, bool)
        if st < s:
            expect[st] = True
        np.testing.assert_array_equal(written[:, i], expect)
    if quant:
        np.testing.assert_allclose(cache.k_scale.numpy(), np.asarray(ref.k_scale), rtol=1e-5)
    else:
        np.testing.assert_allclose(k, np.asarray(ref.k), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("offset", ["int", "tensor"])
def test_only_an_int_zero_takes_the_prefill_route(decoders, monkeypatch, offset):
    """JAX's routing: an int 0 with T > 1 attends through
    `multi_head_attention` (the flash kernel on the card); a 0-d tensor 0, as
    beam search and speculative decoding pass it, takes the cache route."""
    _, _, port, dcfg = decoders
    calls = {"mha": 0, "cache": 0}
    mha, cached = tdec.multi_head_attention, tdec.mha_plain_cache

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tdec, "multi_head_attention", count("mha", mha))
    monkeypatch.setattr(tdec, "mha_plain_cache", count("cache", cached))
    cache = tdec.init_kv_cache(dcfg, 1, 32, dtype=torch.float32, device="cpu")
    emb = torch.randn(1, 8, dcfg.hidden_size, generator=torch.Generator().manual_seed(0))
    q_offset = 0 if offset == "int" else torch.tensor(0)
    with torch.no_grad():
        port(emb, kv_lengths=torch.tensor([8]), cache=cache, q_offset=q_offset)
    n = dcfg.num_layers
    assert calls == ({"mha": n, "cache": 0} if offset == "int" else {"mha": 0, "cache": n})


@pytest.mark.parametrize("t", [1, 4])
def test_f32_query_over_a_bf16_cache_matches_jax(t):
    """JAX's engine keeps a bf16 cache under an f32 model, and `mha_xla_cache`
    dots in f32 on the CPU: the port's dot operands take the wider of q's and
    the cache's dtype, so the chunk's f32 K/V and q are not rounded to bf16."""
    from visper_lm_tpu.ops.attention import mha_xla_cache
    from visper_lm_tpu_torch.ops.attention import mha_plain_cache

    rng = np.random.default_rng(5)
    b, s, nq, nkv, h = 2, 24, 4, 2, 16
    q = rng.standard_normal((b, t, nq, h)).astype(np.float32)
    ck = jnp.asarray(rng.standard_normal((s, b, nkv, h)), jnp.bfloat16)
    cv = jnp.asarray(rng.standard_normal((s, b, nkv, h)), jnp.bfloat16)
    ek, ev = (rng.standard_normal((b, t, nkv, h)).astype(np.float32) for _ in range(2))
    starts = np.array([3, 0], np.int32)
    ref = mha_xla_cache(jnp.asarray(q), ck, cv, extra_k=jnp.asarray(ek), extra_v=jnp.asarray(ev),
                        cache_len=jnp.asarray([17, 9], jnp.int32), kv_starts=jnp.asarray(starts))

    def bf16(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)

    got = mha_plain_cache(torch.from_numpy(q), bf16(ck), bf16(cv), extra_k=torch.from_numpy(ek),
                          extra_v=torch.from_numpy(ev), cache_len=torch.tensor([17, 9]),
                          kv_starts=torch.from_numpy(starts))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6, rtol=2e-5)
