"""Decode attention on the CPU: the B6 kernel's plain version vs the JAX
package's Pallas decode kernel (interpret mode, block_k 32), and the decode
path's int8 cache attention (`mha_plain_cache` with scales) vs JAX
`mha_xla_cache`.

Inputs are made with numpy from a seed; everything is f32. Tolerances: 2e-5
(f32 sums in another order: the Pallas kernel runs an online softmax over
32-position blocks, the plain version one softmax), 1e-4 for the int8 cache
as in tests/test_decode_attention.py; a row with no valid position is exactly 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visper_lm_tpu.models.decoder import _quantize_head_vectors as j_quantize_head_vectors
from visper_lm_tpu.ops.attention import mha_xla_cache
from visper_lm_tpu.ops.decode_attention import decode_attention as j_decode_attention

from visper_lm_tpu_torch.models.decoder import quantize_head_vectors
from visper_lm_tpu_torch.ops import decode_attention as tda
from visper_lm_tpu_torch.ops.attention import mha_plain_cache

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("nq,nkv", [(8, 8), (8, 2)])
def test_decode_reference_matches_pallas_dense(nq, nkv):
    rng = np.random.default_rng(0)
    b, h, s = 3, 64, 128
    q, k, v = _randn(rng, b, 1, nq, h), _randn(rng, b, nkv, s, h), _randn(rng, b, nkv, s, h)
    lens = np.array([40, 128, 77], np.int32)
    starts = np.array([5, 0, 20], np.int32)
    ref = j_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_lengths=jnp.asarray(lens),
        kv_starts=jnp.asarray(starts), interpret=True, block_k=32,
    )
    before = tda.launches
    got = tda.decode_attention(_t(q), _t(k), _t(v), kv_lengths=_t(lens), kv_starts=_t(starts))
    assert tda.launches == before                      # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_decode_reference_matches_pallas_int8():
    rng = np.random.default_rng(1)
    b, nq, nkv, h, s = 2, 4, 4, 32, 96
    q, k, v = _randn(rng, b, 1, nq, h), _randn(rng, b, nkv, s, h), _randn(rng, b, nkv, s, h)
    lens = np.array([96, 50], np.int32)
    starts = np.array([0, 10], np.int32)
    kq, ks = j_quantize_head_vectors(jnp.asarray(k))
    vq, vs = j_quantize_head_vectors(jnp.asarray(v))
    ref = j_decode_attention(
        jnp.asarray(q), kq, vq, ks[..., 0], vs[..., 0], kv_lengths=jnp.asarray(lens),
        kv_starts=jnp.asarray(starts), interpret=True, block_k=32,
    )
    # the port's own per-vector quantizer gives the same int8 values and scales
    tkq, tks = quantize_head_vectors(_t(k))
    np.testing.assert_array_equal(tkq.numpy(), np.asarray(kq))
    np.testing.assert_allclose(tks.numpy(), np.asarray(ks), rtol=1e-6)
    got = tda.decode_attention(
        _t(q), _t(kq), _t(vq), _t(ks[..., 0]), _t(vs[..., 0]),
        kv_lengths=_t(lens), kv_starts=_t(starts),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_decode_reference_fully_masked_row_is_zero():
    rng = np.random.default_rng(2)
    b, nq, nkv, h, s = 2, 2, 2, 32, 64
    q, k, v = _randn(rng, b, 1, nq, h), _randn(rng, b, nkv, s, h), _randn(rng, b, nkv, s, h)
    lens = np.array([0, 64], np.int32)
    ref = j_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_lengths=jnp.asarray(lens),
        kv_starts=jnp.zeros((2,), jnp.int32), interpret=True, block_k=32,
    )
    got = tda.decode_attention(_t(q), _t(k), _t(v), kv_lengths=_t(lens), kv_starts=torch.zeros(2))
    assert torch.isfinite(got).all()
    assert torch.all(got[0] == 0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("t", [1, 4])
def test_mha_plain_cache_int8_matches_mha_xla_cache(t):
    """Slot-major int8 cache + per-vector scales + the chunk as extras: k scales
    on the cache scores, v scales on the cache probabilities; f32 q, so the dot
    operands are f32 on both sides."""
    rng = np.random.default_rng(4)
    b, s, nq, nkv, h = 2, 24, 8, 2, 16
    q = _randn(rng, b, t, nq, h)
    kq, ks = j_quantize_head_vectors(jnp.asarray(_randn(rng, s, b, nkv, h)))
    vq, vs = j_quantize_head_vectors(jnp.asarray(_randn(rng, s, b, nkv, h)))
    ek, ev = _randn(rng, b, t, nkv, h), _randn(rng, b, t, nkv, h)
    starts = np.array([3, 0], np.int32)
    ref = mha_xla_cache(
        q, kq, vq, ks[..., 0], vs[..., 0], extra_k=ek, extra_v=ev, cache_len=17,
        kv_starts=jnp.asarray(starts),
    )
    got = mha_plain_cache(
        _t(q), _t(kq), _t(vq), _t(ks[..., 0]), _t(vs[..., 0]), extra_k=_t(ek), extra_v=_t(ev),
        cache_len=17, kv_starts=_t(starts),
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
