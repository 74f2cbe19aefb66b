"""The window-attention plain version against the JAX package's XLA oracle
and its Pallas kernel in interpret mode, on the CPU (f32; tolerance 2e-5, as
tests/test_window_attention.py holds the kernel to the oracle)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visper_lm_tpu.ops.window_attention import window_attention_pallas, window_attention_xla

from visper_lm_tpu_torch.ops import window_attention as twin

torch.set_num_threads(2)


def _inputs(seed, w, h, n, d, nw, with_mask):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((w, h, n, d)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((h, n, n)).astype(np.float32)
    mask = rng.choice([0.0, -100.0], size=(nw, n, n)).astype(np.float32) if with_mask else None
    return q, k, v, bias, mask


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("w,nw", [(8, 4), (12, 4), (4, 4)])
def test_plain_matches_xla_and_interpret_kernel(with_mask, w, nw):
    """W a multiple of nW (3x, 2x and 1x): mask row i applies to window i % nW."""
    h, n, d = 3, 16, 8
    q, k, v, bias, mask = _inputs(0, w, h, n, d, nw, with_mask)
    scale = d ** -0.5
    args_j = [jnp.asarray(x) for x in (q, k, v, bias)] + [None if mask is None else jnp.asarray(mask)]
    ref_x = np.asarray(window_attention_xla(*args_j, scale))
    ref_k = np.asarray(window_attention_pallas(*args_j, scale, window_block=2, interpret=True))
    got = twin.window_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v, bias)),
        None if mask is None else torch.from_numpy(mask), scale,
    ).numpy()
    np.testing.assert_allclose(got, ref_x, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, ref_k, rtol=2e-5, atol=2e-5)


def test_dispatch_on_cpu_takes_the_plain_version_and_counts_no_launch():
    q, k, v, bias, mask = _inputs(1, 8, 2, 144, 32, 4, True)
    tq, tk, tv, tb, tm = (torch.from_numpy(x) for x in (q, k, v, bias, mask))
    before = twin.launches
    got = twin.window_attention(tq, tk, tv, tb, tm, use_kernel=True)
    assert twin.launches == before
    torch.testing.assert_close(got, twin.window_attention_plain(tq, tk, tv, tb, tm, 32 ** -0.5))
    ref = window_attention_xla(*(jnp.asarray(x) for x in (q, k, v, bias, mask)), 32 ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
