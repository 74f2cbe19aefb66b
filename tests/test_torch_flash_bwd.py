"""The flash-attention backward's plain version and the autograd Function,
against the JAX package's custom VJP with the Pallas kernels in interpret
mode, on the CPU.

Inputs and the output cotangent are made with numpy from a seed and handed to
both sides; everything is f32. Tolerance atol 2e-5 / rtol 2e-4, as for the
forward (tests/test_torch_ops.py): sums over 256 keys taken in 128-key blocks
by the Pallas kernels and in one einsum here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu.ops import flash_attention as jflash

from visper_lm_tpu_torch.ops import attention as tattn
from visper_lm_tpu_torch.ops import flash_attention as tflash

torch.set_num_threads(2)

ATOL, RTOL = 2e-5, 2e-4
B, T = 2, 256

CASES = {
    "h64_mha": dict(nq=4, nkv=4, h=64),
    "h96_gqa": dict(nq=4, nkv=2, h=96),
    "h64_gqa_kv_lengths": dict(nq=4, nkv=2, h=64, kv_lengths=[256, 170]),
    "h96_mha_kv_lengths": dict(nq=4, nkv=4, h=96, kv_lengths=[90, 256]),
    "h96_gqa_kv_starts": dict(nq=4, nkv=2, h=96, kv_starts=[64, 0]),
    "h64_noncausal_both": dict(nq=4, nkv=2, h=64, causal=False, kv_lengths=[200, 256], kv_starts=[0, 30]),
}


def _inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, c["nq"], c["h"])).astype(np.float32)
    k = rng.standard_normal((B, T, c["nkv"], c["h"])).astype(np.float32)
    v = rng.standard_normal((B, T, c["nkv"], c["h"])).astype(np.float32)
    do = rng.standard_normal((B, T, c["nq"], c["h"])).astype(np.float32)
    masks = {
        name: np.asarray(c[name], np.int32) for name in ("kv_lengths", "kv_starts") if name in c
    }
    return q, k, v, do, masks


def _jax_vjp(c, q, k, v, do, masks):
    def f(q_, k_, v_):
        return jflash.flash_attention(
            q_, k_, v_, causal=c.get("causal", True), interpret=True, block_q=128,
            block_k=128, **{n: jnp.asarray(m) for n, m in masks.items()},
        )

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_reference_matches_pallas_vjp(case):
    """dq, dk, dv of the plain backward (fed the plain forward's out and lse)
    against jax.vjp of the interpret-mode Pallas kernels, on every row."""
    c = CASES[case]
    q, k, v, do, masks = _inputs(c)
    ref = _jax_vjp(c, q, k, v, do, masks)
    kw = dict(causal=c.get("causal", True), **{n: torch.from_numpy(m) for n, m in masks.items()})
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = tflash.flash_attention_fwd(tq, tk, tv, **kw)
    got = tflash.flash_attention_bwd(tq, tk, tv, out, lse, torch.from_numpy(do), **kw)
    for g, r in zip(got, ref):
        _close(g, r)


def test_autograd_through_flash_attention_matches_pallas_vjp():
    """The Function on CPU tensors: out.backward(dO) gives the JAX grads, and
    the wrapper launches nothing."""
    c = CASES["h96_gqa_kv_starts"]
    q, k, v, do, masks = _inputs(c, seed=1)
    ref = _jax_vjp(c, q, k, v, do, masks)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    counts = (tflash.launches, tflash.dq_launches, tflash.dkv_launches)
    out = tflash.flash_attention(tq, tk, tv, kv_starts=torch.from_numpy(masks["kv_starts"]))
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    for g, r in zip((tq.grad, tk.grad, tv.grad), ref):
        _close(g, r)
    assert (tflash.launches, tflash.dq_launches, tflash.dkv_launches) == counts


def test_pad_rows_get_zero_dq_and_no_share_of_dk_dv():
    c = CASES["h96_gqa_kv_starts"]
    q, k, v, do, masks = _inputs(c, seed=2)
    starts = torch.from_numpy(masks["kv_starts"])
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = tflash.flash_attention_fwd(tq, tk, tv, kv_starts=starts)
    dq, dk, dv = tflash.flash_attention_bwd(tq, tk, tv, out, lse, torch.from_numpy(do), kv_starts=starts)
    assert torch.all(dq[0, :64] == 0)
    assert torch.all(dk[0, :64] == 0) and torch.all(dv[0, :64] == 0)
    # the pad rows' cotangent is ignored
    do2 = do.copy()
    do2[0, :64] = 1e3
    _, dk2, dv2 = tflash.flash_attention_bwd(tq, tk, tv, out, lse, torch.from_numpy(do2), kv_starts=starts)
    torch.testing.assert_close(dk2, dk)
    torch.testing.assert_close(dv2, dv)


def test_multi_head_attention_sends_grad_through_the_function():
    """Eligible attention with grad takes the Function (the same eligibility
    predicate as without grad); grads equal autograd through mha_plain."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 128, 2, 64)).astype(np.float32)) for _ in range(3))
    lens = torch.tensor([128, 77])
    grads = []
    for use_kernel in (True, False):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = tattn.multi_head_attention(*xs, kv_lengths=lens, use_kernel=use_kernel)
        name = type(out.grad_fn).__name__
        assert (name == "FlashAttentionBackward") == use_kernel, name
        out.square().sum().backward()
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
