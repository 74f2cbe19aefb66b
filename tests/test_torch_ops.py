"""Port ops vs their JAX twins on the CPU: norms, linear, rope, plain attention,
cache attention and the flash kernel's plain version.

Inputs are made with numpy from a seed and handed to both sides. Everything
is f32; the JAX side runs at matmul precision "highest" (tests/conftest.py).
Tolerances: atol 1e-5 / rtol 1e-4 for elementwise ops and attention (f32
sums taken in a different order); flash comparisons use rows >= kv_starts
only, because fully masked pad rows differ by design (kernel 0, plain a
uniform average).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visper_lm_tpu.models import rope as jrope
from visper_lm_tpu.ops import attention as jattn
from visper_lm_tpu.ops import flash_attention as jflash
from visper_lm_tpu.utils import param as jparam

from visper_lm_tpu_torch.models import rope as trope
from visper_lm_tpu_torch.ops import attention as tattn
from visper_lm_tpu_torch.ops import flash_attention as tflash
from visper_lm_tpu_torch.utils import param as tparam

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(
        port.detach().numpy() if torch.is_tensor(port) else port,
        np.asarray(ref), atol=atol, rtol=rtol,
    )


def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x, scale, bias = _randn(rng, 2, 5, 48), _randn(rng, 48), _randn(rng, 48)
    _close(
        tparam.rmsnorm(_t(x), _t(scale), 1e-5),
        jparam.rmsnorm({"scale": scale}, x, 1e-5),
    )
    _close(
        tparam.layernorm(_t(x), _t(scale), _t(bias), 1e-5),
        jparam.layernorm({"scale": scale, "bias": bias}, x, 1e-5),
    )


def test_linear_and_activations_match_jax():
    rng = np.random.default_rng(1)
    x, kernel, bias = _randn(rng, 3, 7, 24), _randn(rng, 24, 40), _randn(rng, 40)
    # nn.Linear holds (out, in): the JAX kernel transposed
    _close(
        tparam.linear(_t(x), _t(kernel.T.copy()), _t(bias)),
        jparam.linear({"kernel": kernel, "bias": bias}, x),
    )
    for name in ("gelu", "quick_gelu", "silu"):
        _close(tparam.ACTIVATIONS[name](_t(x)), jparam.ACTIVATIONS[name](x))


def test_rope_matches_jax():
    rng = np.random.default_rng(2)
    positions = np.maximum(np.arange(9)[None, :] - np.array([[0], [3]]), 0)
    x = _randn(rng, 2, 9, 4, 16)
    cos_j, sin_j = jrope.rope_cos_sin(jnp.asarray(positions), 16, 10000.0)
    cos_t, sin_t = trope.rope_cos_sin(_t(positions), 16, 10000.0)
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)
    _close(trope.apply_rope(_t(x), cos_t, sin_t), jrope.apply_rope(x, cos_j, sin_j))


MHA_CASES = {
    "causal": dict(nq=4, nkv=4, causal=True),
    "noncausal": dict(nq=4, nkv=4, causal=False),
    "gqa": dict(nq=4, nkv=2, causal=True),
    "kv_lengths": dict(nq=2, nkv=2, causal=True, kv_lengths=[5, 11]),
    "kv_starts": dict(nq=4, nkv=2, causal=True, kv_starts=[4, 0]),
    "q_offset": dict(nq=2, nkv=2, causal=True, q_offset=[2, 5], t=3),
}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_mha_plain_matches_mha_xla(case):
    c = dict(MHA_CASES[case])
    rng = np.random.default_rng(3)
    b, s, h = 2, 11, 16
    t = c.pop("t", s)
    q = _randn(rng, b, t, c.pop("nq"), h)
    nkv = c.pop("nkv")
    k, v = _randn(rng, b, s, nkv, h), _randn(rng, b, s, nkv, h)
    kw_j, kw_t = {}, {}
    for name in ("kv_lengths", "kv_starts", "q_offset"):
        if name in c:
            arr = np.asarray(c.pop(name), np.int32)
            kw_j[name], kw_t[name] = jnp.asarray(arr), _t(arr)
    ref = jattn.mha_xla(q, k, v, causal=c["causal"], **kw_j)
    out = tattn.mha_plain(_t(q), _t(k), _t(v), causal=c["causal"], **kw_t)
    _close(out, ref)


@pytest.mark.parametrize("t", [1, 3])
def test_mha_plain_cache_matches_mha_xla_cache(t):
    rng = np.random.default_rng(4)
    b, s, nq, nkv, h = 2, 16, 4, 2, 16
    q = _randn(rng, b, t, nq, h)
    ck, cv = _randn(rng, s, b, nkv, h), _randn(rng, s, b, nkv, h)
    ek, ev = _randn(rng, b, t, nkv, h), _randn(rng, b, t, nkv, h)
    starts = np.array([3, 0], np.int32)
    ref = jattn.mha_xla_cache(
        q, ck, cv, extra_k=ek, extra_v=ev, cache_len=9, kv_starts=jnp.asarray(starts)
    )
    out = tattn.mha_plain_cache(
        _t(q), _t(ck), _t(cv), extra_k=_t(ek), extra_v=_t(ev), cache_len=9,
        kv_starts=_t(starts),
    )
    _close(out, ref)


FLASH_CASES = {
    "h96_causal": dict(nq=2, nkv=2, h=96, causal=True),
    "h64_noncausal": dict(nq=2, nkv=2, h=64, causal=False),
    "gqa_4_2": dict(nq=4, nkv=2, h=64, causal=True),
    "kv_lengths": dict(nq=2, nkv=2, h=96, causal=False, kv_lengths=[100, 256]),
    "kv_starts": dict(nq=2, nkv=2, h=96, causal=True, kv_starts=[64, 0]),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_reference_matches_jax_flash(case):
    """The kernel's plain version vs the Pallas forward (interpret mode): out
    and lse on every valid row."""
    c = FLASH_CASES[case]
    rng = np.random.default_rng(5)
    b, t = 2, 256
    q = _randn(rng, b, t, c["nq"], c["h"])
    k = _randn(rng, b, t, c["nkv"], c["h"])
    v = _randn(rng, b, t, c["nkv"], c["h"])
    lens = np.asarray(c.get("kv_lengths", [t] * b), np.int32)
    starts = np.asarray(c.get("kv_starts", [0] * b), np.int32)
    out_j, lse_j = jflash._fwd(
        jnp.asarray(q).transpose(0, 2, 1, 3), jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3),
        jnp.asarray(lens) if "kv_lengths" in c else None,
        jnp.asarray(starts) if "kv_starts" in c else None,
        causal=c["causal"], scale=c["h"] ** -0.5, bq=128, bk=128, interpret=True,
    )
    out_j = np.asarray(out_j).transpose(0, 2, 1, 3)
    lse_j = np.asarray(lse_j)[..., 0]
    out_t, lse_t = tflash.flash_attention_fwd(
        _t(q), _t(k), _t(v), causal=c["causal"],
        kv_lengths=_t(lens) if "kv_lengths" in c else None,
        kv_starts=_t(starts) if "kv_starts" in c else None,
    )
    assert tuple(lse_t.shape) == (b, c["nq"], t) and lse_t.dtype == torch.float32
    for i in range(b):
        # valid rows: at or past kv_starts (left pad) and before kv_lengths (right pad)
        rows = slice(int(starts[i]), int(lens[i]))
        _close(out_t[i, rows], out_j[i, rows], atol=2e-5, rtol=2e-4)
        _close(lse_t[i, :, rows], lse_j[i, :, rows], atol=2e-5, rtol=2e-4)


def test_flash_reference_fully_masked_rows_have_neg_inf_lse():
    rng = np.random.default_rng(6)
    q, k, v = (_t(_randn(rng, 1, 128, 2, 64)) for _ in range(3))
    _, lse = tflash.flash_attention_reference(q, k, v, kv_starts=torch.tensor([40]))
    assert torch.all(lse[0, :, :40] == tflash.NEG_INF)
    assert torch.all(torch.isfinite(lse[0, :, 40:])) and torch.all(lse[0, :, 40:] > -1e30)


def test_dispatch_on_cpu_uses_plain_versions_and_counts_no_launch():
    """Eligible shapes on CPU tensors: use_kernel=None goes plain; forcing the
    kernel route on CPU reaches the wrapper, which takes the plain version and
    launches nothing."""
    rng = np.random.default_rng(7)
    q, k, v = (_t(_randn(rng, 2, 128, 2, 96)) for _ in range(3))
    starts = torch.tensor([0, 32])
    before = tflash.launches
    plain = tattn.multi_head_attention(q, k, v, kv_starts=starts)
    routed = tattn.multi_head_attention(q, k, v, kv_starts=starts, use_kernel=True)
    assert tflash.launches == before
    _close(routed[1, 32:], plain[1, 32:])
    _close(routed[0], plain[0])


REMAINDER_CASES = [
    # dtype, head dim, needs a gradient, taken by the hand-written kernels
    *[(torch.bfloat16, h, g, True) for h in (64, 96, 128) for g in (False, True)],
    *[(torch.float32, h, False, True) for h in (64, 96, 128)],
    *[(torch.float32, h, True, False) for h in (64, 96, 128)],     # no f32 backward kernel
    (torch.bfloat16, 192, False, False), (torch.bfloat16, 256, True, False),
    (torch.float32, 192, False, False), (torch.float16, 96, False, False),
    (torch.float16, 128, True, False), (torch.bfloat16, 80, False, False),
]


@pytest.mark.parametrize("dtype,h,needs_grad,taken", REMAINDER_CASES)
def test_flash_remainder_names_what_no_kernel_takes(dtype, h, needs_grad, taken):
    """The dispatcher's CUDA predicate: the kernels take bf16 and f32 forwards
    at head dims 64/96/128 and bf16 backwards; the remainder is named (and
    `multi_head_attention` raises for it on CUDA). On the CPU the flash
    Function runs the plain versions and takes every call, as JAX's dispatch
    does (test_dispatch_on_cpu_uses_plain_versions_and_counts_no_launch)."""
    why = tflash.flash_remainder(dtype, h, needs_grad)
    assert (why is None) == taken
    if taken and dtype == torch.bfloat16:
        assert tflash.flash_bwd_kernel_for(dtype, h, 256, 256) == "wgmma"
    if not taken:
        assert isinstance(why, str) and why


@pytest.mark.parametrize("h", [32, 64, 96, 128, 160, 192, 256])
def test_remainder_is_what_jax_admits_and_the_kernels_refuse(h):
    """JAX's eligibility admits head dims 96 and multiples of 64; of those the
    port's kernels take 64, 96 and 128, and the rest are named."""
    jax_eligible = h % 64 == 0 or h == 96
    kernel_takes = tflash.flash_remainder(torch.bfloat16, h, True) is None
    assert kernel_takes == (h in tflash.SUPPORTED_HEAD_DIMS)
    assert not kernel_takes or jax_eligible
