"""Host-side planning of the port's redesigned attention kernels, on the CPU.

The kernels themselves run only on the card (tests/test_torch_kernels_cuda.py);
what decides their grids is plain Python and is held here:

  * `decode_split_plan` (B6): every position of S lies in exactly one split,
    the plan is a function of shapes only, it fits the cluster and the shared
    memory the kernel may ask for;
  * the split arithmetic itself: per-split (max, sum, acc) over the clipped
    span, merged in split order, written here in torch from the plan and held
    to `decode_attention_reference` (f32, tolerance 2e-5: the sums run in
    another order), with splits that hold no valid position and a row that
    holds none;
  * `flash_fwd_kernel_for` / `flash_fwd_tile_order` (B1): every supported
    (dtype, head dim, length, causal) names a hand-written kernel, nothing is
    left to the kernel kept for timing, and the grid visits every query tile
    once, the longest first.
"""

import inspect

import numpy as np
import pytest
import torch

from visper_lm_tpu_torch.ops import decode_attention as tda
from visper_lm_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

DECODE_SHAPES = [
    # b, nkv, s, h, elem_bytes
    (8, 32, 896, 96, 1), (8, 32, 896, 96, 2),       # the serving decode shape, int8 and bf16
    (4, 8, 1024, 128, 2), (4, 8, 1024, 128, 1),
    (3, 8, 33, 64, 2), (3, 2, 224, 96, 1), (1, 1, 4096, 96, 1), (2, 4, 4096, 128, 2),
    (1, 1, 1, 64, 1), (1, 1, 31, 64, 2), (64, 32, 8192, 128, 2), (5, 3, 300, 96, 2),
]


@pytest.mark.parametrize("b,nkv,s,h,eb", DECODE_SHAPES)
def test_decode_split_plan_covers_every_position_once(b, nkv, s, h, eb):
    span, splits, rnd = tda.decode_split_plan(b, nkv, s, h, eb)
    owner = np.full(s, -1)
    for i in range(splits):
        lo, hi = i * span, min((i + 1) * span, s)
        assert lo < hi, "no split is empty by shape"
        assert np.all(owner[lo:hi] == -1)
        owner[lo:hi] = i
    assert np.all(owner >= 0)
    assert 1 <= splits <= tda.SPLIT_MAX_SPLITS
    assert span % tda.SPLIT_POS_STEP == 0 and rnd % tda.SPLIT_POS_STEP == 0
    assert 0 < rnd <= span
    # rounds start on multiples of 4 positions (16-byte scale copies) and a
    # CTA's slabs stay far below an SM's shared memory
    assert tda.decode_split_smem_bytes(rnd, h, eb, 4) <= 64 * 1024


@pytest.mark.parametrize("b,nkv,s,h,eb", DECODE_SHAPES[:6])
def test_decode_split_plan_is_a_function_of_shapes_only(b, nkv, s, h, eb):
    params = list(inspect.signature(tda.decode_split_plan.__wrapped__).parameters)
    assert params == ["b", "nkv", "s", "h", "elem_bytes"]      # no tensor reaches it
    assert tda.decode_split_plan(b, nkv, s, h, eb) == tda.decode_split_plan(b, nkv, s, h, eb)
    assert all(isinstance(x, int) for x in tda.decode_split_plan(b, nkv, s, h, eb))


def test_decode_split_plan_at_the_serving_shape_fills_the_card():
    for eb in (1, 2):
        span, splits, rnd = tda.decode_split_plan(8, 32, 896, 96, eb)
        assert 8 * 32 * splits >= 8 * 132          # at least eight CTAs for each SM
        assert span <= 2 * rnd                     # at most two rounds
        assert 8 * tda.decode_split_smem_bytes(rnd, 96, eb, 1) <= 227 * 1024   # and eight fit one


def _split_decode(q, k, v, ks, vs, lens, starts, plan):
    """The split kernel's arithmetic in torch: each split's (max, sum, acc)
    over its span clipped to [start, length), rounds of `rnd` positions with an
    online softmax between them, merged in split order in the log2 domain."""
    span, splits, rnd = plan
    b, _, nq, h = q.shape
    nkv, s_len = k.shape[1], k.shape[2]
    g = nq // nkv
    qf = q.float().reshape(b, nkv, g, h) * (h ** -0.5 * 1.4426950408889634)
    out = torch.zeros(b, nkv, g, h)
    for bi in range(b):
        ln, lo = min(int(lens[bi]), s_len), max(int(starts[bi]), 0)
        parts = []
        for sp in range(splits):
            p0, p1 = max(sp * span, lo), min((sp + 1) * span, ln)
            m = torch.full((nkv, g), -float("inf"))
            l = torch.zeros(nkv, g)
            acc = torch.zeros(nkv, g, h)
            r0 = p0 & ~3
            while p1 > p0 and r0 < p1:
                a, e = max(r0, p0), min(r0 + rnd, p1)
                x = torch.einsum("kgh,ksh->kgs", qf[bi], k[bi, :, a:e].float())
                if ks is not None:
                    x = x * ks[bi, :, None, a:e]
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp2(m - m_new))
                pr = torch.exp2(x - m_new[..., None])
                l = l * alpha + pr.sum(-1)
                pv = pr * vs[bi, :, None, a:e] if vs is not None else pr
                acc = acc * alpha[..., None] + torch.einsum("kgs,ksh->kgh", pv, v[bi, :, a:e].float())
                m = m_new
                r0 += rnd
            parts.append((m, l, acc))
        mx = torch.stack([p[0] for p in parts]).amax(0)
        lsum, a = torch.zeros(nkv, g), torch.zeros(nkv, g, h)
        for m, l, acc in parts:                       # split order
            f = torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp2(m - mx))
            lsum, a = lsum + l * f, a + acc * f[..., None]
        out[bi] = torch.where(lsum[..., None] > 0, a / lsum.clamp(min=1e-30)[..., None], torch.zeros_like(a))
    return out.reshape(b, 1, nq, h)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("plan", [None, (32, 8, 16), (48, 5, 48), (128, 2, 32)])
def test_split_arithmetic_matches_the_plain_version(quant, plan):
    """S = 224 with lengths and starts that leave whole splits empty, a start
    in the middle of a round, and a row with no valid position."""
    from visper_lm_tpu_torch.models.decoder import quantize_head_vectors

    rng = np.random.default_rng(3)
    b, nq, nkv, h, s = 4, 4, 2, 32, 224
    q = torch.from_numpy(rng.standard_normal((b, 1, nq, h)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, nkv, s, h)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, nkv, s, h)).astype(np.float32))
    ks = vs = None
    if quant:
        (k, ks), (v, vs) = quantize_head_vectors(k), quantize_head_vectors(v)
        ks, vs = ks[..., 0], vs[..., 0]
    lens = torch.tensor([224, 40, 100, 131])
    starts = torch.tensor([0, 5, 100, 67])
    if plan is None:
        plan = tda.decode_split_plan(b, nkv, s, h, k.element_size())
    assert plan[0] * plan[1] >= s
    got = _split_decode(q, k, v, ks, vs, lens, starts, plan)
    ref = tda.decode_attention_reference(q, k, v, ks, vs, kv_lengths=lens, kv_starts=starts)
    assert torch.all(got[2] == 0) and torch.all(ref[2] == 0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)


def test_decode_attention_rejects_an_unknown_kernel_name_only_on_cuda():
    """On the CPU the plain version runs whatever `kernel` says: the name
    selects among CUDA kernels and is checked where one would be launched."""
    q, k = torch.zeros(1, 1, 2, 64), torch.zeros(1, 2, 16, 64)
    out = tda.decode_attention(q, k, k, kv_lengths=torch.tensor([16]), kernel="split")
    assert out.shape == q.shape
    assert set(tda.KERNEL_IDS) == {"serial", "split"}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [1, 100, 128, 129, 768, 1024, 2048, 4096])
@pytest.mark.parametrize("h", tfa.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype", tfa.SUPPORTED_DTYPES)
def test_every_supported_forward_shape_names_a_kernel(dtype, h, t, causal):
    name = tfa.flash_fwd_kernel_for(dtype, h, t, causal)
    assert name in tfa.KERNEL_IDS
    assert tfa.KERNEL_DTYPES[name] == dtype
    # the kernel kept to be timed beside the new one takes no shape
    assert name == ("wgmma" if dtype == torch.bfloat16 else "simt")


@pytest.mark.parametrize("scale", [0.0, -0.125])
@pytest.mark.parametrize("h", tfa.SUPPORTED_HEAD_DIMS)
def test_the_named_remainder_is_a_scale_that_is_not_positive(h, scale):
    """The wgmma kernel takes the row max before it scales, so a scale <= 0
    stays with the mma.sync kernel; a positive one never does."""
    assert tfa.flash_fwd_kernel_for(torch.bfloat16, h, 768, True, scale) == "mma_sync"
    assert tfa.flash_fwd_kernel_for(torch.bfloat16, h, 768, True, h ** -0.5) == "wgmma"
    assert tfa.flash_fwd_kernel_for(torch.float32, h, 768, True, scale) == "simt"


@pytest.mark.parametrize("dtype,h", [(torch.float16, 96), (torch.bfloat16, 80), (torch.float32, 256)])
def test_unsupported_forward_shapes_raise(dtype, h):
    with pytest.raises(ValueError):
        tfa.flash_fwd_kernel_for(dtype, h, 128, True)


@pytest.mark.parametrize("t", [1, 127, 128, 129, 255, 256, 257, 768, 1000, 1024, 2048, 4096, 5000, 8192])
def test_tile_order_visits_every_query_tile_once_longest_first(t):
    order = tfa.flash_fwd_tile_order(t)
    ntiles = -(-t // tfa.WGMMA_Q_TILE)
    assert sorted(order) == list(range(ntiles))
    assert list(order) == sorted(order, reverse=True)     # a causal tile's length grows with its index
    assert (ntiles - 1) * tfa.WGMMA_Q_TILE < t <= ntiles * tfa.WGMMA_Q_TILE


def test_forward_on_the_cpu_ignores_the_kernel_name_and_counts_no_launch():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 64)).astype(np.float32))
    before = tfa.launches
    out, lse = tfa.flash_attention_fwd(q, q, q, kernel="wgmma")
    ref, lse_ref = tfa.flash_attention_reference(q, q, q)
    assert tfa.launches == before
    assert torch.equal(out, ref) and torch.equal(lse, lse_ref)
