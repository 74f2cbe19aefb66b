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
    once, the longest first;
  * `flash_bwd_kernel_for` / `flash_bwd_tile_order` and the loops
    `flash_bwd_dq_visits` / `flash_bwd_dkv_visits` (B2/B3): every bf16 call at
    H 64/96/128 names the wgmma pair, both grids visit every tile once, the
    longest first, and every unmasked (q head, row, key) lies in exactly one
    visit of each loop, as it does in the JAX package's pair lists; the
    pair's tile arithmetic in torch (P and dS rounded to bf16 per tile, f32
    sums in visit order) is held to `flash_attention_bwd_reference` at the
    card's bound for the kernels;
  * `window_attn_plan` / `window_attn_ctas` (B4): at the Swin-L stage
    launches, the card tests' shapes and (64, 16) with nW in {1, W/2, W},
    every (window, head) lies in exactly one CTA, a CTA's windows share one
    head and, shifted, one mask index, its shared memory fits 227 KB, and no
    SM takes more than an even share of a Swin-L launch plus one window; the
    streamed kernel's arithmetic in torch (scale, + bias, + mask, ex2 with
    log2 e, P normalised then rounded to bf16) is held to the Pallas kernel
    in interpret mode (1e-2 absolute);
  * the ablation builds of chip_ablate_bwd.py: each switched call of the
    wgmma backward kernels and of both window kernels occurs as often as the
    script expects, and a renamed one stops the script instead of leaving a
    variant that is the full kernel.
"""

import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from visper_lm_tpu_torch.ops import decode_attention as tda
from visper_lm_tpu_torch.ops import _build
from visper_lm_tpu_torch.ops import flash_attention as tfa
from visper_lm_tpu_torch.ops import window_attention as twa

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


# --------------------------------------------------------------------------
# B2/B3: the wgmma backward pair's kernel choice, grids and loops
# --------------------------------------------------------------------------

BWD_LENGTHS = [1, 63, 64, 65, 127, 128, 129, 657, 1024, 2048]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,s", [(t, t) for t in BWD_LENGTHS] + [(200, 333), (333, 200), (1, 65)])
@pytest.mark.parametrize("h", tfa.SUPPORTED_HEAD_DIMS)
def test_every_supported_backward_shape_names_the_wgmma_pair(h, t, s, causal):
    name = tfa.flash_bwd_kernel_for(torch.bfloat16, h, t, s)
    assert name == "wgmma"                                   # the one pair; never the plain version


@pytest.mark.parametrize("dtype,h", [(torch.float32, 96), (torch.float16, 96), (torch.bfloat16, 80),
                                     (torch.bfloat16, 192), (torch.float32, 256)])
def test_unsupported_backward_shapes_raise(dtype, h):
    with pytest.raises(ValueError):
        tfa.flash_bwd_kernel_for(dtype, h, 1024, 1024)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 657, 1000, 1024, 2048, 4097])
def test_backward_grids_visit_every_tile_once_longest_first(n):
    dq = tfa.flash_bwd_tile_order("dq", n)
    assert sorted(dq) == list(range(-(-n // tfa.BWD_DQ_ROWS)))
    assert list(dq) == sorted(dq, reverse=True)        # a causal q tile's kv loop grows with its index
    dkv = tfa.flash_bwd_tile_order("dkv", n)
    assert sorted(dkv) == list(range(-(-n // tfa.BWD_DKV_KEYS)))
    assert list(dkv) == sorted(dkv)                    # a causal key tile's q loop shrinks with its index
    with pytest.raises(ValueError):
        tfa.flash_bwd_tile_order("dv", n)


def _unmasked(t, s, causal, length, start):
    """(T, S) booleans: the pairs `_recompute_p` leaves unmasked."""
    rows, cols = np.arange(t)[:, None], np.arange(s)[None, :]
    ok = (cols < min(length, s)) & (cols >= max(start, 0))
    return ok & (cols <= rows) if causal else ok & np.ones((t, 1), bool)


def _dq_counts(t, s, g, causal, length, start):
    counts = np.zeros((t, s), np.int32)
    for q0 in range(0, t, tfa.BWD_DQ_ROWS):
        for row0, tiles in tfa.flash_bwd_dq_visits(s, causal, length, start, q0):
            for k0 in tiles:
                counts[row0:row0 + tfa.WARPGROUP_ROWS, k0:k0 + tfa.BWD_DQ_KEYS] += 1
    return np.broadcast_to(counts, (g, t, s))           # every q head runs the same loop


def _dkv_counts(t, s, g, causal, length, start):
    counts = np.zeros((g, t, s), np.int32)
    for k0 in range(0, s, tfa.BWD_DKV_KEYS):
        for key0, visits in tfa.flash_bwd_dkv_visits(t, s, g, causal, length, start, k0):
            for gi, q0 in visits:
                counts[gi, q0:q0 + tfa.BWD_DKV_ROWS, key0:key0 + tfa.WARPGROUP_ROWS] += 1
    return counts


BWD_MASKS = [(None, None), ("len", None), ("len", "start")]


@pytest.mark.parametrize("masks", BWD_MASKS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 129, 657, 1024])
def test_backward_loops_cover_every_unmasked_pair_once(t, g, causal, masks):
    """Every unmasked (q head of the group, row, key) lies in exactly one
    visit of the dq loop and one of the dk/dv loop (so each gradient term is
    added once); T = S, and T != S on the side."""
    for s in (t, max(t // 2, 1) + 3):
        length = s if masks[0] is None else max(s - 70, 1)
        start = None if masks[1] is None else min(s // 3, length)
        need = np.broadcast_to(_unmasked(t, s, causal, length, 0 if start is None else start), (g, t, s))
        for counts in (_dq_counts(t, s, g, causal, length, start),
                       _dkv_counts(t, s, g, causal, length, start)):
            assert np.all(counts[need] == 1)
            assert np.all(counts <= 1)                 # no pair twice, masked or not


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("t", [64, 128, 256, 640, 1024])
def test_jax_backward_pairs_cover_every_causal_pair_once(t, g):
    """The same coverage for the JAX package's squashed grids
    (`_causal_pairs` for dq, `_kv_major_group_pairs` for dk/dv) at the block
    sizes its tests use: the port's loops replace them, pair for pair."""
    from visper_lm_tpu.ops import flash_attention as jflash

    bq, bk = jflash._block_sizes(t, t, 128, 128)
    need = np.broadcast_to(_unmasked(t, t, True, t, 0), (g, t, t))
    qi, kj, _ = jflash._causal_pairs(t // bq, t // bk, bq, bk)
    dq = np.zeros((t, t), np.int32)
    for a, c in zip(qi, kj):
        dq[a * bq:(a + 1) * bq, c * bk:(c + 1) * bk] += 1
    qi, kj, gi, _, _ = jflash._kv_major_group_pairs(t // bq, t // bk, bq, bk, g)
    dkv = np.zeros((g, t, t), np.int32)
    for a, c, h in zip(qi, kj, gi):
        dkv[h, a * bq:(a + 1) * bq, c * bk:(c + 1) * bk] += 1
    for counts in (np.broadcast_to(dq, (g, t, t)), dkv):
        assert np.all(counts[need] == 1) and np.all(counts <= 1)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate_bwd(q, k, v, dout, lse, delta, causal, lens, starts, scale):
    """The wgmma pair's tile arithmetic in torch (f32 in, bf16 out): each
    CTA's warpgroups over their visits in the kernels' order; P from the lse
    in the log2 domain (a dead row's lse is +inf); dS, and P for dv, rounded
    to bf16 before the products that take them from registers; f32 sums; dq
    and dk times the scale, all three rounded to bf16 once."""
    b, t, nq, h = q.shape
    s, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    c = scale * 1.4426950408889634
    dead = lse == tfa.NEG_INF
    lse2 = torch.where(dead, torch.full_like(lse, float("inf")), lse * 1.4426950408889634)
    dq, dk, dv = torch.zeros(q.shape), torch.zeros(k.shape), torch.zeros(v.shape)

    def p_and_ds(bi, head, rows, keys):
        ok = _unmasked(t, s, causal, int(lens[bi]), int(starts[bi]))[rows][:, keys]
        sc = q[bi, rows, head] @ k[bi, keys, head // g].T
        x = sc * c - lse2[bi, head, rows][:, None]
        p = torch.exp2(torch.where(torch.from_numpy(ok), x, torch.full_like(x, -float("inf"))))
        dp = dout[bi, rows, head] @ v[bi, keys, head // g].T
        return p, p * (dp - delta[bi, head, rows][:, None])

    for bi in range(b):
        ln, st = int(lens[bi]), int(starts[bi])
        for head in range(nq):
            for q0 in range(0, t, tfa.BWD_DQ_ROWS):
                for row0, tiles in tfa.flash_bwd_dq_visits(s, causal, ln, st, q0):
                    rows = np.arange(row0, min(row0 + tfa.WARPGROUP_ROWS, t))
                    acc = torch.zeros(len(rows), h)
                    for k0 in tiles:
                        keys = np.arange(k0, min(k0 + tfa.BWD_DQ_KEYS, s))
                        _, ds = p_and_ds(bi, head, rows, keys)
                        acc += _bf16(ds) @ k[bi, keys, head // g]
                    dq[bi, rows, head] = acc * scale
        for kvh in range(nkv):
            for k0 in range(0, s, tfa.BWD_DKV_KEYS):
                for key0, visits in tfa.flash_bwd_dkv_visits(t, s, g, causal, ln, st, k0):
                    keys = np.arange(key0, min(key0 + tfa.WARPGROUP_ROWS, s))
                    acc_k, acc_v = torch.zeros(len(keys), h), torch.zeros(len(keys), h)
                    for gi, q0 in visits:
                        rows = np.arange(q0, min(q0 + tfa.BWD_DKV_ROWS, t))
                        p, ds = p_and_ds(bi, kvh * g + gi, rows, keys)
                        acc_v += _bf16(p).T @ dout[bi, rows, kvh * g + gi]
                        acc_k += _bf16(ds).T @ q[bi, rows, kvh * g + gi]
                    dk[bi, keys, kvh] = acc_k * scale
                    dv[bi, keys, kvh] = acc_v
    return _bf16(dq), _bf16(dk), _bf16(dv)


BWD_EMULATION_CASES = {
    "mha_causal_pads": dict(t=200, s=200, nq=2, nkv=2, causal=True, lens=[200, 150], starts=[70, 0]),
    "gqa4_causal_whole_tiles_past_len": dict(t=300, s=300, nq=4, nkv=1, causal=True, lens=[300, 100],
                                             starts=[0, 0]),
    "gqa2_noncausal": dict(t=130, s=130, nq=4, nkv=2, causal=False, lens=[130, 61], starts=[0, 40]),
    "t_over_s_causal": dict(t=150, s=70, nq=2, nkv=1, causal=True, lens=[70, 70], starts=[0, 5]),
    "s_over_t_noncausal": dict(t=65, s=200, nq=2, nkv=2, causal=False, lens=[200, 129], starts=[3, 0]),
}


@pytest.mark.parametrize("case", sorted(BWD_EMULATION_CASES))
def test_backward_tile_arithmetic_matches_the_plain_version(case):
    """The emulation of the kernels' arithmetic against
    `flash_attention_bwd_reference` fed the plain forward's f32 out and lse,
    inputs rounded to bf16 as the kernels get them. Tolerance: the card's
    bound for the kernels (relative Frobenius error <= 1e-2, per element
    |err| <= 2e-2 + 1e-2 x |ref|: P and dS rounded to bf16, outputs in
    bf16); pad rows give dq = 0 and keys outside [start, length) dk = dv = 0
    exactly, as in the reference."""
    c = BWD_EMULATION_CASES[case]
    rng = np.random.default_rng(11)
    b, h = 2, 64
    q, dout = (_bf16(torch.from_numpy(rng.standard_normal((b, c["t"], c["nq"], h)).astype(np.float32)))
               for _ in range(2))
    k, v = (_bf16(torch.from_numpy(rng.standard_normal((b, c["s"], c["nkv"], h)).astype(np.float32)))
            for _ in range(2))
    lens, starts = torch.tensor(c["lens"]), torch.tensor(c["starts"])
    kw = dict(causal=c["causal"], kv_lengths=lens, kv_starts=starts)
    out, lse = tfa.flash_attention_reference(q, k, v, **kw)
    ref = tfa.flash_attention_bwd_reference(q, k, v, out, lse, dout, **kw)
    delta = (dout * out).sum(-1).transpose(1, 2)
    got = _emulate_bwd(q, k, v, dout, lse, delta, c["causal"], lens, starts, h ** -0.5)
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        err = (x - r).abs()
        assert (err.norm() / r.norm()).item() <= 1e-2, name
        assert (err - (2e-2 + 1e-2 * r.abs())).max().item() <= 0, name
    for i in range(b):
        lo, ln = c["starts"][i], min(c["lens"][i], c["s"])
        assert torch.all(got[1][i, :lo] == 0) and torch.all(got[2][i, ln:] == 0)
        if c["causal"]:
            assert torch.all(got[0][i, :lo] == 0)


def _ablate_script():
    path = Path(__file__).resolve().parent.parent / "chip_ablate_bwd.py"
    spec = importlib.util.spec_from_file_location("chip_ablate_bwd", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ablation_switches_every_product_and_ex2():
    abl = _ablate_script()
    src = (_build.CSRC / "flash_bwd.cu").read_text()
    got = abl.ablatable_source(src)
    cut = src.index("// bf16: TMA ring + wgmma")
    assert got[:cut] == src[:cut]                      # the mma.sync kernels untouched
    body = got[cut:]
    assert body.count("if (ABL_SS) wgmma_ss<") == body.count("wgmma_ss<") == 4
    assert body.count("if (ABL_RS) wgmma_rs<H>(") == body.count("wgmma_rs<H>(") == 3
    assert body.count("ABL_EX2 ? ex2(") == body.count("ex2(") == 2


@pytest.mark.parametrize("which", range(3))
def test_ablation_refuses_a_source_whose_calls_it_does_not_find(which):
    abl = _ablate_script()
    src = (_build.CSRC / "flash_bwd.cu").read_text()
    old = abl.SWITCHES[which][0]
    at = src.rindex(old)
    renamed = src[:at] + old.replace("(", " (").replace("<", " <") + src[at + len(old):]
    with pytest.raises(ValueError, match="occurs"):
        abl.ablatable_source(renamed)


# --------------------------------------------------------------------------
# B4: the streamed window kernel's plan and arithmetic
# --------------------------------------------------------------------------

SWIN_L_LAUNCHES = [(512, 6), (128, 12), (32, 24), (8, 48)]   # (W, heads) at 768 px, micro-batch 2
WINDOW_PLAN_CASES = (
    [(w, heads, 144, 32, nw) for w, heads in SWIN_L_LAUNCHES for nw in (0, w // 2)]
    # the card tests' shapes
    + [(32, 6, 144, 32, 16), (8, 48, 144, 32, 1), (8, 3, 64, 16, 4), (4, 2, 144, 32, 0)]
    + [(64, 5, 64, 16, nw) for nw in (0, 1, 32, 64)]
    + [(w, heads, 64, 16, nw) for w, heads in ((8, 3), (48, 7)) for nw in (1, w // 2, w)]
)


@pytest.mark.parametrize("sms", [132, 1, 16])
@pytest.mark.parametrize("w,heads,n,d,nw", WINDOW_PLAN_CASES)
def test_window_plan_visits_every_window_and_head_once(w, heads, n, d, nw, sms):
    """Every (window, head) lies in exactly one CTA; a CTA's windows share one
    head and, when shifted, one mask index, so it reads each once; its shared
    memory stays within the 227 KB a CTA may ask for."""
    plan = twa.window_attn_plan(w, heads, n, d, nw, sms)
    ctas = twa.window_attn_ctas(w, heads, nw, plan)
    assert len(ctas) == plan.grid[0] * plan.grid[1]
    seen = np.zeros((w, heads), np.int32)
    for head, windows in ctas:
        assert 1 <= len(windows) <= plan.windows_per_cta
        if nw:
            assert len({x % nw for x in windows}) == 1       # one mask index
        for x in windows:
            seen[x, head] += 1
    assert np.all(seen == 1)
    assert plan.smem_bytes == twa.window_attn_smem_bytes(n, d, nw > 0, plan.stages)
    assert plan.smem_bytes <= 227 * 1024
    assert 1 <= plan.stages <= min(twa.MAX_STAGES, plan.windows_per_cta)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("w,heads", SWIN_L_LAUNCHES)
def test_window_plan_fills_the_card_at_every_swin_l_stage(w, heads, shifted):
    """No SM takes more than one window beyond an even share of the launch,
    so reuse never leaves a stage with a long partial wave; bias and mask are
    read once for at least two windows where a CTA can hold two."""
    nw = w // 2 if shifted else 0
    plan = twa.window_attn_plan(w, heads, 144, 32, nw, 132)
    ctas = plan.grid[0] * plan.grid[1]
    waves = -(-ctas // 132)                                  # one CTA an SM
    assert waves * plan.windows_per_cta <= -(-w * heads // 132) + 1
    assert plan.windows_per_cta >= 2
    assert twa.window_attn_kernel_for(144, 32) == "streamed"


def test_window_plan_is_a_function_of_shapes_only():
    params = list(inspect.signature(twa.window_attn_plan.__wrapped__).parameters)
    assert params == ["w", "heads", "n", "d", "nw", "sms"]
    assert twa.window_attn_plan(32, 24, 144, 32, 16) == twa.window_attn_plan(32, 24, 144, 32, 16, 132)
    with pytest.raises(ValueError):
        twa.window_attn_plan(30, 24, 144, 32, 16)        # W not a multiple of nW
    with pytest.raises(ValueError):
        twa.window_attn_plan(32, 24, 128, 32, 0)         # no kernel at N 128
    for dtype, n, d in ((torch.float32, 144, 32), (torch.bfloat16, 49, 32), (torch.bfloat16, 144, 64)):
        with pytest.raises(ValueError):
            twa.window_attn_kernel_for(n, d, dtype)


def _emulate_window(q, k, v, bias, mask, scale, plan):
    """The streamed kernel's arithmetic in torch, CTA by CTA in the plan's
    order (f32 from bf16 inputs): S = q k^T, x = S * scale + bias, + mask;
    P = 2^(x log2 e - max log2 e), normalised in f32 by 1 / sum and rounded to
    bf16; O = P v in f32, rounded to bf16 once."""
    w, heads = q.shape[:2]
    nw = 0 if mask is None else mask.shape[0]
    out = torch.full(q.shape, float("nan"))
    for head, windows in twa.window_attn_ctas(w, heads, nw, plan):
        for x in windows:
            s = q[x, head].float() @ k[x, head].float().T
            s = s * scale + bias[head]
            if mask is not None:
                s = s + mask[x % nw]
            ml = s.amax(-1, keepdim=True) * 1.4426950408889634
            p = torch.exp2(s * 1.4426950408889634 - ml)
            p = _bf16(p * (1.0 / p.sum(-1, keepdim=True)))
            out[x, head] = _bf16(p @ v[x, head].float())
    return out


WINDOW_EMULATION_CASES = {
    "swin_l_shifted_runs": dict(w=8, heads=2, n=144, d=32, nw=4, sms=1),
    "swin_l_unshifted_runs": dict(w=6, heads=3, n=144, d=32, nw=0, sms=2),
    "test_shape_nw1": dict(w=8, heads=3, n=64, d=16, nw=1, sms=1),
    "test_shape_nw_w": dict(w=8, heads=3, n=64, d=16, nw=8, sms=132),
}


@pytest.mark.parametrize("case", sorted(WINDOW_EMULATION_CASES))
def test_window_kernel_arithmetic_matches_the_pallas_kernel(case):
    """The emulation against `window_attention_pallas(..., interpret=True)` on
    the same bf16 inputs, the model's (0 / -100) style of mask and runs of
    several windows per CTA (few SMs). Tolerance 1e-2 absolute: both round P
    and the output to bf16, after exp2 here and exp there; the card's bound
    against the plain version is 2e-2."""
    import jax.numpy as jnp
    from visper_lm_tpu.ops.window_attention import window_attention_pallas

    c = WINDOW_EMULATION_CASES[case]
    w, heads, n, d, nw = c["w"], c["heads"], c["n"], c["d"], c["nw"]
    rng = np.random.default_rng(7)
    q, k, v = (_bf16(torch.from_numpy(rng.standard_normal((w, heads, n, d)).astype(np.float32)))
               for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((heads, n, n)).astype(np.float32))
    mask = None
    if nw:
        mask = torch.from_numpy(rng.choice([0.0, -100.0], p=[0.7, 0.3], size=(nw, n, n)).astype(np.float32))
    scale = d ** -0.5
    plan = twa.window_attn_plan(w, heads, n, d, nw, c["sms"])
    got = _emulate_window(q, k, v, bias, mask, scale, plan)
    ref = window_attention_pallas(
        *(jnp.asarray(x.numpy()).astype(jnp.bfloat16) for x in (q, k, v)), jnp.asarray(bias.numpy()),
        None if mask is None else jnp.asarray(mask.numpy()), scale, interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert not torch.isnan(got).any()
    assert (got - ref).abs().max().item() <= 1e-2


def test_window_ablation_switches_both_kernels():
    """chip_ablate_bwd.py's window table: every product, read of bias and
    mask, exponential and cross-lane reduction of the window kernel (the
    streamed one, the source's only kernel) lies behind a switch, and
    nothing before the cut changes."""
    abl = _ablate_script()
    src = (_build.CSRC / "window_attn.cu").read_text()
    got = abl.ablatable_source(src, "window_attn")
    cut = src.index(abl.ABLATIONS["window_attn"].cut)
    assert got[:cut] == src[:cut]
    body = got[cut:]
    assert body.count("if (ABL_MMA) mma_bf16(") == body.count("mma_bf16(") == 4
    assert body.count("ABL_BIAS ? *reinterpret_cast<const float2*>(bias + off)") == 1
    assert body.count("if (ABL_BIAS && mask) {") == 1 and "if (mask) {" not in body
    assert "expf(" not in body and "window_attn_bf16_kernel" not in src
    assert body.count("ABL_SOFTMAX ? ex2(") == body.count("ex2(") == 1
    assert body.count("if (ABL_SOFTMAX)") == body.count("__shfl_xor_sync(") == 4


@pytest.mark.parametrize("which", range(len(_ablate_script().WINDOW_SWITCHES)))
def test_window_ablation_refuses_a_source_whose_calls_it_does_not_find(which):
    abl = _ablate_script()
    src = (_build.CSRC / "window_attn.cu").read_text()
    old = abl.WINDOW_SWITCHES[which][0]
    at = src.rindex(old)
    renamed = src[:at] + old.replace("(", " (").replace("<", " <") + src[at + len(old):]
    with pytest.raises(ValueError, match="occurs"):
        abl.ablatable_source(renamed, "window_attn")
