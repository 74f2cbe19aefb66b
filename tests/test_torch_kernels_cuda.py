"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and skips
without one. This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Tolerances (max abs error on rows with at least one valid key, against the
plain version computed in f32): bf16 2e-2, f32 1e-4; lse 1e-3. Backward
(bf16 only; dq, dk, dv against `flash_attention_bwd_reference` fed the plain
forward's f32 out and lse): relative Frobenius error 1e-2 and, per element,
|err| <= 2e-2 + 1e-2 x |ref|; the same launch repeated gives the same bytes. Window attention: bf16 2e-2
(the kernel against the plain version); the same launch repeated gives the
same bytes. w4 matmul (bf16
out against `w4_matmul_reference` in f32): relative Frobenius error 1e-2 and
max abs error 2e-2 x max|ref|; the same small-M launch repeated gives the
same bytes. Decode attention (bf16 q; bf16 or int8
cache): relative Frobenius error 1e-2 and max abs error 5e-3 on rows with a
valid key; a row with none is exactly 0; the same launch repeated gives the
same bytes (the splits merge in split order).
"""

import pytest
import torch

from visper_lm_tpu_torch.models.decoder import quantize_head_vectors
from visper_lm_tpu_torch.ops import attention as attn
from visper_lm_tpu_torch.ops import decode_attention as da
from visper_lm_tpu_torch.ops import flash_attention as fa
from visper_lm_tpu_torch.ops import quant_matmul as qm
from visper_lm_tpu_torch.ops import window_attention as wa
from visper_lm_tpu_torch.utils.param import QuantLinear, quantize_linear_int4

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, b, t, nq, nkv, h, dtype):
    def r(n):
        return torch.randn(b, t, n, h, device="cuda", generator=gen).to(dtype)

    return r(nq), r(nkv), r(nkv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "h,nq,nkv,causal", [(96, 4, 4, True), (128, 4, 2, True), (64, 2, 2, False)]
)
def test_flash_kernel_matches_plain(cuda_gen, dtype, h, nq, nkv, causal):
    b, t = 2, 384
    q, k, v = _qkv(cuda_gen, b, t, nq, nkv, h, dtype)
    starts = torch.tensor([70, 0], device="cuda")
    lens = torch.tensor([t, 300], device="cuda")
    kw = dict(causal=causal, kv_starts=starts, kv_lengths=lens)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref, lse_ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for i in range(b):
        lo = int(starts[i]) if causal else 0
        assert (out[i, lo:].float() - ref[i, lo:]).abs().max().item() <= tol
        assert (lse[i, :, lo:] - lse_ref[i, :, lo:]).abs().max().item() <= 1e-3
    if causal:
        assert torch.all(out[0, :70] == 0)
        assert torch.all(lse[0, :, :70] == fa.NEG_INF)


def test_flash_kernel_ragged_lengths_and_strided_inputs(cuda_gen):
    """T not a multiple of the tile sizes, and q/k/v as strided views of one
    packed (B, T, 3, N, H) tensor: the kernel reads through the strides."""
    b, t, n, h = 2, 200, 4, 96
    qkv = torch.randn(b, t, 3, n, h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = fa.flash_attention(q, k, v, causal=True)
    ref, _ = fa.flash_attention_reference(q.float(), k.float(), v.float(), causal=True)
    torch.cuda.synchronize()
    assert (out.float() - ref).abs().max().item() <= 2e-2


def _assert_flash_close(out, lse, q, k, v, starts, lens, causal):
    kw = dict(causal=causal, kv_starts=starts, kv_lengths=lens)
    ref, lse_ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    for i in range(q.shape[0]):
        lo = int(starts[i]) if (causal and starts is not None) else 0
        assert (out[i, lo:].float() - ref[i, lo:]).abs().max().item() <= 2e-2
        assert (lse[i, :, lo:] - lse_ref[i, :, lo:]).abs().max().item() <= 1e-3
        if lo:
            assert torch.all(out[i, :lo] == 0)
            assert torch.all(lse[i, :, :lo] == fa.NEG_INF)


@pytest.mark.parametrize("kernel", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("t", [128, 200, 768, 2048])
@pytest.mark.parametrize("h,nq,nkv", [(64, 4, 4), (96, 4, 4), (128, 8, 2), (96, 32, 8)])
def test_flash_bf16_kernels_across_lengths_and_heads(cuda_gen, kernel, t, h, nq, nkv):
    """Both bf16 kernels (the wgmma one every call takes, and the mma.sync one
    kept beside it) at T 128...2048 (200 is ragged against both tile sizes),
    H 64/96/128, GQA 32/8 and 8/2, causal with left pads that start in the
    middle of a 128-key tile (70, 333 capped to T) and a right pad: pad rows
    give 0 and NEG_INF."""
    b = 2
    q, k, v = _qkv(cuda_gen, b, t, nq, nkv, h, torch.bfloat16)
    starts = torch.tensor([min(70, t // 2), 0], device="cuda")
    lens = torch.tensor([t, max(t - 45, 1)], device="cuda")
    assert fa.flash_fwd_kernel_for(q.dtype, h, t, True) == "wgmma"
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, kv_starts=starts, kv_lengths=lens, kernel=kernel)
    _assert_flash_close(out, lse, q, k, v, starts, lens, True)
    starts = torch.tensor([0, min(333, t - 1)], device="cuda")
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, kv_starts=starts, kernel=kernel)
    _assert_flash_close(out, lse, q, k, v, starts, None, True)


def test_flash_kernel_at_the_llama3_serving_prefill(cuda_gen):
    """Llama-3-8B's served prefill: B8 x T768, GQA 32/8 at H128, causal, the
    chat batch's left pads (offsets up to 190, mid-tile)."""
    b, t = 8, 768
    q, k, v = _qkv(cuda_gen, b, t, 32, 8, 128, torch.bfloat16)
    starts = torch.tensor([0, 17, 64, 100, 127, 128, 150, 190], device="cuda")
    assert fa.flash_fwd_kernel_for(q.dtype, 128, t, True) == "wgmma"
    before = fa.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, kv_starts=starts)
    assert fa.launches == before + 1
    _assert_flash_close(out, lse, q, k, v, starts, None, True)


@pytest.mark.parametrize("h", [64, 96, 128])
def test_flash_wgmma_noncausal_with_kv_lengths(cuda_gen, h):
    """Non-causal attention (the vision towers' kind) with kv_lengths that end
    inside a tile, at one (300: every query row sees 300 keys) and before the
    first tile's end (17)."""
    b, t = 3, 520
    q, k, v = _qkv(cuda_gen, b, t, 4, 2, h, torch.bfloat16)
    lens = torch.tensor([520, 300, 17], device="cuda")
    out, lse = fa.flash_attention_fwd(q, k, v, causal=False, kv_lengths=lens)
    _assert_flash_close(out, lse, q, k, v, None, lens, False)


def test_flash_wgmma_reads_strided_views_and_single_row_batches(cuda_gen):
    """q/k/v as views of one packed (B, T, 3, N, H) tensor and of a wider
    (B, T, N, 2H) one (the tensor maps carry the strides; nothing is copied),
    a B = 1, N = 1 tensor whose unit dimensions carry arbitrary strides, and a
    different number of query and key rows (T 200 over S 333, non-causal)."""
    b, t, n, h = 2, 300, 4, 96
    qkv = torch.randn(b, t, 3, n, h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    _assert_flash_close(out, lse, q, k, v, None, None, True)
    wide = torch.randn(b, t, n, 2 * h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    q2, k2 = wide[..., :h], wide[..., h:]
    out, lse = fa.flash_attention_fwd(q2, k2, v, causal=True)
    _assert_flash_close(out, lse, q2, k2, v, None, None, True)
    one = torch.randn(1, 150, 1, h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    one = one.as_strided(one.shape, (8, h, 24, 1))        # unit dims with odd (unused) strides
    out, lse = fa.flash_attention_fwd(one, one, one, causal=True)
    _assert_flash_close(out, lse, one, one, one, None, None, True)
    qs = torch.randn(b, 200, n, h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    ks_ = torch.randn(b, 333, n, h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    vs_ = torch.randn(b, 333, n, h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    out, lse = fa.flash_attention_fwd(qs, ks_, vs_, causal=False)
    _assert_flash_close(out, lse, qs, ks_, vs_, None, None, False)


@pytest.mark.parametrize("h", [64, 96, 128])
@pytest.mark.parametrize("t,s", [(1, 1), (7, 7), (63, 200), (65, 65), (129, 64), (300, 1)])
def test_flash_wgmma_edge_lengths(cuda_gen, h, t, s):
    """Fewer rows than a tile (the TMA box is larger than the tensor), one
    row, T != S in both directions (causal compares column <= row without an
    offset, as the kernel before it), a batch row with kv_lengths 0 and one
    whose start lies at or beyond its length: both give 0 and NEG_INF."""
    b, n = 3, 2
    q = torch.randn(b, t, n, h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    k = torch.randn(b, s, n, h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    v = torch.randn(b, s, n, h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    lens = torch.tensor([s, 0, max(s // 2, 1)], device="cuda")
    starts = torch.tensor([0, 0, max(s // 2, 1)], device="cuda")
    for causal in (True, False):
        kw = dict(causal=causal, kv_starts=starts, kv_lengths=lens)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        old, lse_old = fa.flash_attention_fwd(q, k, v, kernel="mma_sync", **kw)
        ref, lse_ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert (out[0].float() - ref[0]).abs().max().item() <= 2e-2
        assert (lse[0] - lse_ref[0]).abs().max().item() <= 1e-3
        for i in (1, 2):                                   # no valid key in the row
            assert torch.all(out[i] == 0) and torch.all(lse[i] == fa.NEG_INF)
        assert (out.float() - old.float()).abs().max().item() <= 2e-2
        assert torch.equal(lse == fa.NEG_INF, lse_old == fa.NEG_INF)


def test_flash_forced_kernel_rejects_a_dtype_it_does_not_take(cuda_gen):
    q, k, v = _qkv(cuda_gen, 1, 128, 2, 2, 96, torch.float32)
    before = fa.launches
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, v, kernel="wgmma")
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), kernel="simt")
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, v, kernel="tiles")
    assert fa.launches == before


def test_flash_kernel_counts_launches_and_rejects_what_it_cannot_run(cuda_gen):
    q, k, v = _qkv(cuda_gen, 1, 128, 2, 2, 96, torch.bfloat16)
    before = fa.launches
    fa.flash_attention(q, k, v)
    assert fa.launches == before + 1
    # inputs that need a gradient take the forward kernel too (the autograd
    # Function), and only backward() launches the two backward kernels
    fa.flash_attention(q.clone().requires_grad_(True), k, v)
    assert fa.launches == before + 2
    before += 1
    with pytest.raises(ValueError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :80].contiguous(), k[..., :80].contiguous(),
                           v[..., :80].contiguous())
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), v)
    assert fa.launches == before + 1


def _assert_grad_close(got, ref, name):
    """Relative Frobenius error <= 1e-2 (no bulk of rows may be off), and
    per element |err| <= 2e-2 + 1e-2 x |ref| (bf16 rounding of the largest)."""
    err = (got.float() - ref.float()).abs()
    fro = (err.norm() / ref.float().norm()).item()
    assert fro <= 1e-2, f"{name}: relative Frobenius err {fro}"
    excess = (err - (2e-2 + 1e-2 * ref.float().abs())).max().item()
    assert excess <= 0, f"{name}: max abs err {err.max().item()} exceeds its bound by {excess}"


@pytest.mark.parametrize(
    "h,nq,nkv,causal", [(96, 4, 4, True), (128, 4, 2, True), (64, 2, 2, False)]
)
def test_flash_backward_kernels_match_plain(cuda_gen, h, nq, nkv, causal):
    b, t = 2, 320
    q, k, v = _qkv(cuda_gen, b, t, nq, nkv, h, torch.bfloat16)
    starts = torch.tensor([70, 0], device="cuda")
    lens = torch.tensor([t, 250], device="cuda")
    kw = dict(causal=causal, kv_starts=starts, kv_lengths=lens)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    dout = torch.randn(out.shape, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    d0, k0 = fa.dq_launches, fa.dkv_launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert (fa.dq_launches, fa.dkv_launches) == (d0 + 1, k0 + 1)
    qf, kf, vf = q.float(), k.float(), v.float()
    out_ref, lse_ref = fa.flash_attention_reference(qf, kf, vf, **kw)
    ref = fa.flash_attention_bwd_reference(qf, kf, vf, out_ref, lse_ref, dout.float(), **kw)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        _assert_grad_close(g, r, name)
    if causal:
        assert torch.all(got[0][0, :70] == 0)  # rows with no valid key
    with pytest.raises(ValueError):           # the backward kernels take bf16 only
        fa.flash_attention_bwd(qf, kf, vf, out_ref, lse_ref, dout.float(), **kw)
    assert (fa.dq_launches, fa.dkv_launches) == (d0 + 1, k0 + 1)


def _assert_bwd_close(got, ref, name):
    """`_assert_grad_close`, but for a gradient that is zero in exact
    arithmetic (every row with one valid key: dS = P (dP - delta) = 0, so dq
    = dk = 0) its relative error is one of rounding noise, and the
    per-element bound alone holds it."""
    ref = ref.float()
    if ref.norm().item() > 1e-3 * ref.numel() ** 0.5:
        _assert_grad_close(got, ref, name)
        return
    excess = ((got.float() - ref).abs() - (2e-2 + 1e-2 * ref.abs())).max().item()
    assert excess <= 0, f"{name}: exceeds 2e-2 + 1e-2 x |ref| by {excess}"


def _bwd_against_plain(q, k, v, dout, kw):
    """Both backward kernels (the pair `flash_attention_bwd` takes) vs the
    plain backward fed the plain forward's f32 out and lse (the reference
    shares nothing with the kernels); returns the kernels' (dq, dk, dv)."""
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    d0, k0 = fa.dq_launches, fa.dkv_launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert (fa.dq_launches, fa.dkv_launches) == (d0 + 1, k0 + 1)
    qf, kf, vf = q.float(), k.float(), v.float()
    out_ref, lse_ref = fa.flash_attention_reference(qf, kf, vf, **kw)
    ref = fa.flash_attention_bwd_reference(qf, kf, vf, out_ref, lse_ref, dout.float(), **kw)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        assert torch.isfinite(g).all(), name
        _assert_bwd_close(g, r, name)
    return got


BWD_LENGTHS = [1, 63, 64, 65, 127, 128, 129, 657, 1024, 2048]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("nq,nkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("h", [64, 96, 128])
@pytest.mark.parametrize("t", BWD_LENGTHS)
def test_flash_bwd_wgmma_across_lengths(cuda_gen, t, h, nq, nkv, causal):
    """The wgmma pair every call takes, at T = S from one row to 2048 (ragged
    against the 64- and 128-row tiles on both sides), G 1 and 4, causal and
    not, with a batch row whose kv_lengths end inside a tile and leave whole
    128-key tiles past it (their dk/dv must be written as zeros)."""
    assert fa.flash_bwd_kernel_for(torch.bfloat16, h, t, t) == "wgmma"
    b = 2
    q, k, v = _qkv(cuda_gen, b, t, nq, nkv, h, torch.bfloat16)
    dout = torch.randn(q.shape, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    lens = torch.tensor([t, max(t // 3, 1)], device="cuda")
    kw = dict(causal=causal, kv_lengths=lens)
    dq, dk, dv = _bwd_against_plain(q, k, v, dout, kw)
    cut = int(lens[1])
    assert torch.all(dk[1, cut:] == 0) and torch.all(dv[1, cut:] == 0)


@pytest.mark.parametrize("h", [64, 96, 128])
@pytest.mark.parametrize("t,s", [(200, 333), (333, 200), (65, 1), (1, 65), (129, 64)])
def test_flash_bwd_wgmma_t_differs_from_s(cuda_gen, h, t, s):
    """T != S both ways (causal compares column <= row without an offset, as
    the forward), causal and not, GQA 8/2."""
    b, nq, nkv = 2, 8, 2
    q = torch.randn(b, t, nq, h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    k = torch.randn(b, s, nkv, h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    v = torch.randn(b, s, nkv, h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    dout = torch.randn(q.shape, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    for causal in (True, False):
        _bwd_against_plain(q, k, v, dout, dict(causal=causal))


@pytest.mark.parametrize("h,nq,nkv", [(64, 4, 4), (96, 32, 8), (128, 8, 2)])
def test_flash_bwd_pads_before_kv_starts(cuda_gen, h, nq, nkv):
    """Left pads that start inside a tile (70) and cover whole tiles (333),
    with a right pad, a batch row whose start lies beyond its length and one
    with kv_lengths 0: rows before kv_starts have no valid key (dq = 0) and
    keys outside [kv_starts, kv_lengths) get no share (dk = dv = 0)."""
    b, t = 5, 768
    q, k, v = _qkv(cuda_gen, b, t, nq, nkv, h, torch.bfloat16)
    dout = torch.randn(q.shape, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    starts = torch.tensor([70, 333, 0, 500, 0], device="cuda")
    lens = torch.tensor([t, 700, 600, 400, 0], device="cuda")
    for causal in (True, False):
        kw = dict(causal=causal, kv_starts=starts, kv_lengths=lens)
        dq, dk, dv = _bwd_against_plain(q, k, v, dout, kw)
        for i in range(b):
            lo, ln = int(starts[i]), int(lens[i])
            if causal:
                assert torch.all(dq[i, :lo] == 0)
            assert torch.all(dk[i, :lo] == 0) and torch.all(dv[i, :lo] == 0)
            assert torch.all(dk[i, ln:] == 0) and torch.all(dv[i, ln:] == 0)
        for i in (3, 4):                        # no valid pair in the row at all
            assert torch.all(dq[i] == 0) and torch.all(dk[i] == 0) and torch.all(dv[i] == 0)


def test_flash_bwd_wgmma_strided_views_of_a_packed_qkv(cuda_gen):
    """q/k/v (and the cotangent) as strided views: the tensor maps carry the
    strides, nothing is copied. A cotangent whose rows are not 16-byte
    aligned is copied first and gives the same gradients."""
    b, t, n, h = 2, 300, 4, 96
    qkv = torch.randn(b, t, 3, n, h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    wide = torch.randn(b, t, n, 2 * h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    dout = wide[..., h:]
    lens = torch.tensor([300, 211], device="cuda")
    _bwd_against_plain(q, k, v, dout, dict(causal=True, kv_lengths=lens))
    flat = torch.randn(dout.numel() + 1, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    shifted = flat[1:].view(dout.shape)                 # 2 bytes past an aligned start
    assert shifted.data_ptr() % 16
    _bwd_against_plain(q, k, v, shifted, dict(causal=True, kv_lengths=lens))
    ones = [torch.randn(1, 150, 1, h, device="cuda", generator=cuda_gen).to(torch.bfloat16)
            for _ in range(4)]
    ones = [x.as_strided(x.shape, (8, h, 24, 1)) for x in ones]   # unit dims with odd (unused) strides
    _bwd_against_plain(*ones, dict(causal=True))


@pytest.mark.parametrize("b,t,nq,nkv,h", [(4, 1024, 32, 32, 96), (2, 1024, 32, 8, 128), (2, 200, 4, 4, 64)])
def test_flash_bwd_wgmma_launch_is_bit_identical(cuda_gen, b, t, nq, nkv, h):
    """Every dq, dk and dv element is written once by one CTA, with no
    atomics: the same launch 20 times gives the same bytes."""
    q, k, v = _qkv(cuda_gen, b, t, nq, nkv, h, torch.bfloat16)
    dout = torch.randn(q.shape, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    kw = dict(causal=True, kv_lengths=torch.tensor([max(t - 300, 1)] + [t] * (b - 1), device="cuda"))
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    for _ in range(20):
        assert torch.equal(fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw), dq)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
        assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


def test_flash_bwd_rejects_what_it_cannot_run(cuda_gen):
    q, k, v = _qkv(cuda_gen, 1, 128, 2, 2, 96, torch.bfloat16)
    out, lse = fa.flash_attention_fwd(q, k, v)
    dout = torch.randn(q.shape, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    before = (fa.dq_launches, fa.dkv_launches)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_dkv(q.float(), k.float(), v.float(), dout, lse, delta)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_dq(q.float(), k.float(), v.float(), dout, lse, delta)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_dq(q[..., :80], k[..., :80], v[..., :80], dout[..., :80], lse, delta)
    assert (fa.dq_launches, fa.dkv_launches) == before


@pytest.mark.parametrize(
    "dtype,h", [(torch.float32, 96), (torch.bfloat16, 192), (torch.float32, 256), (torch.float16, 128)]
)
def test_dispatcher_raises_for_what_the_kernels_do_not_take(cuda_gen, dtype, h):
    """An eligible call that no hand-written kernel takes (an f32 input that
    needs a gradient: no backward kernel takes f32; f16; head dims 192/256)
    raises in multi_head_attention before the forward runs, with no kernel
    launch. Asked for with use_kernel=False, the plain path trains it with
    the gradients of autograd through mha_plain."""
    b, t, n = 2, 256, 2
    q, k, v = _qkv(cuda_gen, b, t, n, n, h, dtype)
    lens = torch.tensor([256, 190], device="cuda")
    why = fa.flash_remainder(dtype, h, True)
    assert why is not None
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    with pytest.raises(ValueError, match="no hand-written kernel takes"):
        attn.multi_head_attention(*xs, kv_lengths=lens)
    out = attn.multi_head_attention(*xs, kv_lengths=lens, use_kernel=False)
    w = torch.randn(out.shape, device="cuda", generator=cuda_gen)
    (out.float() * w).sum().backward()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == counts
    ys = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = attn.mha_plain(*ys, kv_lengths=lens)
    (ref.float() * w).sum().backward()
    for a, r in zip(xs, ys):
        torch.testing.assert_close(a.grad, r.grad)
    if dtype == torch.float32 and h in fa.SUPPORTED_HEAD_DIMS:   # without a gradient: the f32 kernel
        with torch.no_grad():
            attn.multi_head_attention(q, k, v, kv_lengths=lens)
        assert fa.launches == counts[0] + 1


def test_flash_autograd_runs_the_backward_kernels(cuda_gen):
    q, k, v = _qkv(cuda_gen, 2, 256, 4, 2, 96, torch.bfloat16)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    lens = torch.tensor([256, 190], device="cuda")
    out = fa.flash_attention(q, k, v, kv_lengths=lens)
    # a fixed dout (bf16 values) on both sides, so the gradients differ only
    # by the backward, not by the forward's error carried into dout
    w = torch.randn(out.shape, device="cuda", generator=cuda_gen).to(torch.bfloat16).float()
    d0, k0 = fa.dq_launches, fa.dkv_launches
    (out.float() * w).sum().backward()
    assert (fa.dq_launches, fa.dkv_launches) == (d0 + 1, k0 + 1)
    qr, kr, vr = (x.detach().float().requires_grad_(True) for x in (q, k, v))
    ref, _ = fa.flash_attention_reference(qr, kr, vr, kv_lengths=lens)
    (ref * w).sum().backward()
    for name, g, r in (("dq", q.grad, qr.grad), ("dk", k.grad, kr.grad), ("dv", v.grad, vr.grad)):
        _assert_grad_close(g, r, name)


@pytest.mark.parametrize("n,d,heads,nw,windows", [(144, 32, 6, 16, 32), (144, 32, 48, 1, 8), (64, 16, 3, 4, 8)])
@pytest.mark.parametrize("with_mask", [False, True])
def test_window_kernel_matches_plain(cuda_gen, n, d, heads, nw, windows, with_mask):
    """Swin-L's N144/D32 (stage-1-like and stage-4 head counts) and the test
    shape, with W a multiple of nW greater than nW, through strided views of
    one packed qkv tensor as the Swin block passes them."""
    qkv = torch.randn(windows, n, 3, heads, d, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bias = torch.randn(heads, n, n, device="cuda", generator=cuda_gen)
    mask = None
    if with_mask:
        mask = torch.where(torch.rand(nw, n, n, device="cuda", generator=cuda_gen) < 0.3, -100.0, 0.0)
    before = wa.launches
    got = wa.window_attention(q, k, v, bias, mask)
    assert wa.launches == before + 1
    ref = wa.window_attention_plain(q.float(), k.float(), v.float(), bias, mask, d ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert (got.float() - ref).abs().max().item() <= 2e-2


SWIN_L_LAUNCHES = [(512, 6), (128, 12), (32, 24), (8, 48)]   # (W, heads) at 768 px, micro-batch 2


def _packed_qkv(gen, w, n, heads, d):
    qkv = torch.randn(w, n, 3, heads, d, device="cuda", generator=gen).to(torch.bfloat16)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _window_against_plain(q, k, v, bias, mask):
    """The kernel the dispatch takes vs the plain version (f32), within
    2e-2; the same launch 20 times gives the same bytes. Returns the output."""
    d = q.shape[-1]
    before = wa.launches
    got = wa.window_attention(q, k, v, bias, mask)
    assert wa.launches == before + 1
    ref = wa.window_attention_plain(q.float(), k.float(), v.float(), bias, mask, d ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert (got.float() - ref).abs().max().item() <= 2e-2
    for _ in range(20):
        assert torch.equal(wa.window_attention(q, k, v, bias, mask), got)
    return got


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("w,heads", SWIN_L_LAUNCHES)
def test_window_streamed_kernel_at_the_swin_l_stages(cuda_gen, w, heads, shifted):
    """Every Swin-L launch of a train step's teacher (N144 D32, the model's own
    shift mask with nW = W / 2) through strided views of a packed qkv."""
    from visper_lm_tpu_torch.models.teachers import swin

    n, d = 144, 32
    assert wa.window_attn_kernel_for(n, d) == "streamed"
    q, k, v = _packed_qkv(cuda_gen, w, n, heads, d)
    bias = torch.randn(heads, n, n, device="cuda", generator=cuda_gen)
    mask = None
    if shifted:
        side = int(round((w // 2) ** 0.5)) * 12
        mask = torch.as_tensor(swin._shift_attn_mask(side, side, 12, 6), device="cuda")
    _window_against_plain(q, k, v, bias, mask)


@pytest.mark.parametrize("nw", [0, 1, 32, 64])
def test_window_streamed_kernel_at_the_test_shape(cuda_gen, nw):
    """(64, 16) with no mask and nW in {1, W/2, W} (W 64, 5 heads), and a bias
    that starts 4 bytes past a 16-byte boundary (the wrapper copies it: the
    kernel copies rows with the copy engine)."""
    w, heads, n, d = 64, 5, 64, 16
    q, k, v = _packed_qkv(cuda_gen, w, n, heads, d)
    bias = torch.randn(heads * n * n + 1, device="cuda", generator=cuda_gen)[1:].view(heads, n, n)
    mask = None
    if nw:
        mask = torch.where(torch.rand(nw, n, n, device="cuda", generator=cuda_gen) < 0.3, -100.0, 0.0)
    _window_against_plain(q, k, v, bias, mask)


def test_window_kernel_rejects_what_it_cannot_run(cuda_gen):
    q = torch.randn(4, 2, 144, 32, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    bias = torch.zeros(2, 144, 144, device="cuda")
    before = wa.launches
    with pytest.raises(ValueError):
        wa.window_attention(q.clone().requires_grad_(True), q, q, bias)
    with pytest.raises(ValueError):
        wa.window_attention(q.float(), q.float(), q.float(), bias)
    with pytest.raises(ValueError):
        wa.window_attention(q[..., :16], q[..., :16], q[..., :16], bias)
    with pytest.raises(ValueError):
        wa.window_attention(q, q, q, bias, torch.zeros(3, 144, 144, device="cuda"))
    with pytest.raises(ValueError):
        wa.window_attention(q, q, q, torch.zeros(3, 144, 144, device="cuda"))
    assert wa.launches == before


def _w4_weights(gen, din, dout, group, act_rms=None):
    w = 0.05 * torch.randn(din, dout, device="cuda", generator=gen)
    return quantize_linear_int4(w, group, act_rms)


def _assert_w4_close(got, ref):
    err = (got.float() - ref).abs()
    assert (err.norm() / ref.norm()).item() <= 1e-2
    assert err.max().item() <= 2e-2 * ref.abs().max().item()


W4_CARD_M = [1, 8, 13, 16, 17, 100, 256, 300]
W4_CARD_SHAPES = [
    (512, 384, 128), (256, 500, 64), (1024, 320, 32), (384, 256, 16),
    (512, 336, 128),    # dout ragged against the 128-column tile, still 16-byte rows
    (128, 256, 128),    # split-K with one group: a single split
    (256, 192, 128),    # two groups
    (8192, 64, 128),    # 64 groups on one column tile: 8 splits of two rounds each
]


@pytest.mark.parametrize("m", W4_CARD_M)
@pytest.mark.parametrize("din,dout,group", W4_CARD_SHAPES)
def test_w4_kernel_matches_plain(cuda_gen, m, din, dout, group):
    """M across the regime boundary (16 | 17) and the tile edges, every k-step
    size, a dout that is no multiple of 16 (500: the mma.sync kernel for
    M > 16, byte-wise staging in the split-K kernel) and one that is ragged
    against the warpgroup kernel's tile (336), few and many groups per split.
    Tolerances: the bf16 output's rounding (relative 2^-9 per element) and
    f32 sums in another order than the plain version's, against it in f32."""
    qd = _w4_weights(cuda_gen, din, dout, group)
    x = torch.randn(m, din, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    before = qm.launches
    got = qm.w4_matmul(x, qd["weight_q4p"], qd["q4_scale"], group)
    assert qm.launches == before + 1
    ref = qm.w4_matmul_reference(x.float(), qd["weight_q4p"], qd["q4_scale"], group)
    torch.cuda.synchronize()
    assert got.shape == (m, dout) and got.dtype == torch.bfloat16
    _assert_w4_close(got, ref)


@pytest.mark.parametrize("m", [8, 768])
@pytest.mark.parametrize("din,dout", [(4096, 14336), (14336, 4096), (4096, 1024)])
def test_w4_kernel_at_llama3_widths(cuda_gen, m, din, dout):
    """Llama-3-8B's gate/up, down and k/v projections at a decode step's M
    (split-K) and a prefill's (the warpgroup kernel), group 128."""
    qd = _w4_weights(cuda_gen, din, dout, 128)
    x = torch.randn(m, din, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    assert qm.w4_kernel_for(m, din, dout, 128) == ("splitk" if m <= 16 else "wgmma")
    got = qm.w4_matmul(x, qd["weight_q4p"], qd["q4_scale"], 128)
    ref = qm.w4_matmul_reference(x.float(), qd["weight_q4p"], qd["q4_scale"], 128)
    torch.cuda.synchronize()
    assert got.shape == (m, dout)
    _assert_w4_close(got, ref)


@pytest.mark.parametrize("m", [8, 300])
@pytest.mark.parametrize("din,dout,group", [(512, 384, 128), (256, 500, 64), (384, 256, 16)])
def test_w4_mma_sync_kernel_matches_plain(cuda_gen, m, din, dout, group):
    """The mma.sync kernel, which takes the shapes the other two do not, on
    shapes that all three take: forced by name."""
    qd = _w4_weights(cuda_gen, din, dout, group)
    x = torch.randn(m, din, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    got = qm.w4_matmul(x, qd["weight_q4p"], qd["q4_scale"], group, kernel="mma_sync")
    ref = qm.w4_matmul_reference(x.float(), qd["weight_q4p"], qd["q4_scale"], group)
    torch.cuda.synchronize()
    _assert_w4_close(got, ref)


@pytest.mark.parametrize("m,din,dout,group", [(8, 3072, 3072, 128), (1, 8192, 320, 128), (16, 1024, 500, 32)])
def test_w4_small_m_launch_is_bit_identical(cuda_gen, m, din, dout, group):
    """The split-K kernel sums its splits in split order, without float
    atomics: the same launch 20 times gives the same bytes (greedy decoding
    must give the same tokens run after run)."""
    assert qm.w4_kernel_for(m, din, dout, group) == "splitk"
    assert qm.w4_split_plan(din, dout, group)[1] > 1
    qd = _w4_weights(cuda_gen, din, dout, group)
    x = torch.randn(m, din, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    first = qm.w4_matmul(x, qd["weight_q4p"], qd["q4_scale"], group)
    for _ in range(20):
        assert torch.equal(qm.w4_matmul(x, qd["weight_q4p"], qd["q4_scale"], group), first)


def test_w4_forced_kernel_rejects_a_shape_it_does_not_take(cuda_gen):
    qd = _w4_weights(cuda_gen, 256, 500, 64)
    x = torch.randn(300, 256, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    before = qm.launches
    with pytest.raises(ValueError):                       # M 300 is not the split-K kernel's
        qm.w4_matmul(x, qd["weight_q4p"], qd["q4_scale"], 64, kernel="splitk")
    with pytest.raises(RuntimeError):                     # dout 500: not 16-byte rows
        qm.w4_matmul(x, qd["weight_q4p"], qd["q4_scale"], 64, kernel="wgmma")
    assert qm.launches == before


def test_w4_quant_linear_with_awq_in_scale_takes_the_kernel(cuda_gen):
    din, dout = 768, 640
    rms = torch.rand(din, device="cuda", generator=cuda_gen) * 4 + 0.05
    qd = _w4_weights(cuda_gen, din, dout, 128, act_rms=rms)
    assert "q4_in_scale" in qd
    layer = QuantLinear(**qd)
    x = torch.randn(2, 5, din, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    before = qm.launches
    got = layer(x)
    assert qm.launches == before + 1 and got.shape == (2, 5, dout)
    xs = (x * qd["q4_in_scale"].to(x.dtype)).reshape(-1, din)
    ref = qm.w4_matmul_reference(xs.float(), qd["weight_q4p"], qd["q4_scale"], 128)
    _assert_w4_close(got.reshape(-1, dout), ref)
    plain = layer(x, use_kernel=False)           # the dequantized (XLA-branch) product
    assert qm.launches == before + 1
    _assert_w4_close(plain.reshape(-1, dout), ref)


def test_w4_kernel_rejects_what_it_cannot_run(cuda_gen):
    qd = _w4_weights(cuda_gen, 256, 128, 128)
    pk, sc = qd["weight_q4p"], qd["q4_scale"]
    x = torch.randn(4, 256, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    before = qm.launches
    with pytest.raises(ValueError):
        qm.w4_matmul(x.float(), pk, sc, 128)              # f32 x
    with pytest.raises(ValueError):
        qm.w4_matmul(x, pk.cpu(), sc, 128)                # packed on the CPU
    with pytest.raises(ValueError):
        qm.w4_matmul(x, pk, sc.repeat(16, 1), 8)          # group 8: not a k-step multiple
    with pytest.raises(ValueError):
        qm.w4_matmul(x[:, :128], pk, sc, 128)             # din mismatch
    assert qm.launches == before


def test_w4_quant_linear_with_a_group_the_kernel_cannot_run_raises(cuda_gen):
    """Group 8 passes JAX's gate (even, >= 2) but is not a multiple of the
    kernel's k-step: a CUDA QuantLinear raises rather than take the plain
    product; use_kernel=False still takes it."""
    w = 0.05 * torch.randn(256, 128, device="cuda", generator=cuda_gen)
    layer = QuantLinear(**quantize_linear_int4(w, 8))
    assert layer.q4_scale.shape == (32, 128)
    x = torch.randn(4, 256, device="cuda", generator=cuda_gen).to(torch.bfloat16)
    assert qm.w4_supported(layer.weight_q4p, layer.q4_scale, x)
    before = qm.launches
    with pytest.raises(ValueError, match="group 8"):
        layer(x)
    assert qm.launches == before
    assert layer(x, use_kernel=False).shape == (4, 128)


def _decode_inputs(gen, b, nq, nkv, h, s, quant):
    q = torch.randn(b, 1, nq, h, device="cuda", generator=gen).to(torch.bfloat16)
    k = torch.randn(b, nkv, s, h, device="cuda", generator=gen)
    v = torch.randn(b, nkv, s, h, device="cuda", generator=gen)
    if not quant:
        return q, k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    (kq, ks), (vq, vs) = quantize_head_vectors(k), quantize_head_vectors(v)
    return q, kq, vq, ks[..., 0], vs[..., 0]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nq,nkv,h", [(8, 8, 64), (8, 2, 96), (32, 8, 128), (4, 4, 96)])
def test_decode_kernel_matches_plain(cuda_gen, quant, nq, nkv, h):
    """MHA and GQA (G up to 4), H 64/96/128, bf16 and int8 caches; S = 300 is
    not a multiple of the 32-position tile; batch row 2 has no valid position."""
    b, s = 3, 300
    q, k, v, ks, vs = _decode_inputs(cuda_gen, b, nq, nkv, h, s, quant)
    lens = torch.tensor([300, 131, 40], device="cuda")
    starts = torch.tensor([0, 37, 40], device="cuda")
    before = da.launches
    got = da.decode_attention(q, k, v, ks, vs, kv_lengths=lens, kv_starts=starts)
    assert da.launches == before + 1
    ref = da.decode_attention_reference(q.float(), k, v, ks, vs, kv_lengths=lens, kv_starts=starts)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    err = got[:2].float() - ref[:2]
    assert (err.norm() / ref[:2].norm()).item() <= 1e-2
    assert err.abs().max().item() <= 5e-3
    assert torch.all(got[2] == 0)


def _assert_decode_close(got, ref, live, dead):
    """5e-3 where |out| stays below 1 (many positions average out); a row
    with a handful of valid positions keeps |out| up to ~3, and the bf16
    output's rounding (relative 2^-9) grows with it."""
    err = got[live].float() - ref[live]
    assert (err.norm() / ref[live].norm()).item() <= 1e-2
    assert err.abs().max().item() <= 5e-3 * max(1.0, ref[live].abs().max().item())
    for i in dead:
        assert torch.all(got[i] == 0)


@pytest.mark.parametrize("kernel", ["split", "serial"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("s", [33, 224, 896, 1024, 4096])
def test_decode_kernels_across_split_boundaries(cuda_gen, kernel, quant, s):
    """S from one short split (33: scale rows not 16-byte aligned) to eight
    splits of two rounds (4096); lengths and starts that leave whole splits
    without a valid position (row 1: only [s/2 + 1, s/2 + 9); row 3: the last
    5), a start that is no multiple of 4, a row with no valid position (2)."""
    b, nq, nkv, h = 4, 4, 2, 96
    q, k, v, ks, vs = _decode_inputs(cuda_gen, b, nq, nkv, h, s, quant)
    lens = torch.tensor([s, s // 2 + 9, 7, s], device="cuda")
    starts = torch.tensor([3, s // 2 + 1, 7, s - 5], device="cuda")
    got = da.decode_attention(q, k, v, ks, vs, kv_lengths=lens, kv_starts=starts, kernel=kernel)
    ref = da.decode_attention_reference(q.float(), k, v, ks, vs, kv_lengths=lens, kv_starts=starts)
    torch.cuda.synchronize()
    _assert_decode_close(got, ref, [0, 1, 3], [2])


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("nq,nkv", [(8, 8), (8, 4), (12, 4), (16, 4)])
@pytest.mark.parametrize("h", [64, 96, 128])
def test_decode_split_kernel_groups_and_head_dims(cuda_gen, quant, nq, nkv, h):
    """G 1, 2, 3 (held as 4) and 4 at every head dim, lengths beyond S clipped,
    no kv_starts."""
    b, s = 2, 500
    q, k, v, ks, vs = _decode_inputs(cuda_gen, b, nq, nkv, h, s, quant)
    lens = torch.tensor([s + 40, 123], device="cuda")
    got = da.decode_attention(q, k, v, ks, vs, kv_lengths=lens)
    ref = da.decode_attention_reference(q.float(), k, v, ks, vs, kv_lengths=lens)
    torch.cuda.synchronize()
    _assert_decode_close(got, ref, [0, 1], [])


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("s", [1, 4, 16, 17, 31])
def test_decode_split_kernel_short_caches(cuda_gen, quant, s):
    """Caches shorter than one step of 16 positions, a batch in which no row
    has a valid position, and many (batch, kv head) pairs at once."""
    b, nq, nkv, h = 5, 6, 2, 128
    q, k, v, ks, vs = _decode_inputs(cuda_gen, b, nq, nkv, h, s, quant)
    lens = torch.tensor([s, 1, 0, s, max(s - 1, 1)], device="cuda")
    starts = torch.tensor([0, 0, 0, s - 1, 0], device="cuda")
    got = da.decode_attention(q, k, v, ks, vs, kv_lengths=lens, kv_starts=starts)
    ref = da.decode_attention_reference(q.float(), k, v, ks, vs, kv_lengths=lens, kv_starts=starts)
    torch.cuda.synchronize()
    _assert_decode_close(got, ref, [0, 1, 3, 4], [2])
    none = da.decode_attention(q, k, v, ks, vs, kv_lengths=torch.zeros_like(lens))
    assert torch.all(none == 0)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("b,nq,nkv,h,s", [(8, 32, 32, 96, 896), (4, 32, 8, 128, 1024), (1, 4, 4, 64, 4096)])
def test_decode_split_launch_is_bit_identical(cuda_gen, quant, b, nq, nkv, h, s):
    """The cluster merges its splits in split order, without atomics or
    scratch: the same launch 20 times gives the same bytes."""
    assert da.decode_split_plan(b, nkv, s, h, 1 if quant else 2)[1] > 1
    q, k, v, ks, vs = _decode_inputs(cuda_gen, b, nq, nkv, h, s, quant)
    lens = torch.full((b,), s - 96, device="cuda")
    starts = torch.arange(b, device="cuda") * 17
    first = da.decode_attention(q, k, v, ks, vs, kv_lengths=lens, kv_starts=starts)
    for _ in range(20):
        assert torch.equal(da.decode_attention(q, k, v, ks, vs, kv_lengths=lens, kv_starts=starts), first)


def test_decode_kernel_rejects_what_it_cannot_run(cuda_gen):
    q, k, v, ks, vs = _decode_inputs(cuda_gen, 2, 4, 4, 96, 64, True)
    lens = torch.tensor([64, 10], device="cuda")
    before = da.launches
    with pytest.raises(ValueError):
        da.decode_attention(q, k, v, kv_lengths=lens)               # int8 without scales
    with pytest.raises(ValueError):
        da.decode_attention(q, k.cpu(), v, ks, vs, kv_lengths=lens)  # cache on the CPU
    with pytest.raises(ValueError):
        da.decode_attention(q.half(), k, v, ks, vs, kv_lengths=lens)
    with pytest.raises(ValueError):                                 # f32 q: bf16 only
        da.decode_attention(q.float(), k, v, ks, vs, kv_lengths=lens)
    with pytest.raises(ValueError):                                 # group 8 > 4
        qg = torch.zeros(2, 1, 32, 96, device="cuda", dtype=torch.bfloat16)
        da.decode_attention(qg, k, v, ks, vs, kv_lengths=lens)
    with pytest.raises(ValueError):                                 # no such kernel
        da.decode_attention(q, k, v, ks, vs, kv_lengths=lens, kernel="splitk")
    assert da.launches == before


def _engine_vlm():
    """tiny_test_vlm widened to a head dim the flash kernel takes (H64), bf16."""
    import dataclasses

    from visper_lm_tpu_torch.config import tiny_test_vlm
    from visper_lm_tpu_torch.models.vlm import init_vlm

    cfg = tiny_test_vlm(distill=True)
    cfg = dataclasses.replace(
        cfg,
        decoder=dataclasses.replace(cfg.decoder, hidden_size=256, head_dim=64, mlp_dim=512,
                                    dtype="bfloat16", max_seq_len=1024),
        vision=dataclasses.replace(cfg.vision, dtype="bfloat16"),
        projector=dataclasses.replace(cfg.projector, output_dim=256),
    )
    return cfg, init_vlm(cfg, device="cuda", seed=0)


@pytest.mark.parametrize("quant", ["bf16", "int8_kv_int4"])
def test_engine_runs_the_kernels_and_matches_plain(cuda_gen, quant):
    """A small Engine on the card: prefill logits with the kernels within
    0.05 x max|logits| of use_kernel=False; the flash kernel once per decoder
    layer and prefill dispatch, the w4 kernel in every linear of every
    forward at int4, the decode kernel never; one host sync per quantum."""
    import numpy as np

    from visper_lm_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from visper_lm_tpu_torch.data.collate import build_splice_plan
    from visper_lm_tpu_torch.serve.engine import Engine, EngineConfig, Request

    cfg, model = _engine_vlm()
    d = cfg.decoder
    kw = {} if quant == "bf16" else dict(kv_quant=True, weight_quant="int4")
    eng = Engine(model, cfg, EngineConfig(num_slots=4, max_len=512, **kw), device="cuda")
    rng = np.random.default_rng(0)
    reqs = []
    for i, n in enumerate((20, 150, 90, 200, 40, 130)):
        ids = [1, 2, 3, IMAGE_TOKEN_INDEX] + rng.integers(4, d.vocab_size, size=n).tolist()
        plan = build_splice_plan(ids, None, 256, num_image_tokens=cfg.num_image_tokens,
                                 num_task_tokens=cfg.distill.num_task_tokens, num_tasks=3)
        image = rng.standard_normal((1, 28, 28, 3)).astype(np.float32)
        reqs.append(Request(plan=plan, images=image, max_new_tokens=5 + 3 * i, uid=i))
    got = eng.prefill_logits(reqs[1])
    ref = eng.prefill_logits(reqs[1], use_kernel=False)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 0.05 * ref.abs().max().item()
    fa.launches = qm.launches = da.launches = 0
    done = eng.run(reqs)
    st = eng.stats
    assert sorted(len(r.output_ids) for r in done) == sorted(r.max_new_tokens for r in reqs)
    assert fa.launches == d.num_layers * st["admit_dispatches"]
    assert st["host_syncs"] == st["steps"]
    assert da.launches == 0
    per_forward = 7 * d.num_layers + (0 if d.tie_embeddings else 1)
    forwards = st["admit_dispatches"] + st["steps"] * eng.ecfg.decode_quantum
    assert qm.launches == (0 if quant == "bf16" else per_forward * forwards)


@pytest.mark.parametrize("weight_quant", [None, "int4"])
def test_visper_model_chat_serve_and_session_run_the_kernels(cuda_gen, weight_quant):
    """The user API on the card: chat at the default quantization (bf16: JAX
    quantizes by itself only on a TPU) and at int4, serve's answers equal
    chat's one by one, a session's later turn prefills only its own tokens;
    B1 once per layer and prefill, B5 in every linear of every forward at
    int4."""
    import numpy as np

    from visper_lm_tpu_torch.api import VisperModel

    import re
    import types

    class Tok:
        """Specials and words; "w<k>" is id k, as decode writes it, so a
        session's history tokenizes back to the ids it cached."""
        bos_token_id, eos_token_id = 1, None
        specials = {"<|system|>": 500, "<|user|>": 501, "<|assistant|>": 502, "<|end|>": 503,
                    "\n": 504}

        def __call__(self, text):
            ids = [1]
            for part in re.split("(" + "|".join(map(re.escape, self.specials)) + ")", text):
                if part in self.specials:
                    ids.append(self.specials[part])
                    continue
                ids += [int(w[1:]) if w[0] == "w" and w[1:].isdigit() else 3 + hash(w) % 490
                        for w in part.split()]
            return types.SimpleNamespace(input_ids=ids)

        def decode(self, ids, skip_special_tokens=False):
            names = {v: k for k, v in self.specials.items()}
            return " ".join(names.get(i, f"w{i}") for i in ids)

    cfg, model = _engine_vlm()
    d = cfg.decoder
    vm = VisperModel(cfg=cfg, model=model, tokenizer=Tok(), context_len=512)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((40, 60), (28, 28))]
    qs = ["what is it?", "how many things are there in this picture?"]
    fa.launches = qm.launches = da.launches = 0
    out = vm.chat(qs, images, max_new_tokens=6, weight_quant=weight_quant)
    assert fa.launches == d.num_layers and da.launches == 0
    if weight_quant == "int4":
        forwards = 1 + 16        # the prefill and one decode chunk of 16
        assert qm.launches == (7 * d.num_layers + 1) * forwards
    assert [len(t.split()) for t in out] == [6, 6]
    assert vm.serve(qs, images, max_new_tokens=6, weight_quant=weight_quant) == \
        [vm.chat([q], [im], max_new_tokens=6, weight_quant=weight_quant)[0]
         for q, im in zip(qs, images)]
    session = vm.chat_session(images[0], weight_quant=weight_quant)
    session.ask("w1 w2 w3", max_new_tokens=4)
    before = session.engine.stats["prefill_tokens"]
    session.ask("w4 w5", max_new_tokens=4)
    assert 0 < session.engine.stats["prefill_tokens"] - before < 20
