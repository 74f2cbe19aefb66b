"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and skips
without one. This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Tolerances (max abs error on rows with at least one valid key, against the
plain version computed in f32): bf16 2e-2, f32 1e-4; lse 1e-3. Backward
(bf16 only; dq, dk, dv against `flash_attention_bwd_reference` fed the plain
forward's f32 out and lse): relative Frobenius error 1e-2 and, per element,
|err| <= 2e-2 + 1e-2 x |ref|. Window attention: bf16 2e-2. w4 matmul (bf16
out against `w4_matmul_reference` in f32): relative Frobenius error 1e-2 and
max abs error 2e-2 x max|ref|; the same small-M launch repeated gives the
same bytes. Decode attention (bf16 q; bf16 or int8
cache): relative Frobenius error 1e-2 and max abs error 5e-3 on rows with a
valid key; a row with none is exactly 0.
"""

import pytest
import torch

from visper_lm_tpu_torch.models.decoder import quantize_head_vectors
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
    assert da.launches == before
