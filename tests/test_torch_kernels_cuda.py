"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and skips
without one. This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Tolerances (max abs error on rows with at least one valid key, against the
plain version computed in f32): bf16 2e-2, f32 1e-4; lse 1e-3.
"""

import pytest
import torch

from visper_lm_tpu_torch.ops import flash_attention as fa

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
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q.clone().requires_grad_(True), k, v)
    with pytest.raises(ValueError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :80].contiguous(), k[..., :80].contiguous(),
                           v[..., :80].contiguous())
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), v)
    assert fa.launches == before + 1
