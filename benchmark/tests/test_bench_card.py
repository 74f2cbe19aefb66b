"""On the card only (skipped elsewhere by the `cuda_device` fixture): the traced
window sees the port's B1 launches, the recorder keeps their shapes, and the
roofline share they give lies in (0, 100]."""

import pytest
import torch

from benchmark.counts.kernels import roofline_share
from benchmark.harness.trace import Tracer


@pytest.mark.cuda
def test_flash_launches_traced_and_bounded(cuda_device):
    card = cuda_device
    from visper_lm_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn(4, 1024, 32, 96, device=card, dtype=torch.bfloat16, generator=g)
               for _ in range(3))
    lens = torch.tensor([1024, 700, 650, 900], device=card, dtype=torch.int32)
    fa.flash_attention_fwd(q, k, v, causal=True, kv_lengths=lens)       # built and warm
    tracer = Tracer(True)
    with tracer.window():
        for _ in range(5):
            fa.flash_attention_fwd(q, k, v, causal=True, kv_lengths=lens)
    s = tracer.summary()
    assert len(s["calls"]) == 5 and len(s["kernels"]["fwd"]) == 5
    share = roofline_share(s["calls"], s["kernels"])
    assert 0.0 < share <= 100.0
    assert 0.0 < s["busy_s"] <= s["window_s"]
