"""Layer primitives (the serving subset of visper_lm_tpu/utils/param.py).

Plain functions on tensors plus the two small norm modules. Linear layers are
`nn.Linear`, whose weight is (out, in): the transpose of the JAX package's
input-major {"kernel": (in, out)} (weights.py converts between them).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense y = x @ weight.T (+ bias), in the input dtype."""
    return F.linear(x, weight, bias)


def layernorm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm computed in f32 and cast back to the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in f32 and cast back to the input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    y = y * scale.float()
    return y.to(x.dtype)


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row gather: (vocab, d) table, integer ids of any shape -> ids.shape + (d,)."""
    return F.embedding(ids, table)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "quick_gelu": quick_gelu,
    "silu": F.silu,
}


class LayerNorm(nn.Module):
    """{scale, bias} LayerNorm, f32 statistics (JAX `layernorm`)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.scale, self.bias, self.eps)


class RMSNorm(nn.Module):
    """{scale} RMSNorm, f32 statistics (JAX `rmsnorm`)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps)


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ("bfloat16", "float32", ...) -> torch dtype."""
    return getattr(torch, name)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init in place, with the JAX package's distributions:
    linear kernels U(-1/sqrt(in), 1/sqrt(in)) and zero bias, embeddings
    N(0, 0.02), norm scales 1 and biases 0. The numbers differ from JAX's
    for the same seed; parity tests carry JAX weights over instead."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = m.in_features ** -0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, (LayerNorm, RMSNorm)):
            m.scale.fill_(1.0)
            if isinstance(m, LayerNorm):
                m.bias.zero_()
