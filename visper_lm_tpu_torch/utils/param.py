"""Layer primitives and parameter trees (counterpart of
visper_lm_tpu/utils/param.py).

Plain functions on tensors, the two small norm modules, and the quantized
serving linear. Dense linear layers are `nn.Linear`, whose weight is
(out, in): the transpose of the JAX package's input-major {"kernel": (in,
out)} (weights.py converts between them). `QuantLinear` keeps JAX's
input-major layout for its int8 buffers, so JAX's quantized leaves map onto
it as they are.

The tree functions (`count_params` ... `load_params_npz`) work on a model's
`named_parameters()` as a flat {port name: tensor} dict; `jax_path` names
each parameter by its path in the JAX tree. `save_params_npz` writes the
JAX package's .npz layout (stacked decoder and vision blocks, input-major
kernels, HWIO convs, bf16 as raw 2-byte values), so the JAX package's
`load_params_npz` reads it, and `load_params_npz` reads the JAX package's
files into its nested tree (`weights.from_jax_params` builds a model from it).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from visper_lm_tpu_torch.ops.quant_matmul import unpack_int4, w4_linear, w4_supported


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense y = x @ weight.T (+ bias), in the input dtype."""
    return F.linear(x, weight, bias)


def quantize_linear_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """JAX `quantize_linear_weights` for one input-major (din, dout) weight:
    per-output-channel symmetric int8, scale amax / 127 (floor 1e-8), in f32.
    Returns {"weight_q8" (din, dout) int8, "out_scale" (dout,) f32}."""
    wf = w.float()
    # amax / 127 as amax * f32(1 / 127), the form XLA folds a division by a
    # constant into (so the scales, and the rounding ties, match JAX's)
    scale = wf.abs().amax(dim=-2, keepdim=True).clamp(min=1e-8) * (1.0 / 127.0)
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"weight_q8": q, "out_scale": scale.squeeze(-2)}


AWQ_ALPHA = 0.5  # JAX `quantize_linear_weights_int4`'s default awq_alpha


def quantize_linear_int4(
    w: torch.Tensor, group: int = 128, act_rms: Optional[torch.Tensor] = None
) -> Optional[Dict[str, torch.Tensor]]:
    """JAX `quantize_linear_weights_int4` for one input-major (din, dout)
    weight; None when no group size in (group, 64, 32, 16) divides din (the
    layer stays dense).

    Group-wise symmetric int4 (amax / 7, floor 1e-8, clip +-7), nibble-packed
    with row 2r in the low and row 2r + 1 in the high nibble. With act_rms
    (din,) (AWQ, serve/calibrate.decoder_act_rms): s = clip((rms / gmean)^0.5,
    0.1, 10), the weight rows are scaled by s (in f32, then rounded to the
    weight's dtype, as JAX does) and 1 / s is kept as "q4_in_scale".
    Returns {"weight_q4p" (din/2, dout) int8, "q4_scale" (G, dout) f32
    [, "q4_in_scale" (din,) f32]}."""
    din, dout = w.shape
    size = next((c for c in (group, 64, 32, 16) if din % c == 0), None)
    if size is None:
        return None
    out: Dict[str, torch.Tensor] = {}
    if act_rms is not None and tuple(act_rms.shape) == (din,):
        r = act_rms.float().clamp(min=1e-6)
        gmean = torch.exp(torch.log(r).mean(dim=-1, keepdim=True))
        s = ((r / gmean) ** AWQ_ALPHA).clamp(0.1, 10.0)
        w = (w.float() * s[:, None]).to(w.dtype)
        out["q4_in_scale"] = 1.0 / s
    grouped = w.float().reshape(din // size, size, dout)
    scale = grouped.abs().amax(dim=-2, keepdim=True).clamp(min=1e-8) * (1.0 / 7.0)
    q = torch.round(grouped / scale).clamp(-7, 7).to(torch.int32).reshape(din // 2, 2, dout)
    out["weight_q4p"] = ((q[:, 0] & 0x0F) | (q[:, 1] << 4)).to(torch.int8)
    out["q4_scale"] = scale.squeeze(-2)
    return out


class QuantLinear(nn.Module):
    """A serving linear with quantized weights held as buffers (no
    parameters, no bias; the decoder's linears have none), input-major:

      * w8a16: weight_q8 (din, dout) int8, out_scale (dout,) f32;
      * w4a16: weight_q4p (din/2, dout) int8 nibble-packed, q4_scale (G, dout)
        f32, and q4_in_scale (din,) f32 when AWQ-calibrated.

    Build it from `quantize_linear_int8` / `quantize_linear_int4`'s dict, or
    from JAX's quantized leaves (weights.py)."""

    def __init__(self, **buffers: torch.Tensor):
        super().__init__()
        names = set(buffers)
        if names not in ({"weight_q8", "out_scale"}, {"weight_q4p", "q4_scale"},
                         {"weight_q4p", "q4_scale", "q4_in_scale"}):
            raise ValueError(f"QuantLinear: unknown buffer set {sorted(names)}")
        for name in ("weight_q8", "out_scale", "weight_q4p", "q4_scale", "q4_in_scale"):
            buf = buffers.get(name)
            self.register_buffer(name, None if buf is None else buf.contiguous())

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
        """JAX `linear`'s kernel_q8 / kernel_q4p branches. A packed-int4 weight
        goes to the w4 kernel (ops/quant_matmul.py) when use_kernel (None =
        "x is on CUDA") and its layout is supported, else to the dequantized
        product: q * s rounded to x's dtype, then one matmul."""
        if self.weight_q8 is not None:
            y = x @ self.weight_q8.to(x.dtype)
            return y * self.out_scale.to(y.dtype)
        if self.q4_in_scale is not None:
            x = x * self.q4_in_scale.to(x.dtype)
        if use_kernel is None:
            use_kernel = x.is_cuda
        if use_kernel and w4_supported(self.weight_q4p, self.q4_scale, x):
            return w4_linear(self.weight_q4p, self.q4_scale, x)
        q = unpack_int4(self.weight_q4p)
        din, dout = q.shape
        groups = self.q4_scale.shape[0]
        wf = (
            q.to(x.dtype).reshape(groups, din // groups, dout)
            * self.q4_scale[:, None, :].to(x.dtype)
        ).reshape(din, dout)
        return x @ wf


def apply_linear(layer: nn.Module, x: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
    """A dense `nn.Linear` or a `QuantLinear` (which takes use_kernel)."""
    if isinstance(layer, QuantLinear):
        return layer(x, use_kernel=use_kernel)
    return layer(x)


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


# ---------------------------------------------------------------------------
# Parameter trees: flat {port name: tensor} dicts keyed like the JAX tree
# ---------------------------------------------------------------------------

# module lists the JAX package stacks into one (L, ...) leaf per parameter:
# the decoder's and the ViT's blocks, and each ConvNeXt stage's
_STACKED = re.compile(
    r"^(decoder\.blocks\.|vision_tower\.blocks\.|vision_tower\.stages\.\d+\.blocks\.)"
    r"(\d+)\.(.*)$")

NamedParams = Union[nn.Module, Mapping[str, Optional[torch.Tensor]]]


def _named(params: NamedParams) -> Dict[str, Optional[torch.Tensor]]:
    """A module's named parameters, or a {port name: tensor or None} mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def split_layer(name: str) -> Tuple[str, Optional[int]]:
    """(name without the layer index of a stacked block list, that index or None)."""
    m = _STACKED.match(name)
    if m is None:
        return name, None
    return m.group(1) + m.group(3), int(m.group(2))


def jax_path(name: str) -> str:
    """The JAX param-tree path of a port parameter name: '.' -> '/', a linear
    `weight` -> `kernel`, the token table -> `embedding`, and the layer index
    of stacked decoder / vision blocks dropped (JAX stacks them)."""
    parts = split_layer(name)[0].split(".")
    if parts[-1] == "weight":
        parts[-1] = "embedding" if parts[-2] == "embed_tokens" else "kernel"
    return "/".join(parts)


def count_params(params: NamedParams) -> int:
    return sum(t.numel() for t in _named(params).values() if t is not None)


def tree_cast(params: NamedParams, dtype: Union[str, torch.dtype]) -> Dict[str, torch.Tensor]:
    """Floating tensors cast to dtype, others as they are."""
    dt = torch_dtype(dtype) if isinstance(dtype, str) else dtype
    return {n: t.to(dt) if t is not None and t.is_floating_point() else t
            for n, t in _named(params).items()}


def partition_params(
    params: NamedParams, mask: Mapping[str, bool]
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(trainable, frozen) by a per-name bool mask; both keep every name,
    with None at the other side's entries (merge with `merge_params`)."""
    named = _named(params)
    return ({n: t if mask[n] else None for n, t in named.items()},
            {n: None if mask[n] else t for n, t in named.items()})


def merge_params(a: Mapping[str, Any], b: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of `partition_params`: the non-None entry at each name."""
    return {n: b[n] if a[n] is None else a[n] for n in a}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")   # the bytes JAX's npz holds
    return t.numpy()


def jax_flat_arrays(params: NamedParams) -> Dict[str, Optional[np.ndarray]]:
    """{JAX path: array in the JAX layout}: stacked blocks (L, ...) in layer
    order, linear kernels (in, out), convs HWIO; a None entry stays None."""
    stacks: Dict[str, Dict[int, Optional[np.ndarray]]] = {}
    flat: Dict[str, Optional[np.ndarray]] = {}
    for name, t in _named(params).items():
        key = jax_path(name)
        a = None
        if t is not None:
            a = _to_numpy(t)
            if key.endswith("/kernel"):
                a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        layer = split_layer(name)[1]
        if layer is None:
            flat[key] = a
        else:
            stacks.setdefault(key, {})[layer] = a
    for key, layers in stacks.items():
        vals = [layers[i] for i in range(len(layers))]
        flat[key] = None if any(v is None for v in vals) else np.stack(vals)
    return flat


def save_params_npz(path: str, params: NamedParams) -> None:
    """JAX `save_params_npz` of the parameters' JAX tree: '/'-joined paths,
    list indices as decimal segments, None entries as `<path>#None`."""
    flat = {}
    for key, a in jax_flat_arrays(params).items():
        if a is None:
            flat[key + "#None"] = np.zeros((0,), np.int8)
        else:
            flat[key] = np.asarray(a, order="C")
    np.savez(path, **flat)


def load_params_npz(path: str) -> Any:
    """JAX `load_params_npz`: the nested tree (dicts; all-integer-keyed
    levels become lists) of numpy arrays; bf16 leaves stay raw 2-byte values
    (`weights.from_jax_params` reads them as bf16)."""
    data = np.load(path)
    root: dict = {}
    for key in data.files:
        value = data[key]
        if key.endswith("#None"):
            key, value = key[: -len("#None")], None
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)
