"""Decoder-only transformer (counterpart of visper_lm_tpu/models/decoder.py).

Covers Phi3-mini-4k and Llama-style decoders: pre-norm blocks with GQA
attention, rope and a SiLU-gated MLP, a slot-major KV cache for serving (bf16
/ f32, or int8 with per-vector scales) written at one offset for the batch or
one per sample (`write_cache_chunk`), quantized serving weights
(`quantize_decoder`: w8a16 or w4a16 `QuantLinear`s), per-channel activation
statistics for AWQ calibration, and layer taps for the distillation heads in
training. The JAX layer `lax.scan` over stacked blocks becomes a Python loop
over an `nn.ModuleList`; MoE and the pipelined stack are later-slice
machinery and are not here.

LoRA (`Decoder.forward(lora=...)`, JAX `_lora_linear`): the factors of each
targeted linear, (A, B scaled) stacked over the layers (models/lora.py),
add the rank-r side path y = x W + (x A) B in every block, with A and B cast
to x's dtype; dA and dB come from rank-r intermediates only.

Rematerialisation (`Decoder.forward(remat=True, remat_policy=...)`, JAX
`jax.checkpoint` with `_remat_policy`) wraps each block in
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`: the forward keeps
the block's input, the backward runs the block again to rebuild what it
needs. A policy names tensors the recompute does not rebuild (JAX's
`checkpoint_name` sites, `REMAT_POLICIES`): the block's first run keeps
them in a `_Stash`, and its recompute takes them from there without running
the op that made them. A kept linear output (`qkv` post-rope, `mlp_gate`,
`mlp_up`) is a `_StashedLinear`, whose backward is the linear's (and rope's)
vector-Jacobian product, so the gradient still reaches the block's input
and, when it trains, the weight; a kept attention output (`flash_out`, with
the flash forward's lse) goes through the `saved` list of
`multi_head_attention`, so the recompute launches no flash forward.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from visper_lm_tpu_torch.config import DecoderConfig
from visper_lm_tpu_torch.models.rope import apply_rope, apply_rope_transpose, rope_cos_sin
from visper_lm_tpu_torch.ops.attention import Offset, mha_plain_cache, multi_head_attention
from visper_lm_tpu_torch.utils.param import (
    QuantLinear,
    RMSNorm,
    apply_linear,
    quantize_linear_int4,
    quantize_linear_int8,
)

# the seven linears of a block, in JAX's param names
LINEAR_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


@dataclasses.dataclass
class KVCache:
    """Slot-major cache (L, S_max, B, Nkv, H), the JAX package's layout: one
    decode step writes one contiguous (B, Nkv, H) slab per layer."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[1]

    def layer(self, i: int) -> Tuple[torch.Tensor, ...]:
        return self.k[i], self.v[i]


@dataclasses.dataclass
class QuantKVCache:
    """int8 slot-major cache (L, S_max, B, Nkv, H) with one f32 scale per
    (layer, slot, batch, kv head) vector over H (JAX `QuantKVCache`)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor             # (L, S_max, B, Nkv) f32
    v_scale: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[1]

    def layer(self, i: int) -> Tuple[torch.Tensor, ...]:
        return self.k[i], self.v[i], self.k_scale[i], self.v_scale[i]


def init_kv_cache(
    cfg: DecoderConfig, batch: int, max_len: int, *, dtype: torch.dtype = torch.bfloat16,
    device: Union[str, torch.device],
) -> KVCache:
    shape = (cfg.num_layers, max_len, batch, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def init_quant_kv_cache(
    cfg: DecoderConfig, batch: int, max_len: int, *, device: Union[str, torch.device],
) -> QuantKVCache:
    """int8 values at 0 and scales at 1, as JAX `init_quant_kv_cache`."""
    shape = (cfg.num_layers, max_len, batch, cfg.num_kv_heads, cfg.head_dim)
    return QuantKVCache(
        k=torch.zeros(shape, dtype=torch.int8, device=device),
        v=torch.zeros(shape, dtype=torch.int8, device=device),
        k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
        v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
    )


def write_cache_chunk(cache: torch.Tensor, new: torch.Tensor, q_offset: Offset) -> None:
    """Write a chunk `new` (T, B, ...) into one layer's slot-major cache
    (S, B, ...) in place at slots q_offset + arange(T), with no host sync.

    q_offset is a Python int or a 0-d tensor (one position for the whole
    batch: JAX's dynamic_update_slice), or a (B,) tensor (a position per
    sample: JAX's scatter with mode="drop"), where slots at or past S are
    dropped: nothing is written for them and nothing wraps around. A
    dropped row is sent to slot p - T < start, which this chunk does not
    write, and writes back the value it finds there."""
    t = new.shape[0]
    new = new.to(cache.dtype)
    if isinstance(q_offset, int):
        cache[q_offset:q_offset + t].copy_(new)
        return
    rows = torch.arange(t, device=cache.device)
    if q_offset.ndim == 0:
        cache.index_copy_(0, q_offset + rows, new)
        return
    s, b = cache.shape[0], cache.shape[1]
    pos = q_offset.to(cache.device)[None, :] + rows[:, None]          # (T, B)
    keep = pos < s
    dst = torch.where(keep, pos, pos - t)
    col = torch.arange(b, device=cache.device)[None, :].expand(t, b)
    keep = keep.reshape(t, b, *([1] * (new.ndim - 2)))
    cache.index_put_((dst, col), torch.where(keep, new, cache[dst, col]))


def quantize_head_vectors(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (..., H) vector: (int8, f32 scale (..., 1)), scale
    amax / 127 with floor 1e-6 (JAX `_quantize_head_vectors`)."""
    xf = x.float()
    # amax / 127 as amax * f32(1 / 127), the form XLA folds it into
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-6) * (1.0 / 127.0)
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


# JAX `_remat_policy`: the checkpoint names each policy keeps across a
# block's recompute. save_mlp_q8 keeps none: JAX's int8 cast passes no
# gradient, so gate/up reach the input only through the scale's amax, whose
# backward needs the unquantized product: JAX recomputes it, as the port does.
REMAT_POLICIES: Dict[str, FrozenSet[str]] = {
    "none": frozenset(),
    "save_flash": frozenset({"flash_out"}),
    "save_mlp": frozenset({"mlp_gate", "mlp_up"}),
    "save_qkv_mlp": frozenset({"mlp_gate", "mlp_up", "qkv"}),
    "save_gate": frozenset({"mlp_gate"}),
    "save_gate_flash": frozenset({"mlp_gate", "flash_out"}),
    "save_mlp_q8": frozenset(),
}


def remat_saves(policy: Optional[str]) -> FrozenSet[str]:
    """The names `policy` keeps (None is "none"); raises for an unknown name."""
    name = "none" if policy is None else policy
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}")
    return REMAT_POLICIES[name]


def quant_saved(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX `_quant_saved`: per-token symmetric int8 of a saved residual,
    (int8 values, f32 scale (..., 1)); scale amax / 127, or 1 where amax is 0."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # amax / 127 as amax * f32(1 / 127), the form XLA folds the division into
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def dequant_saved(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """JAX `_dequant_saved`: q x scale in f32, rounded to bf16 (its default)."""
    return (q.float() * scale).to(torch.bfloat16)


def silu_per_op(x: torch.Tensor) -> torch.Tensor:
    """silu as jax.nn.silu lowers it, x * (1 / (1 + exp(-x))), each op
    rounded to x's dtype: bit-equal to JAX's in bf16, where F.silu (one
    rounding) differs in the last bit of about 40 % of the values."""
    return x * (1 / (1 + torch.exp(-x)))


class _Stash:
    """The tensors one block call keeps across its recompute: the names of
    a remat policy, and their values, stored by the block's first run and
    read by its recompute."""

    def __init__(self, names: FrozenSet[str]):
        self.names = names
        self.values: Dict[str, object] = {}


def lora_linear(layer: nn.Module, x: torch.Tensor, ab: Optional[Tuple[torch.Tensor, torch.Tensor]],
                use_kernel: Optional[bool] = None) -> torch.Tensor:
    """A block linear plus, with factors ab = (A (din, r), B scaled (r, dout)),
    the LoRA side path (x A) B, both factors in x's dtype (JAX `_lora_linear`)."""
    y = apply_linear(layer, x, use_kernel)
    if ab is None:
        return y
    a, b = ab
    return y + (x @ a.to(x.dtype)) @ b.to(x.dtype)


class _StashedLinear(torch.autograd.Function):
    """y = x @ W.T (+ the LoRA side path (x A) B when a and b are given),
    split to heads by `shape` and rotated when cos/sin are given, whose value
    a remat policy keeps under `key`: the first run computes and stores it
    (the LoRA term included), the recompute returns it without the products.
    The backward is the vector-Jacobian product of rope and the linear:
    dx = g W (+ (g B^T) A^T), dW = g^T x when W trains, and with LoRA
    dA = x^T (g B^T), dB = (x A)^T g."""

    @staticmethod
    def forward(ctx, x, weight, a, b, cos, sin, shape, stash, key):
        y = stash.values.get(key)
        if y is None:
            y = F.linear(x, weight)
            if a is not None:
                y = y + (x @ a) @ b
            if shape is not None:
                y = y.reshape(shape)
            if cos is not None:
                y = apply_rope(y, cos, sin)
            stash.values[key] = y.detach()
        else:
            y = y.detach()
        needs_x = weight.requires_grad or a is not None
        ctx.save_for_backward(x if needs_x else None, weight, a, b, cos, sin)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, a, b, cos, sin = ctx.saved_tensors
        if cos is not None:
            g = apply_rope_transpose(g, cos, sin)
        g = g.reshape(*g.shape[:2], -1)
        dx = g @ weight
        dw = da = db = None
        if ctx.needs_input_grad[1]:
            dw = g.reshape(-1, g.shape[-1]).T @ x.reshape(-1, x.shape[-1])
        if a is not None:
            gb = g @ b.T                                           # (B, T, r)
            dx = dx + gb @ a.T
            x2 = x.reshape(-1, x.shape[-1])
            if ctx.needs_input_grad[2]:
                da = x2.T @ gb.reshape(-1, gb.shape[-1])
            if ctx.needs_input_grad[3]:
                db = (x2 @ a).T @ g.reshape(-1, g.shape[-1])
        return dx, dw, da, db, None, None, None, None, None


def _mean_square(x: torch.Tensor) -> torch.Tensor:
    """Per-channel mean square over (B, T) in f32: (D,)."""
    return x.float().square().mean(dim=(0, 1))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, bias=False)
        h, nh, nkv, hd, m = (
            cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.mlp_dim
        )
        self.cfg = cfg
        self.attn_norm = RMSNorm(h, cfg.norm_eps, device=device, dtype=dtype)
        self.q_proj = nn.Linear(h, nh * hd, **kw)
        self.k_proj = nn.Linear(h, nkv * hd, **kw)
        self.v_proj = nn.Linear(h, nkv * hd, **kw)
        self.o_proj = nn.Linear(nh * hd, h, **kw)
        self.mlp_norm = RMSNorm(h, cfg.norm_eps, device=device, dtype=dtype)
        self.gate_proj = nn.Linear(h, m, **kw)
        self.up_proj = nn.Linear(h, m, **kw)
        self.down_proj = nn.Linear(m, h, **kw)

    def forward(
        self,
        h: torch.Tensor,                     # (B, T, D)
        cos: torch.Tensor,
        sin: torch.Tensor,
        *,
        kv_lengths: Optional[torch.Tensor],
        kv_starts: Optional[torch.Tensor],
        q_offset: Offset,
        cache_kv: Optional[Tuple[torch.Tensor, ...]],  # this layer's (S, B, Nkv, H) k, v [, scales]
        use_kernel: Optional[bool],
        stats_out: Optional[List[Dict[str, torch.Tensor]]] = None,
        stash: Optional[_Stash] = None,
        quant_saves: bool = False,
        lora: Optional[Mapping[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
    ) -> torch.Tensor:
        """JAX `_block_forward`. With a cache, the chunk's K/V are written into
        the cache IN PLACE at slots [q_offset, q_offset + T) (per sample for a
        (B,) offset: `write_cache_chunk`), after attention, which saw them
        unquantized, as extras (decode) or as the whole sequence (prefill). A
        4-tuple cache_kv is int8 + scales: the chunk is
        stored quantized per (token, head) vector. stats_out, when given, gets
        the per-input-channel mean square at each linear's input (calibration).
        stash: the remat policy's kept tensors (see the module docstring);
        quant_saves: gate and up pass through `quant_saved` /
        `dequant_saved` (the save_mlp_q8 policy); lora: this layer's
        {target: (A (din, r), B scaled (r, dout))}."""
        cfg = self.cfg
        b, t, _ = h.shape
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        keeps = stash.names if stash is not None else frozenset()

        def record(**sites):
            if stats_out is not None:
                stats_out.append({k: _mean_square(v) for k, v in sites.items()})

        def side(name):
            return None if lora is None else lora.get(name)

        def kept(name, key, x, shape=None, rope=False):
            layer = getattr(self, name)
            ab = side(name)
            if key.split(".")[0] in keeps:
                a, b_ = (None, None) if ab is None else (ab[0].to(x.dtype), ab[1].to(x.dtype))
                return _StashedLinear.apply(
                    x, layer.weight, a, b_, cos if rope else None, sin if rope else None,
                    shape, stash, key,
                )
            y = lora_linear(layer, x, ab, use_kernel)
            y = y if shape is None else y.reshape(shape)
            return apply_rope(y, cos, sin) if rope else y

        x = self.attn_norm(h)
        record(q_proj=x, k_proj=x, v_proj=x)
        q = kept("q_proj", "qkv.q", x, (b, t, nh, hd), rope=True)
        k = kept("k_proj", "qkv.k", x, (b, t, nkv, hd), rope=True)
        v = kept("v_proj", "qkv.v", x, (b, t, nkv, hd))

        quant = cache_kv is not None and len(cache_kv) == 4
        # only a Python int 0 with T > 1 is a prefill over an empty cache (JAX's
        # routing): a tensor offset, even 0, takes the cache route
        prefill = isinstance(q_offset, int) and q_offset == 0 and t > 1
        if cache_kv is not None and not prefill:
            attn = mha_plain_cache(
                q, cache_kv[0], cache_kv[1],
                k_scale=cache_kv[2] if quant else None, v_scale=cache_kv[3] if quant else None,
                extra_k=k, extra_v=v, cache_len=q_offset, kv_starts=kv_starts,
            )
        else:
            # prefill (empty cache) or cacheless: attention over the chunk itself,
            # eligible for the flash kernel incl. the left-pad kv_starts mask
            attn = multi_head_attention(
                q, k, v, causal=True, q_offset=q_offset, kv_lengths=kv_lengths,
                kv_starts=kv_starts, use_kernel=use_kernel,
                saved=stash.values.setdefault("flash_out", []) if "flash_out" in keeps else None,
            )
        if cache_kv is not None:
            kt, vt = k.transpose(0, 1), v.transpose(0, 1)     # slot-major (T, B, Nkv, H)
            if quant:
                for new, values, scales in ((kt, cache_kv[0], cache_kv[2]),
                                            (vt, cache_kv[1], cache_kv[3])):
                    qv, sc = quantize_head_vectors(new)
                    write_cache_chunk(values, qv, q_offset)
                    write_cache_chunk(scales, sc[..., 0], q_offset)
            else:
                write_cache_chunk(cache_kv[0], kt, q_offset)
                write_cache_chunk(cache_kv[1], vt, q_offset)

        attn = attn.reshape(b, t, nh * hd)
        record(o_proj=attn)
        h = h + lora_linear(self.o_proj, attn, side("o_proj"), use_kernel)
        x = self.mlp_norm(h)
        record(gate_proj=x, up_proj=x)
        gate_pre = kept("gate_proj", "mlp_gate", x)
        up = kept("up_proj", "mlp_up", x)
        if quant_saves:
            # fwd and bwd both see the dequantized bf16 values, as in JAX
            gate_pre = dequant_saved(*quant_saved(gate_pre))
            up = dequant_saved(*quant_saved(up))
            # the product in down_proj's dtype: JAX's dot promotes the bf16
            # product to an f32 kernel's dtype, and XLA folds the rounding
            # between them away (a bf16 x bf16 product is exact in f32)
            wdt = self.down_proj.weight.dtype
            gu = silu_per_op(gate_pre).to(wdt) * up.to(wdt)
        else:
            gu = F.silu(gate_pre) * up
        record(down_proj=gu)
        return h + lora_linear(self.down_proj, gu, side("down_proj"), use_kernel)


class Decoder(nn.Module):
    """Token embedding, blocks, final norm and lm head (JAX `init_decoder` params)."""

    def __init__(self, cfg: DecoderConfig, device=None, dtype=None):
        super().__init__()
        if cfg.moe_experts:
            raise NotImplementedError("MoE decoders are not ported yet")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.blocks = nn.ModuleList(DecoderBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, **kw)
        self.lm_head = (
            None if cfg.tie_embeddings
            else nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False, **kw)
        )

    def logits(self, hidden: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
        """Output projection in the model dtype (a quantized lm_head goes
        through its QuantLinear), returned as f32."""
        if self.lm_head is None:
            return (hidden @ self.embed_tokens.weight.T).float()
        return apply_linear(self.lm_head, hidden, use_kernel).float()

    def forward(
        self,
        inputs_embeds: torch.Tensor,                  # (B, T, D)
        *,
        positions: Optional[torch.Tensor] = None,     # (B, T) or (T,); default arange
        kv_lengths: Optional[torch.Tensor] = None,    # (B,) valid kv length incl. this chunk
        kv_starts: Optional[torch.Tensor] = None,     # (B,) first valid kv slot (left pad)
        cache: Optional[Union[KVCache, QuantKVCache]] = None,
        q_offset: Offset = 0,
        use_kernel: Optional[bool] = None,
        compute_logits: bool = True,
        tap_layers: Tuple[int, ...] = (),            # 0-indexed block outputs to keep
        remat: bool = False,
        remat_policy: Optional[str] = None,
        lora: Optional[Mapping[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
    ) -> Dict[str, object]:
        """JAX `decoder_forward`: {'hidden' (final-normed), 'logits' (f32, when
        compute_logits), 'taps' (tuple of the raw block outputs at tap_layers,
        before the final norm), 'cache' (the same cache object, updated in
        place, when one was passed)}. remat: each block is checkpointed while
        autograd records, keeping what `remat_policy` names (`REMAT_POLICIES`).
        lora: {target: (A (L, din, r), B scaled (L, r, dout))}, the side path
        of every targeted linear (models/lora.py `lora_side_factors`).

        q_offset is the chunk's first slot: a Python int, a 0-d tensor (one
        position for the whole batch) or a (B,) tensor (a position per
        sample; the serving engine's slots). Only an int 0 with T > 1 runs
        attention over the chunk itself (the flash kernel on CUDA); with a
        cache every other offset, a tensor 0 included, attends through
        `mha_plain_cache`, as JAX routes a traced offset. Tensor offsets stay
        on the device: nothing here reads them on the host."""
        cfg = self.cfg
        saves = remat_saves(remat_policy) if remat else None
        quant_saves = remat and remat_policy == "save_mlp_q8"
        if remat and cache is not None:
            raise ValueError("remat is a training feature (no cache)")
        t = inputs_embeds.shape[1]
        if tap_layers:
            if max(tap_layers) >= cfg.num_layers:
                raise ValueError(f"tap layers {tap_layers} out of range for {cfg.num_layers} layers")
            if cache is not None:
                raise ValueError("layer taps are a training/prefill feature (no cache)")
        if positions is None:
            positions = torch.arange(t, device=inputs_embeds.device) + (
                q_offset if isinstance(q_offset, int) else q_offset.reshape(-1, 1))
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        if cos.ndim == 2:
            cos, sin = cos[None], sin[None]
        h = inputs_embeds
        taps = {}
        for i, block in enumerate(self.blocks):
            kw = dict(kv_lengths=kv_lengths, kv_starts=kv_starts, q_offset=q_offset,
                      cache_kv=None if cache is None else cache.layer(i),
                      use_kernel=use_kernel, quant_saves=quant_saves,
                      lora=None if lora is None else {n: (a[i], b[i]) for n, (a, b) in lora.items()})
            if remat and torch.is_grad_enabled():
                h = checkpoint(block, h, cos, sin, stash=_Stash(saves), **kw,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                h = block(h, cos, sin, **kw)
            if i in tap_layers:
                taps[i] = h
        hidden = self.final_norm(h)
        out: Dict[str, object] = {
            "hidden": hidden, "cache": cache, "taps": tuple(taps[i] for i in tap_layers),
        }
        if compute_logits:
            out["logits"] = self.logits(hidden, use_kernel)
        return out


def _quantized(linear: nn.Linear, mode: str, rms: Optional[torch.Tensor]) -> nn.Module:
    w = linear.weight.detach().T                     # input-major (din, dout)
    if mode == "int8":
        return QuantLinear(**quantize_linear_int8(w))
    buffers = quantize_linear_int4(w, act_rms=rms)
    return linear if buffers is None else QuantLinear(**buffers)


@torch.no_grad()
def quantize_decoder(
    decoder: Decoder,
    mode: str,
    act_rms: Optional[Mapping[str, object]] = None,
) -> Decoder:
    """A NEW decoder for serving whose seven block linears (and lm_head when
    untied) are `QuantLinear`s: mode "int8" (w8a16, JAX
    `quantize_linear_weights`) or "int4" (w4a16, JAX
    `quantize_linear_weights_int4` at its defaults, group 128; a layer whose
    din no group size divides stays dense). act_rms: AWQ calibration for
    "int4", {proj name: (L, din), "lm_head": (din,)} from
    serve/calibrate.decoder_act_rms (tensors or arrays); an entry of another
    shape is ignored, as in JAX.

    The embedding and the norms are the caller's modules, shared; the
    caller's decoder is left as it was (JAX quantizes a copy of the tree)."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown weight quantization {mode!r}")
    cfg = decoder.cfg
    device = decoder.embed_tokens.weight.device
    rms = {}
    if mode == "int4" and act_rms:
        rms = {k: v.to(device) if torch.is_tensor(v) else torch.tensor(v, device=device)
               for k, v in act_rms.items()}
    with torch.device("meta"):
        out = Decoder(cfg)
    out.embed_tokens = decoder.embed_tokens
    out.final_norm = decoder.final_norm
    for i, (src, dst) in enumerate(zip(decoder.blocks, out.blocks)):
        dst.attn_norm, dst.mlp_norm = src.attn_norm, src.mlp_norm
        for name in LINEAR_NAMES:
            lin = getattr(src, name)
            r = rms.get(name)
            r = r[i] if r is not None and tuple(r.shape) == (cfg.num_layers, lin.in_features) else None
            setattr(dst, name, _quantized(lin, mode, r))
    if decoder.lm_head is not None:
        out.lm_head = _quantized(decoder.lm_head, mode, rms.get("lm_head"))
    return out.eval()
