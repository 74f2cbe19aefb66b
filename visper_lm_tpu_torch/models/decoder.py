"""Decoder-only transformer (counterpart of visper_lm_tpu/models/decoder.py).

Covers Phi3-mini-4k and Llama-style decoders for serving: pre-norm blocks
with GQA attention, rope and a SiLU-gated MLP, and a slot-major KV cache.
The JAX layer `lax.scan` over stacked blocks becomes a Python loop over an
`nn.ModuleList`; remat, layer taps, LoRA, MoE, the quantized cache and the
pipelined stack are training or later-slice machinery and are not here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

from visper_lm_tpu_torch.config import DecoderConfig
from visper_lm_tpu_torch.models.rope import apply_rope, rope_cos_sin
from visper_lm_tpu_torch.ops.attention import mha_plain_cache, multi_head_attention
from visper_lm_tpu_torch.utils.param import RMSNorm


@dataclasses.dataclass
class KVCache:
    """Slot-major cache (L, S_max, B, Nkv, H), the JAX package's layout: one
    decode step writes one contiguous (B, Nkv, H) slab per layer."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[1]


def init_kv_cache(
    cfg: DecoderConfig, batch: int, max_len: int, *, dtype: torch.dtype = torch.bfloat16,
    device: Union[str, torch.device],
) -> KVCache:
    shape = (cfg.num_layers, max_len, batch, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


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
        q_offset: int,
        cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]],  # this layer's (S, B, Nkv, H)
        use_kernel: Optional[bool],
    ) -> torch.Tensor:
        """JAX `_block_forward`. With a cache, the chunk's K/V are written into
        the cache IN PLACE at slots [q_offset, q_offset + T), after attention,
        which saw them as extras (decode) or as the whole sequence (prefill)."""
        cfg = self.cfg
        b, t, _ = h.shape
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        x = self.attn_norm(h)
        q = apply_rope(self.q_proj(x).reshape(b, t, nh, hd), cos, sin)
        k = apply_rope(self.k_proj(x).reshape(b, t, nkv, hd), cos, sin)
        v = self.v_proj(x).reshape(b, t, nkv, hd)

        if cache_kv is not None and not (q_offset == 0 and t > 1):
            ck, cv = cache_kv
            attn = mha_plain_cache(
                q, ck, cv, extra_k=k, extra_v=v, cache_len=q_offset, kv_starts=kv_starts,
            )
        else:
            # prefill (empty cache) or cacheless: attention over the chunk itself,
            # eligible for the flash kernel incl. the left-pad kv_starts mask
            attn = multi_head_attention(
                q, k, v, causal=True, q_offset=q_offset, kv_lengths=kv_lengths,
                kv_starts=kv_starts, use_kernel=use_kernel,
            )
        if cache_kv is not None:
            ck, cv = cache_kv
            ck[q_offset:q_offset + t].copy_(k.transpose(0, 1))  # in place
            cv[q_offset:q_offset + t].copy_(v.transpose(0, 1))  # in place

        h = h + self.o_proj(attn.reshape(b, t, nh * hd))
        x = self.mlp_norm(h)
        gate = torch.nn.functional.silu(self.gate_proj(x))
        return h + self.down_proj(gate * self.up_proj(x))


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

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Output projection in the model dtype, returned as f32."""
        if self.lm_head is None:
            return (hidden @ self.embed_tokens.weight.T).float()
        return self.lm_head(hidden).float()

    def forward(
        self,
        inputs_embeds: torch.Tensor,                  # (B, T, D)
        *,
        positions: Optional[torch.Tensor] = None,     # (B, T) or (T,); default arange
        kv_lengths: Optional[torch.Tensor] = None,    # (B,) valid kv length incl. this chunk
        kv_starts: Optional[torch.Tensor] = None,     # (B,) first valid kv slot (left pad)
        cache: Optional[KVCache] = None,
        q_offset: int = 0,
        use_kernel: Optional[bool] = None,
        compute_logits: bool = True,
    ) -> Dict[str, object]:
        """JAX `decoder_forward` with tap_layers=(): {'hidden' (final-normed),
        'logits' (f32, when compute_logits), 'cache' (the same cache object,
        updated in place, when one was passed)}."""
        cfg = self.cfg
        t = inputs_embeds.shape[1]
        if positions is None:
            positions = torch.arange(t, device=inputs_embeds.device) + q_offset
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        if cos.ndim == 2:
            cos, sin = cos[None], sin[None]
        h = inputs_embeds
        for i, block in enumerate(self.blocks):
            h = block(
                h, cos, sin, kv_lengths=kv_lengths, kv_starts=kv_starts,
                q_offset=q_offset,
                cache_kv=None if cache is None else (cache.k[i], cache.v[i]),
                use_kernel=use_kernel,
            )
        hidden = self.final_norm(h)
        out: Dict[str, object] = {"hidden": hidden, "cache": cache}
        if compute_logits:
            out["logits"] = self.logits(hidden)
        return out
