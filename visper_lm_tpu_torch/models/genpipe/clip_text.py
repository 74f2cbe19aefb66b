"""The CLIP text encoder of SD-2.x, OpenCLIP-ViT-H's (counterpart of
visper_lm_tpu/models/genpipe/clip_text.py).

The unCLIP pipeline conditions the UNet's cross-attention on
text_encoder(prompt).last_hidden_state; the reference's call sites always
pass the empty prompt. SD-2.1's encoder: vocab 49408, width 1024, 23 layers,
16 heads, MLP 4096, exact GELU, a causal mask, a final LayerNorm. Attention
is `torch.matmul` and `softmax` (JAX leaves it to XLA's einsum).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from visper_lm_tpu_torch.utils.param import LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    mlp_dim: int = 4096
    max_positions: int = 77
    norm_eps: float = 1e-5
    # the tokenizer's specials (stock CLIP BPE); SD-2.x pads with "!" (id 0)
    bos_token_id: int = 49406
    eos_token_id: int = 49407
    pad_token_id: int = 0


class TextBlock(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.ln1 = LayerNorm(d, cfg.norm_eps, **kw)
        self.q_proj, self.k_proj, self.v_proj, self.o_proj = (
            nn.Linear(d, d, **kw) for _ in range(4))
        self.ln2 = LayerNorm(d, cfg.norm_eps, **kw)
        self.fc1 = nn.Linear(d, cfg.mlp_dim, **kw)
        self.fc2 = nn.Linear(cfg.mlp_dim, d, **kw)


class CLIPText(nn.Module):
    """JAX `init_clip_text`'s tree (its stacked blocks one module each)."""

    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_positions, cfg.hidden_size, **kw))
        self.blocks = nn.ModuleList(TextBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(cfg.hidden_size, cfg.norm_eps, **kw)


def clip_text_forward(p: CLIPText, cfg: CLIPTextConfig, input_ids: torch.Tensor) -> torch.Tensor:
    """(B, T) token ids -> (B, T, hidden) final hidden states (after the final LN)."""
    b, t = input_ids.shape
    x = p.token_embedding(input_ids.long()) + p.position_embedding[None, :t]
    causal = torch.full((t, t), float("-inf"), device=x.device).triu(1)
    h, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    for blk in p.blocks:
        r = blk.ln1(x)
        q, k, v = (proj(r).reshape(b, t, h, hd).transpose(1, 2)
                   for proj in (blk.q_proj, blk.k_proj, blk.v_proj))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(scores.float() + causal, dim=-1).to(x.dtype)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, -1)
        x = x + blk.o_proj(attn)
        x = x + blk.fc2(F.gelu(blk.fc1(blk.ln2(x)), approximate="none"))
    return p.final_ln(x)


def empty_prompt_ids(cfg: CLIPTextConfig, device=None) -> torch.Tensor:
    """The empty prompt's ids: [BOS, EOS, PAD x (max - 2)], (1, max_positions)."""
    ids = torch.full((1, cfg.max_positions), cfg.pad_token_id, dtype=torch.long, device=device)
    ids[0, 0], ids[0, 1] = cfg.bos_token_id, cfg.eos_token_id
    return ids
