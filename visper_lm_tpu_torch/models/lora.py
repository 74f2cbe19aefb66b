"""LoRA adapters for the decoder trunk (counterpart of visper_lm_tpu/models/lora.py).

The reference's peft LoRA on the LLM linears (r 64, alpha 16). As in the JAX
package the factors of each target are stacked over the layers, A (L, din, r)
and B (L, r, dout), in f32, under the VLM's `lora` module (state-dict names
`lora.<target>.a` / `.b`, JAX paths `lora/<target>/a`, which the "lora"
stage trains). In training they ride the decoder as a side path,
y = x W + (x A)(B scaling), in every targeted linear of a block
(models/decoder.py), with the scaling baked into B once per forward
(`lora_side_factors`); `merge_lora_into_decoder` folds W + scaling A B into
the weights for serving.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from visper_lm_tpu_torch.config import DecoderConfig, LoraConfig


def kernel_dims(cfg: DecoderConfig, name: str) -> Tuple[int, int]:
    """(din, dout) of a block linear."""
    h, nh, nkv, hd, m = (
        cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.mlp_dim
    )
    return {
        "q_proj": (h, nh * hd), "k_proj": (h, nkv * hd), "v_proj": (h, nkv * hd),
        "o_proj": (nh * hd, h), "gate_proj": (h, m), "up_proj": (h, m), "down_proj": (m, h),
    }[name]


class LoraFactors(nn.Module):
    """One target's stacked factors: a (L, din, r), b (L, r, dout)."""

    def __init__(self, layers: int, din: int, dout: int, r: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.a = nn.Parameter(torch.zeros(layers, din, r, device=device, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(layers, r, dout, device=device, dtype=dtype))


def build_lora(cfg: DecoderConfig, lora_cfg: LoraConfig, device=None,
               dtype: torch.dtype = torch.float32) -> nn.ModuleDict:
    """The factors of every target (zeros; `init_lora_` draws them)."""
    return nn.ModuleDict({
        name: LoraFactors(cfg.num_layers, *kernel_dims(cfg, name), lora_cfg.r, device, dtype)
        for name in lora_cfg.targets
    })


@torch.no_grad()
def init_lora_(lora: nn.ModuleDict, generator: torch.Generator) -> nn.ModuleDict:
    """JAX `init_lora`: A ~ N(0, 1/r), B = 0, so the initial delta is zero."""
    for factors in lora.values():
        r = factors.a.shape[-1]
        factors.a.normal_(0.0, 1.0, generator=generator).div_(torch.tensor(float(r)).sqrt())
        factors.b.zero_()
    return lora


def init_lora(cfg: DecoderConfig, lora_cfg: LoraConfig, *, device, seed: int = 0) -> nn.ModuleDict:
    """Seeded factors on `device` (JAX `init_lora`: the distributions, not its numbers)."""
    lora = build_lora(cfg, lora_cfg, device=device)
    return init_lora_(lora, torch.Generator(device=device).manual_seed(seed))


def lora_side_factors(
    lora: Optional[nn.ModuleDict], lora_cfg: Optional[LoraConfig]
) -> Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]:
    """{target: (A (L, din, r), B scaled (L, r, dout))} for the decoder's
    side path: the scaling multiplies B in its own dtype, as JAX's decoder
    does at the start of its forward (differentiable: dA and dB flow)."""
    if lora is None or lora_cfg is None:
        return None
    return {name: (f.a, f.b * lora_cfg.scaling) for name, f in lora.items()}


@torch.no_grad()
def merge_lora_into_decoder(decoder: nn.Module, lora: nn.ModuleDict, lora_cfg: LoraConfig) -> None:
    """Fold the adapters into the decoder's weights in place: W + scaling A B
    per layer, summed in f32 and rounded to W's dtype (JAX
    `merge_lora_into_decoder`; the reference's merge-on-load)."""
    for name, f in lora.items():
        delta = torch.einsum("lir,lro->lio", f.a.float(), f.b.float()) * lora_cfg.scaling
        for i, block in enumerate(decoder.blocks):
            w = getattr(block, name).weight                  # (dout, din)
            w.copy_((w.float() + delta[i].T).to(w.dtype))


def apply_lora(model: nn.Module) -> nn.Module:
    """JAX `apply_lora`: a VLM with adapters gets them folded into its
    decoder and dropped (its forward then runs the merged weights alone);
    a VLM without is returned as it is. In place; returns the model."""
    if getattr(model, "lora", None) is None:
        return model
    merge_lora_into_decoder(model.decoder, model.lora, model.cfg.lora)
    model.lora = None
    return model
