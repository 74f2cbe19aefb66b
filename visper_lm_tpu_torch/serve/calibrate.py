"""AWQ-style activation calibration for int4 serving weights (counterpart of
visper_lm_tpu/serve/calibrate.py).

Round-to-nearest int4 error is dominated by the input channels with the
largest activations. AWQ (Lin et al., 2023) scales those weight rows up before
quantization and the activations down at run time (`QuantLinear`'s
q4_in_scale), spending the 4-bit budget where the products concentrate. This
module measures the per-input-channel activation RMS at every linear's input.

    rms = decoder_act_rms(model.decoder, cfg.decoder, [embeds1, embeds2])
    qdec = quantize_decoder(model.decoder, "int4", act_rms=rms)

or pass `calibration=rms` through serve.generate.GenerationConfig.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from visper_lm_tpu_torch.config import DecoderConfig
from visper_lm_tpu_torch.models.decoder import Decoder
from visper_lm_tpu_torch.models.rope import rope_cos_sin


@torch.no_grad()
def decoder_act_rms(
    decoder: Decoder,
    cfg: DecoderConfig,
    embeds_batches: Sequence[torch.Tensor],
    *,
    include_lm_head: bool = True,
) -> Dict[str, torch.Tensor]:
    """Per-input-channel activation RMS at every linear's input site.

    Replays the blocks over each (B, T, D) inputs-embeds batch with no cache
    and no masks beyond causality (positions 0..T-1, plain attention, as JAX
    does) and takes the mean square of each linear's input; batches are
    weighted by B x T. Returns {proj name: (L, din) f32} for the block's
    projections (the seven, or a MoE block's four attention ones: JAX
    records no site in the MoE MLP), and {"lm_head": (din,)} when the head is untied (and
    include_lm_head)."""
    acc: Optional[Dict[str, torch.Tensor]] = None
    total = 0
    for embeds in embeds_batches:
        h = embeds
        t = embeds.shape[1]
        cos, sin = rope_cos_sin(torch.arange(t, device=h.device), cfg.head_dim, cfg.rope_theta)
        per_layer: List[Dict[str, torch.Tensor]] = []
        for block in decoder.blocks:
            stats: List[Dict[str, torch.Tensor]] = []
            h = block(
                h, cos[None], sin[None], kv_lengths=None, kv_starts=None, q_offset=0,
                cache_kv=None, use_kernel=False, stats_out=stats,
            )
            if block.moe:                  # (h, aux): a MoE block's MLP has no linear to scale
                h = h[0]
            per_layer.append({k: v for s in stats for k, v in s.items()})
        ms = {name: torch.stack([p[name] for p in per_layer]) for name in per_layer[0]}
        if include_lm_head and decoder.lm_head is not None:
            ms["lm_head"] = decoder.final_norm(h).float().square().mean(dim=(0, 1))
        w = embeds.shape[0] * embeds.shape[1]
        acc = {k: v * w for k, v in ms.items()} if acc is None else {
            k: acc[k] + v * w for k, v in ms.items()
        }
        total += w
    if acc is None:
        raise ValueError("decoder_act_rms needs at least one calibration batch")
    return {k: torch.sqrt(v / total) for k, v in acc.items()}
