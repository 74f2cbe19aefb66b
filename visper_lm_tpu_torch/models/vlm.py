"""LLaVA / OLA-VLM assembly for serving (counterpart of visper_lm_tpu/models/vlm.py).

The host collator lowers every example to a fixed-length splice plan
(data/collate.py) and the model builds inputs_embeds with one gather-select.
Prompt layout:

    [ sys | image (576) | task tokens (num_task_tokens per task, mode order) | text | pad ]

The distillation heads do not run when serving and are not part of this
model; `weights.from_jax_params` skips their parameters.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn

from visper_lm_tpu_torch import constants
from visper_lm_tpu_torch.config import VLMConfig
from visper_lm_tpu_torch.device import resolve_device
from visper_lm_tpu_torch.models.decoder import Decoder
from visper_lm_tpu_torch.models.projector import Projector
from visper_lm_tpu_torch.models.vit import VisionTower, clip_tower_features
from visper_lm_tpu_torch.utils.param import embed, init_weights_, torch_dtype


class VLM(nn.Module):
    """Decoder + CLIP tower + projector + task-token parameters."""

    def __init__(self, cfg: VLMConfig, device=None):
        super().__init__()
        if cfg.use_convnext_tower or cfg.lora is not None:
            raise NotImplementedError("ConvNeXt towers and LoRA are not ported yet")
        if cfg.image_aspect_ratio == "anyres" or "unpad" in cfg.mm_patch_merge_type:
            raise NotImplementedError("anyres tiling is not ported yet")
        self.cfg = cfg
        dtype = torch_dtype(cfg.decoder.dtype)
        self.decoder = Decoder(cfg.decoder, device=device, dtype=dtype)
        self.vision_tower = VisionTower(
            cfg.vision, device=device, dtype=torch_dtype(cfg.vision.dtype)
        )
        self.mm_projector = Projector(cfg.projector, device=device, dtype=dtype)
        self.special_tokens = nn.ParameterDict()
        d = cfg.distill
        if d is not None and d.num_task_tokens > 0:
            for task in d.task_order():
                tcfg = d.get_task(task)
                if tcfg is None:
                    continue
                rows = d.num_task_tokens if task == "gen" else tcfg.head.num_tokens
                if rows % d.num_task_tokens:
                    raise ValueError(f"{task}: {rows} rows do not pool to {d.num_task_tokens}")
                self.special_tokens[task] = nn.Parameter(
                    torch.zeros(rows, cfg.decoder.hidden_size, device=device, dtype=dtype)
                )


def init_vlm(
    cfg: VLMConfig, *, device: Optional[Union[str, torch.device]] = None, seed: int = 0
) -> VLM:
    """The serving subset of JAX `init_vlm`, with seeded random weights made
    on `device` (CUDA when None) by a torch.Generator."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = VLM(cfg)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_weights_(model, gen)
    with torch.no_grad():
        model.vision_tower.pos_embed.zero_()
        model.vision_tower.cls_token.zero_()
        for p in model.special_tokens.values():
            p.normal_(0.0, 1.0, generator=gen)
    return model.eval()


def build_task_token_table(model: VLM) -> Optional[torch.Tensor]:
    """(num_task_tokens * n_tasks, hidden) rows in mode order: depth/seg
    parameters group-mean-pooled to num_task_tokens rows, gen rows as they are."""
    d = model.cfg.distill
    if d is None or d.num_task_tokens == 0:
        return None
    rows = []
    for task in d.task_order():
        if task not in model.special_tokens:
            continue
        tok = model.special_tokens[task]
        if task == "gen":
            rows.append(tok)
        else:
            rows.append(tok.reshape(d.num_task_tokens, -1, tok.shape[-1]).mean(dim=1))
    return torch.cat(rows, dim=0)


def encode_images(model: VLM, images: torch.Tensor) -> torch.Tensor:
    """Vision tower + projector for square images (B, H, W, 3) -> (B, N, llm_hidden)."""
    if images.ndim != 4:
        raise NotImplementedError("only square (B, H, W, 3) images; anyres tiles come later")
    return model.mm_projector(clip_tower_features(model.vision_tower, images))


def splice_embeddings(
    model: VLM,
    text_ids: torch.Tensor,                 # (B, T) token id at TEXT positions
    token_type: torch.Tensor,               # (B, T) SEG_* codes
    src_index: torch.Tensor,                # (B, T) image-patch / task-token row
    image_features: Optional[torch.Tensor], # (B, N_img, hidden) or None (text only)
) -> torch.Tensor:
    """Vectorized gather-select splice -> (B, T, hidden)."""
    text_emb = embed(model.decoder.embed_tokens.weight, text_ids)
    dtype = text_emb.dtype
    emb = text_emb
    if image_features is not None:
        idx = src_index.clamp(0, image_features.shape[1] - 1)
        img = torch.gather(
            image_features.to(dtype), 1,
            idx[..., None].expand(-1, -1, image_features.shape[-1]),
        )
        emb = torch.where((token_type == constants.SEG_IMAGE)[..., None], img, emb)
    table = build_task_token_table(model)
    if table is not None:
        task = table.to(dtype)[src_index.clamp(0, table.shape[0] - 1)]
        emb = torch.where((token_type == constants.SEG_TASK)[..., None], task, emb)
    return torch.where(
        (token_type == constants.SEG_PAD)[..., None], torch.zeros_like(emb), emb
    )
