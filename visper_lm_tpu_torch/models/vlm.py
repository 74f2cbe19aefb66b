"""LLaVA / OLA-VLM assembly (counterpart of visper_lm_tpu/models/vlm.py).

The host collator lowers every example to a fixed-length splice plan
(data/collate.py) and the model builds inputs_embeds with one gather-select.
Prompt layout:

    [ sys | image (576) | task tokens (num_task_tokens per task, mode order) | text | pad ]

The tower is CLIP-ViT (`models/vit.py`) or, with cfg.use_convnext_tower, the
ConvNeXt trunk (`models/convnext.py`). `encode_images` also takes anyres tiles
(B, n_tiles, H, W, 3): every tile goes through the tower in one batch, and
with an "unpad" merge type the learned image_newline row is appended after
the tiles' rows (data/anyres.py's index plans gather from that layout).

Serving runs the decoder only; training (`vlm_forward` with taps) also runs
the distillation heads on static slices of the tapped layer states
(`predict_task_embeddings`). With cfg.lora the VLM owns the LoRA factors
(`lora`, models/lora.py), and `vlm_forward` runs them as the decoder's side
path, never merged inside the step (JAX's choice: the merged form's backward
carries a full (din, dout) cotangent per target to reach A and B).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn

from visper_lm_tpu_torch import constants
from visper_lm_tpu_torch.config import VLMConfig
from visper_lm_tpu_torch.device import resolve_device
from visper_lm_tpu_torch.models.convnext import ConvNeXt, convnext_tower_features, init_convnext_
from visper_lm_tpu_torch.models.decoder import Decoder
from visper_lm_tpu_torch.models.heads import TaskHead, task_head_forward
from visper_lm_tpu_torch.models.lora import build_lora, init_lora_, lora_side_factors
from visper_lm_tpu_torch.models.projector import Projector
from visper_lm_tpu_torch.models.resampler import Resampler
from visper_lm_tpu_torch.models.vit import VisionTower, clip_tower_features, init_tower_
from visper_lm_tpu_torch.parallel.pipeline import (
    foreign_blocks_detached,
    materialize_foreign,
    shard_pipeline,
)
from visper_lm_tpu_torch.parallel.sequence import local_rows
from visper_lm_tpu_torch.parallel.tensor import model_placements, shard_model
from visper_lm_tpu_torch.utils.param import init_weights_, torch_dtype


def tap_layer_union(cfg: VLMConfig) -> Tuple[int, ...]:
    """Sorted union of all tasks' tapped layers."""
    if cfg.distill is None:
        return ()
    layers = set()
    for t in cfg.distill.tasks:
        layers.update(t.layer_indices)
    return tuple(sorted(layers))


class VLM(nn.Module):
    """Decoder + vision tower (CLIP-ViT or ConvNeXt) + projector + task-token
    parameters; image_newline (the decoder's width) with an "unpad" merge
    type, else None; with a distill config the heads (per task, one per
    tapped layer) and the contrastive logit scales (f32); with a LoRA config
    the adapters' stacked f32 factors (`lora.<target>.a` / `.b`), else None."""

    def __init__(self, cfg: VLMConfig, device=None, ep=None):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.decoder.dtype)
        self.decoder = Decoder(cfg.decoder, device=device, dtype=dtype, ep=ep)
        if cfg.use_convnext_tower:
            self.vision_tower = ConvNeXt(
                cfg.convnext, device=device, dtype=torch_dtype(cfg.convnext.dtype))
        else:
            self.vision_tower = VisionTower(
                cfg.vision, device=device, dtype=torch_dtype(cfg.vision.dtype))
        self.mm_projector = Projector(cfg.projector, device=device, dtype=dtype)
        self.lora = None if cfg.lora is None else build_lora(cfg.decoder, cfg.lora, device=device)
        self.register_parameter("image_newline", nn.Parameter(
            torch.zeros(cfg.decoder.hidden_size, device=device, dtype=dtype))
            if "unpad" in cfg.mm_patch_merge_type else None)
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
        self.heads = nn.ModuleDict()
        self.logit_scales = nn.ParameterDict()
        if d is not None:
            for tcfg in d.tasks:
                self.heads[tcfg.task] = nn.ModuleList(
                    TaskHead(
                        tcfg, cfg.decoder.hidden_size, num_task_tokens=d.num_task_tokens,
                        use_intermediate_depth=True, device=device, dtype=dtype,
                    )
                    for _ in tcfg.layer_indices
                )
                if d.use_contrastive:
                    self.logit_scales[tcfg.task] = nn.Parameter(
                        torch.zeros((), device=device, dtype=torch.float32)
                    )


def init_vlm(
    cfg: VLMConfig, *, device: Optional[Union[str, torch.device]] = None, seed: int = 0,
    tp=None, pp=None, ep=None,
) -> VLM:
    """JAX `init_vlm`, with seeded random weights made on `device` (CUDA when
    None) by a torch.Generator: the JAX distributions, not its numbers.

    tp (a parallel/tensor.TensorParallel): the rank's tensor-parallel form,
    cut on the meta device (`shard_model`); each split parameter is drawn
    whole, one at a time, in the one-device order, and only the rank's slice
    is kept: the same numbers as the whole model's, and never the whole
    decoder on the device.

    pp (a parallel/pipeline.PipeParallel): the stage's form, cut on the
    meta device (`shard_pipeline`): the blocks another stage owns are never
    allocated (drawn one tensor at a time and dropped, so the stage's own
    blocks get the whole model's numbers).

    ep (an parallel/distributed.AxisGroup over the 'expert' axis): a MoE decoder's rank
    allocates only its E/ep experts of each bank (each bank drawn whole and
    the rank's experts kept: the whole model's numbers). The router stays
    f32 in a bf16 model (JAX's dtype cast skips it)."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = shard_pipeline(shard_model(VLM(cfg, ep=ep), tp), pp)
    with foreign_blocks_detached(model):
        model = model.to_empty(device=device)
    materialize_foreign(model, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    plan = model_placements(model)
    whole = {id(model.get_parameter(n)): (pl, tp.rank) for n, pl in plan.items()}
    init_weights_(model, gen, whole=whole)
    if cfg.use_convnext_tower:
        init_convnext_(model.vision_tower, gen)
    else:
        init_tower_(model.vision_tower, gen)
    if model.lora is not None:
        init_lora_(model.lora, gen)
    with torch.no_grad():
        if model.image_newline is not None:
            model.image_newline.zero_()
        for p in model.special_tokens.values():
            p.normal_(0.0, 1.0, generator=gen)
        for p in model.logit_scales.values():
            p.fill_(2.0)
        for m in model.modules():
            if isinstance(m, Resampler) and m.latents is not None:
                m.latents.normal_(0.0, 1.0, generator=gen).div_(m.latents.shape[-1] ** 0.5)
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


def tower_features(model: VLM, images: torch.Tensor) -> torch.Tensor:
    """The configured tower's features (B, N, tower_hidden) of (B, H, W, 3) images."""
    if model.cfg.use_convnext_tower:
        return convnext_tower_features(model.vision_tower, images)
    return clip_tower_features(model.vision_tower, images)


def encode_images(model: VLM, images: torch.Tensor) -> torch.Tensor:
    """Vision tower + projector: images (B, H, W, 3) -> (B, N, llm_hidden), or
    anyres tiles (B, n_tiles, H, W, 3) -> (B, n_tiles * per_tile [+ 1],
    llm_hidden), the tiles' rows in order and the image_newline row last when
    the model has one."""
    if images.ndim != 5:
        return model.mm_projector(tower_features(model, images))
    b, n_tiles = images.shape[:2]
    tiles = images.reshape(b * n_tiles, *images.shape[2:])
    feats = model.mm_projector(tower_features(model, tiles))
    feats = feats.reshape(b, -1, feats.shape[-1])
    if model.image_newline is None:
        return feats
    newline = model.image_newline.to(feats.dtype).expand(b, 1, feats.shape[-1])
    return torch.cat([feats, newline], dim=1)


def splice_embeddings(
    model: VLM,
    text_ids: torch.Tensor,                 # (B, T) token id at TEXT positions
    token_type: torch.Tensor,               # (B, T) SEG_* codes
    src_index: torch.Tensor,                # (B, T) image-patch / task-token row
    image_features: Optional[torch.Tensor], # (B, N_img, hidden) or None (text only)
) -> torch.Tensor:
    """Vectorized gather-select splice -> (B, T, hidden)."""
    text_emb = model.decoder.embed(text_ids)
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


# ---------------------------------------------------------------------------
# Training forward and the distillation heads
# ---------------------------------------------------------------------------


def vlm_forward(
    model: VLM,
    cfg: VLMConfig,
    batch: Dict[str, torch.Tensor],
    *,
    use_kernel: Optional[bool] = None,
    tap: bool = True,
    compute_logits: bool = True,
    remat: bool = False,
    remat_policy: Optional[str] = None,
    moe_data=None,
) -> Dict[str, Any]:
    """JAX `vlm_forward` (training / prefill). batch: images (B,H,W,3) or
    image_features, text_ids, token_type, src_index, seq_lengths (right
    padding: the attention masks keys >= seq_lengths). remat / remat_policy
    and moe_data (the data group a MoE decoder routes over) go to the
    decoder (`Decoder.forward`). Under sequence parallelism (the
    decoder's `seq`) the splice runs whole on every rank, and the decoder
    takes the rank's rows of it (a differentiable slice): its hidden
    states, logits and taps are the rank's rows."""
    if "image_features" in batch:
        image_features = batch["image_features"]
    else:
        image_features = encode_images(model, batch["images"])
    embeds = splice_embeddings(
        model, batch["text_ids"].long(), batch["token_type"], batch["src_index"].long(),
        image_features,
    )
    embeds = local_rows(embeds, model.decoder.seq)
    taps = tap_layer_union(cfg) if tap else ()
    out = model.decoder(
        embeds, kv_lengths=batch.get("seq_lengths"), tap_layers=taps,
        use_kernel=use_kernel, compute_logits=compute_logits,
        remat=remat, remat_policy=remat_policy,
        lora=lora_side_factors(model.lora, cfg.lora), moe_data=moe_data,
    )
    out["tap_layers"] = taps
    out["image_features"] = image_features
    return out


def head_input_tokens(
    cfg: VLMConfig, layer_state: torch.Tensor, task: str
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(inp_tokens, task_latents) for one head: inp = [sys+image | this
    task's token span | text tail when pass_text_to_aux]; latents are the gen
    span's states for gen, None for depth/seg (the caller supplies the raw
    special-token parameters)."""
    d = cfg.distill
    ns, ni, nt = cfg.num_sys_tokens, cfg.num_image_tokens, d.num_task_tokens
    order = d.task_order()
    task_start = ns + ni + nt * order.index(task)
    all_end = ns + ni + nt * len(order)
    if nt == 0:
        return (layer_state if d.pass_text_to_aux else layer_state[:, : ns + ni]), None
    parts = [layer_state[:, : ns + ni], layer_state[:, task_start : task_start + nt]]
    if d.pass_text_to_aux:
        parts.append(layer_state[:, all_end:])
    inp = torch.cat(parts, dim=1)
    latents = layer_state[:, task_start : task_start + nt] if task == "gen" else None
    return inp, latents


def predict_task_embeddings(
    model: VLM,
    cfg: VLMConfig,
    taps: Tuple[torch.Tensor, ...],
    tap_layers: Tuple[int, ...],
) -> Dict[str, List[torch.Tensor]]:
    """Every head on its tapped layer state: {task: [pred per layer]}, preds
    (B, num_tokens, output_dim)."""
    d = cfg.distill
    slot = {layer: i for i, layer in enumerate(tap_layers)}
    preds: Dict[str, List[torch.Tensor]] = {}
    for tcfg in d.tasks:
        task_preds = []
        for j, layer in enumerate(tcfg.layer_indices):
            inp, latents = head_input_tokens(cfg, taps[slot[layer]], tcfg.task)
            if d.num_task_tokens > 0 and latents is None:
                # depth/seg latents: the raw special-token parameters, on the batch
                tok = model.special_tokens[tcfg.task]
                latents = tok.to(inp.dtype).expand(inp.shape[0], *tok.shape)
            task_preds.append(task_head_forward(
                model.heads[tcfg.task][j], inp, latents if d.num_task_tokens > 0 else None,
            ))
        preds[tcfg.task] = task_preds
    return preds
