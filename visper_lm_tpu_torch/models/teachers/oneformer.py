"""OneFormer pixel decoder and transformer decoder, the mask-decoding
inference path (counterpart of visper_lm_tpu/models/teachers/oneformer.py).

The seg target needs only the Swin backbone (teachers/swin.py); this module
decodes real segmentation masks for the demo's visualisation, including the
backbone-last-feature substitution that renders a predicted (B, 24, 24, 1536)
embedding into masks (`get_masks`). The graph is HF modeling_oneformer's
inference graph, as the JAX package writes it:

  * sine position embeddings;
  * a multi-scale deformable-attention encoder over the three deepest scales
    (sampling through `utils.image.grid_sample_bilinear`) and an FPN with the
    shallowest scale -> mask features and the multi-scale features;
  * a query transformer (2 layers) seeding the object queries (the last one
    is the task token), then masked-cross-attention decoder layers with a
    prediction head after each;
  * the task MLP on the tokenized task text; semantic post-processing.

Inference only: no dropout, no padding masks. The modules hold the JAX
tree's names (`weights.oneformer_from_jax_params` loads a JAX tree; 1x1
convolutions are `nn.Linear`s, as JAX keeps them). JAX has no random init
for this decoder; `init_oneformer` is the port's seeded one. `get_masks`
runs the Swin backbone through `swin.swin_forward` (the B4 kernel on CUDA).
`import_oneformer_decoder` reads an HF OneFormer state dict into the JAX
tree layout (numpy).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from visper_lm_tpu_torch.models.genpipe.unet import GroupNorm, group_norm
from visper_lm_tpu_torch.models.teachers.swin import SwinBackbone, SwinConfig, swin_forward
from visper_lm_tpu_torch.utils.image import conv2d, grid_sample_bilinear, resize_bilinear
from visper_lm_tpu_torch.utils.param import LayerNorm, host_array, init_weights_


@dataclasses.dataclass(frozen=True)
class OneFormerDecoderConfig:
    d_model: int = 256
    encoder_layers: int = 6
    encoder_ffn_dim: int = 1024
    decoder_layers: int = 10          # 1 initial prediction + (decoder_layers - 1) blocks
    query_dec_layers: int = 2
    dim_feedforward: int = 2048
    num_heads: int = 8
    num_queries: int = 150
    num_classes: int = 133            # COCO panoptic
    num_feature_levels: int = 3
    num_points: int = 4
    task_seq_len: int = 77
    backbone_dims: Tuple[int, ...] = (192, 384, 768, 1536)  # Swin-L stages
    norm_eps: float = 1e-5


ONEFORMER_COCO = OneFormerDecoderConfig()


# ---------------------------------------------------------------------------
# Modules (the JAX tree's names)
# ---------------------------------------------------------------------------


class MHA(nn.Module):
    """torch nn.MultiheadAttention's projections, split: q, k, v, out."""

    def __init__(self, d: int, **kw):
        super().__init__()
        self.q, self.k, self.v, self.out = (nn.Linear(d, d, **kw) for _ in range(4))


class DeformAttn(nn.Module):
    def __init__(self, cfg: OneFormerDecoderConfig, **kw):
        super().__init__()
        d, hlp = cfg.d_model, cfg.num_heads * cfg.num_feature_levels * cfg.num_points
        self.value_proj = nn.Linear(d, d, **kw)
        self.sampling_offsets = nn.Linear(d, hlp * 2, **kw)
        self.attention_weights = nn.Linear(d, hlp, **kw)
        self.output_proj = nn.Linear(d, d, **kw)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: OneFormerDecoderConfig, **kw):
        super().__init__()
        d = cfg.d_model
        self.self_attn = DeformAttn(cfg, **kw)
        self.norm1 = LayerNorm(d, 1e-5, **kw)
        self.fc1 = nn.Linear(d, cfg.encoder_ffn_dim, **kw)
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim, d, **kw)
        self.norm2 = LayerNorm(d, 1e-5, **kw)


class ProjNorm(nn.Module):
    """A 1x1 conv (as a linear) and its GroupNorm(32)."""

    def __init__(self, cin: int, d: int, bias: bool = True, **kw):
        super().__init__()
        self.proj = nn.Linear(cin, d, bias=bias, **kw)
        self.norm = GroupNorm(d, **kw)


class ConvNorm(nn.Module):
    """`conv` (a 1x1 as a linear, or a 3x3 nn.Conv2d) without bias and its GroupNorm(32)."""

    def __init__(self, conv: nn.Module, d: int, **kw):
        super().__init__()
        self.conv = conv
        self.norm = GroupNorm(d, **kw)


class PixelDecoder(nn.Module):
    def __init__(self, cfg: OneFormerDecoderConfig, **kw):
        super().__init__()
        d, nl = cfg.d_model, cfg.num_feature_levels
        deep = list(cfg.backbone_dims[::-1][:nl])
        shallow = list(cfg.backbone_dims[: len(cfg.backbone_dims) - nl][::-1])
        self.level_embed = nn.Parameter(torch.zeros(nl, d, **kw))
        self.input_projections = nn.ModuleList(ProjNorm(c, d, **kw) for c in deep)
        self.encoder_layers = nn.ModuleList(EncoderLayer(cfg, **kw) for _ in range(cfg.encoder_layers))
        self.lateral_convs = nn.ModuleList(
            ConvNorm(nn.Linear(c, d, bias=False, **kw), d, **kw) for c in shallow)
        self.output_convs = nn.ModuleList(
            ConvNorm(nn.Conv2d(d, d, 3, bias=False, **kw), d, **kw) for _ in shallow)
        self.mask_projection = nn.Linear(d, d, **kw)


class QueryLayer(nn.Module):
    def __init__(self, cfg: OneFormerDecoderConfig, **kw):
        super().__init__()
        d = cfg.d_model
        self.self_attn = MHA(d, **kw)
        self.norm1 = LayerNorm(d, cfg.norm_eps, **kw)
        self.cross_attn = MHA(d, **kw)
        self.norm2 = LayerNorm(d, cfg.norm_eps, **kw)
        self.fc1 = nn.Linear(d, cfg.dim_feedforward, **kw)
        self.fc2 = nn.Linear(cfg.dim_feedforward, d, **kw)
        self.norm3 = LayerNorm(d, cfg.norm_eps, **kw)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: OneFormerDecoderConfig, **kw):
        super().__init__()
        d = cfg.d_model
        self.cross_attn = MHA(d, **kw)
        self.cross_norm = LayerNorm(d, cfg.norm_eps, **kw)
        self.self_attn = MHA(d, **kw)
        self.self_norm = LayerNorm(d, cfg.norm_eps, **kw)
        self.fc1 = nn.Linear(d, cfg.dim_feedforward, **kw)
        self.fc2 = nn.Linear(cfg.dim_feedforward, d, **kw)
        self.ffn_norm = LayerNorm(d, cfg.norm_eps, **kw)


class MLP(nn.Module):
    """OneFormerMLPPredictionHead: Linear -> ReLU (n - 1 times) -> Linear."""

    def __init__(self, dims: Sequence[int], **kw):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b, **kw) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, cfg: OneFormerDecoderConfig, input_projections: Sequence[bool], **kw):
        super().__init__()
        d = cfg.d_model
        self.level_embed = nn.Parameter(torch.zeros(cfg.num_feature_levels, d, **kw))
        self.queries_embedder = nn.Parameter(torch.zeros(cfg.num_queries, d, **kw))
        self.input_projections = nn.ModuleList(
            nn.Linear(d, d, **kw) if p else nn.Identity() for p in input_projections)
        self.query_input_projection = nn.Linear(d, d, **kw)
        self.decoder_norm = LayerNorm(d, cfg.norm_eps, **kw)
        self.class_embed = nn.Linear(d, cfg.num_classes + 1, **kw)
        self.mask_embed = MLP((d, d, d, d), **kw)
        self.query_transformer_layers = nn.ModuleList(
            QueryLayer(cfg, **kw) for _ in range(cfg.query_dec_layers))
        self.query_transformer_norm = LayerNorm(d, cfg.norm_eps, **kw)
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(cfg, **kw) for _ in range(cfg.decoder_layers - 1))


class OneFormerDecoder(nn.Module):
    """JAX `import_oneformer_decoder`'s tree: pixel_decoder,
    transformer_decoder, task_encoder. input_projections: which of the
    transformer decoder's level projections exist (HF: only where conv_dim !=
    hidden_dim; COCO: none)."""

    def __init__(self, cfg: OneFormerDecoderConfig = ONEFORMER_COCO,
                 input_projections: Optional[Sequence[bool]] = None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        if input_projections is None:
            input_projections = (False,) * cfg.num_feature_levels
        self.pixel_decoder = PixelDecoder(cfg, **kw)
        self.transformer_decoder = TransformerDecoder(cfg, input_projections, **kw)
        self.task_encoder = MLP((cfg.task_seq_len, cfg.d_model, cfg.d_model), **kw)


@torch.no_grad()
def init_oneformer(cfg: OneFormerDecoderConfig = ONEFORMER_COCO, *, generator: torch.Generator,
                   device=None, dtype=None) -> OneFormerDecoder:
    """A frozen OneFormerDecoder with seeded random weights (the port's init;
    JAX has none): linears U(+-1/sqrt(in)) with zero bias, the 3x3 convs
    U(+-1/sqrt(9 d)), norms 1 / 0, the level and query embeddings N(0, 1) as
    HF draws them."""
    model = OneFormerDecoder(cfg, device=device, dtype=dtype)
    init_weights_(model, generator)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, GroupNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
    for p in (model.pixel_decoder.level_embed, model.transformer_decoder.level_embed,
              model.transformer_decoder.queries_embedder):
        p.normal_(0.0, 1.0, generator=generator)
    return model.requires_grad_(False).eval()


# ---------------------------------------------------------------------------
# Sine position embeddings (OneFormerSinePositionEmbedding, normalize=True)
# ---------------------------------------------------------------------------


def sine_pos_embed(h: int, w: int, num_pos_feats: int, device=None) -> torch.Tensor:
    """(H * W, 2 * num_pos_feats) normalised sine embedding, row-major, f32."""
    scale = 2 * math.pi
    eps = 1e-6
    f32 = dict(dtype=torch.float32, device=device)
    y = torch.arange(1, h + 1, **f32)[:, None] * torch.ones(1, w, **f32)
    x = torch.arange(1, w + 1, **f32)[None, :] * torch.ones(h, 1, **f32)
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = torch.arange(num_pos_feats, **f32)
    dim_t = 10000.0 ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    pos_x = torch.stack([torch.sin(pos_x[:, :, 0::2]), torch.cos(pos_x[:, :, 1::2])], dim=3)
    pos_y = torch.stack([torch.sin(pos_y[:, :, 0::2]), torch.cos(pos_y[:, :, 1::2])], dim=3)
    pos = torch.cat([pos_y.reshape(h, w, -1), pos_x.reshape(h, w, -1)], dim=-1)
    return pos.reshape(h * w, -1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def ms_deform_attn(
    p: DeformAttn,
    hidden: torch.Tensor,                  # (B, Nq, D) query features (pos added)
    value_feats: torch.Tensor,             # (B, S, D) flattened multi-level values
    reference_points: torch.Tensor,        # (B, Nq, L, 2) in [0, 1]
    spatial_shapes: Sequence[Tuple[int, int]],
    num_heads: int,
    num_points: int,
) -> torch.Tensor:
    b, nq, d = hidden.shape
    n_levels = len(spatial_shapes)
    hd = d // num_heads
    value = p.value_proj(value_feats).reshape(b, -1, num_heads, hd)
    offsets = p.sampling_offsets(hidden).reshape(b, nq, num_heads, n_levels, num_points, 2)
    weights = p.attention_weights(hidden).reshape(b, nq, num_heads, n_levels * num_points)
    weights = torch.softmax(weights, dim=-1).reshape(b, nq, num_heads, n_levels, num_points)
    normalizer = torch.tensor([[w_, h_] for h_, w_ in spatial_shapes], dtype=torch.float32,
                              device=hidden.device)               # (L, 2) as (w, h)
    locations = (reference_points[:, :, None, :, None, :]
                 + offsets / normalizer[None, None, None, :, None, :])   # (B, Nq, H, L, P, 2)
    out_per_level = []
    start = 0
    for lvl, (hgt, wdt) in enumerate(spatial_shapes):
        v = value[:, start:start + hgt * wdt]                             # (B, hw, H, hd)
        start += hgt * wdt
        v = v.permute(0, 2, 1, 3).reshape(b * num_heads, hgt, wdt, hd)
        grid = 2 * locations[:, :, :, lvl] - 1                            # (B, Nq, H, P, 2)
        grid = grid.permute(0, 2, 1, 3, 4).reshape(b * num_heads, nq, num_points, 2)
        out_per_level.append(grid_sample_bilinear(v, grid))              # (BH, Nq, P, hd)
    stacked = torch.stack(out_per_level, dim=2)                           # (BH, Nq, L, P, hd)
    w = weights.permute(0, 2, 1, 3, 4).reshape(b * num_heads, nq, n_levels, num_points)
    out = (stacked * w[..., None]).sum(dim=(2, 3))                        # (BH, Nq, hd)
    out = out.reshape(b, num_heads, nq, hd).permute(0, 2, 1, 3).reshape(b, nq, d)
    return p.output_proj(out)


def mha(
    p: MHA, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    attn_mask: Optional[torch.Tensor] = None,      # (B, Nq, Nk) bool, True = blocked
) -> torch.Tensor:
    """nn.MultiheadAttention semantics on (B, N, D): f32 scores and softmax,
    the probabilities in v's dtype; a blocked score is -1e9."""
    b, nq, d = q.shape
    hd = d // num_heads
    qp = p.q(q).reshape(b, nq, num_heads, hd).transpose(1, 2)
    kp = p.k(k).reshape(b, -1, num_heads, hd).transpose(1, 2)
    vp = p.v(v).reshape(b, -1, num_heads, hd).transpose(1, 2)
    logits = torch.matmul(qp, kp.transpose(-1, -2)).float() / math.sqrt(hd)
    if attn_mask is not None:
        logits = logits.masked_fill(attn_mask[:, None], -1e9)
    probs = torch.softmax(logits, dim=-1).to(vp.dtype)
    out = torch.matmul(probs, vp).transpose(1, 2).reshape(b, nq, d)
    return p.out(out)


# ---------------------------------------------------------------------------
# Pixel decoder
# ---------------------------------------------------------------------------


def pixel_decoder_forward(
    p: PixelDecoder, cfg: OneFormerDecoderConfig, features: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """features: 4 backbone maps (B, H, W, C), shallow -> deep. Returns
    (mask_features (B, H1, W1, D), multi-scale features deep -> shallow)."""
    d = cfg.d_model
    deep = list(features[::-1][: cfg.num_feature_levels])
    sources, pos_list, shapes = [], [], []
    for lvl, feat in enumerate(deep):
        b, h, w, _ = feat.shape
        proj = p.input_projections[lvl]
        src = group_norm(proj.norm, proj.proj(feat).reshape(b, h, w, d), 32, 1e-5)
        sources.append(src.reshape(b, h * w, d))
        pos = sine_pos_embed(h, w, d // 2, device=feat.device)
        pos_list.append(pos[None] + p.level_embed[lvl][None, None, :])
        shapes.append((h, w))
    src_flat = torch.cat(sources, dim=1)
    bsz = src_flat.shape[0]
    pos_flat = torch.cat([x.expand(bsz, *x.shape[1:]) for x in pos_list], dim=1)

    # reference points: each level's normalised cell centres, the same for every level
    refs = []
    for (h, w) in shapes:
        ry = (torch.arange(h, dtype=torch.float32, device=src_flat.device) + 0.5) / h
        rx = (torch.arange(w, dtype=torch.float32, device=src_flat.device) + 0.5) / w
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        refs.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
    ref_points = torch.cat(refs, dim=0)[None, :, None, :].expand(
        bsz, -1, cfg.num_feature_levels, 2)

    h_states = src_flat
    for layer in p.encoder_layers:
        attn_out = ms_deform_attn(layer.self_attn, h_states + pos_flat.to(h_states.dtype),
                                  h_states, ref_points, shapes, cfg.num_heads, cfg.num_points)
        h_states = layer.norm1(h_states + attn_out)
        ff = layer.fc2(F.relu(layer.fc1(h_states)))
        h_states = layer.norm2(h_states + ff)

    outs = []
    start = 0
    for (h, w) in shapes:
        outs.append(h_states[:, start:start + h * w].reshape(-1, h, w, d))
        start += h * w

    # the FPN with the remaining shallow level(s)
    shallow = list(features[: len(features) - cfg.num_feature_levels])[::-1]
    for idx, feat in enumerate(shallow):
        lat = p.lateral_convs[idx]
        lateral = group_norm(lat.norm, lat.conv(feat), 32, 1e-5)
        up = resize_bilinear(outs[-1], tuple(lateral.shape[1:3]), align_corners=False)
        out = p.output_convs[idx]
        y = conv2d(lateral + up, out.conv.weight, None, stride=1, padding=1)
        outs.append(F.relu(group_norm(out.norm, y, 32, 1e-5)))

    mask_features = p.mask_projection(outs[-1])
    return mask_features, outs[: cfg.num_feature_levels]


# ---------------------------------------------------------------------------
# Transformer decoder
# ---------------------------------------------------------------------------


def _prediction_heads(p: TransformerDecoder, cfg: OneFormerDecoderConfig, output: torch.Tensor,
                      mask_features: torch.Tensor, target_hw: Tuple[int, int]):
    """output (B, Q, D); mask_features (B, H, W, D)."""
    dec = p.decoder_norm(output)
    outputs_class = p.class_embed(dec)
    mask_embed = p.mask_embed(dec)
    outputs_mask = torch.einsum("bqc,bhwc->bqhw", mask_embed, mask_features)
    am = resize_bilinear(outputs_mask.permute(0, 2, 3, 1), tuple(target_hw),
                         align_corners=False).permute(0, 3, 1, 2)
    attention_mask = torch.sigmoid(am).reshape(am.shape[0], am.shape[1], -1) < 0.5
    # a query blocked everywhere attends everywhere (HF's rule)
    attention_mask = attention_mask & ~attention_mask.all(dim=-1, keepdim=True)
    return outputs_class, outputs_mask, attention_mask


def transformer_decoder_forward(
    p: TransformerDecoder,
    cfg: OneFormerDecoderConfig,
    multi_scale: Sequence[torch.Tensor],   # deep -> shallow (B, H, W, D)
    mask_features: torch.Tensor,           # (B, H1, W1, D)
    task_token: torch.Tensor,              # (B, D)
) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    b = mask_features.shape[0]
    dev = mask_features.device

    stage_feats, stage_pos, size_list = [], [], []
    for i, feat in enumerate(multi_scale):
        _, h, w, _ = feat.shape
        size_list.append((h, w))
        pos = sine_pos_embed(h, w, d // 2, device=dev)[None]
        src = p.input_projections[i](feat).reshape(b, h * w, d)
        stage_feats.append(src + p.level_embed[i][None, None, :])
        stage_pos.append(pos.expand(b, *pos.shape[1:]))

    task_tok = p.decoder_norm(task_token[:, None, :])

    # the query transformer: the sine position embeddings are its memory and the
    # projected mask features its `pos` (OneFormer's quirk, kept for the weights)
    mh, mw = mask_features.shape[1:3]
    memory = sine_pos_embed(mh, mw, d // 2, device=dev)[None].expand(b, mh * mw, d)
    mem_pos = p.query_input_projection(mask_features).reshape(b, mh * mw, d)
    memory = memory.to(mem_pos.dtype)
    query_embed = p.queries_embedder[:-1][None].expand(b, -1, -1)
    queries = task_tok.expand(b, query_embed.shape[1], d)
    for layer in p.query_transformer_layers:
        qk = queries + query_embed
        queries = layer.norm1(queries + mha(layer.self_attn, qk, qk, queries, cfg.num_heads))
        ca = mha(layer.cross_attn, queries + query_embed, memory + mem_pos, memory, cfg.num_heads)
        queries = layer.norm2(queries + ca)
        queries = layer.norm3(queries + layer.fc2(F.relu(layer.fc1(queries))))
    queries = p.query_transformer_norm(queries)

    output = torch.cat([queries, task_tok], dim=1)               # (B, Q, D)
    query_embeddings = p.queries_embedder[None].expand(b, cfg.num_queries, d)

    outputs_class, outputs_mask, attn_mask = _prediction_heads(
        p, cfg, output, mask_features, size_list[0])
    for index, layer in enumerate(p.decoder_layers):
        lvl = index % cfg.num_feature_levels
        ca = mha(layer.cross_attn, output + query_embeddings,
                 stage_feats[lvl] + stage_pos[lvl].to(stage_feats[lvl].dtype), stage_feats[lvl],
                 cfg.num_heads, attn_mask=attn_mask)
        output = layer.cross_norm(output + ca)
        qk = output + query_embeddings
        output = layer.self_norm(output + mha(layer.self_attn, qk, qk, output, cfg.num_heads))
        output = layer.ffn_norm(output + layer.fc2(F.relu(layer.fc1(output))))
        outputs_class, outputs_mask, attn_mask = _prediction_heads(
            p, cfg, output, mask_features, size_list[(index + 1) % cfg.num_feature_levels])
    return {"class_queries_logits": outputs_class, "masks_queries_logits": outputs_mask}


def task_encoder_forward(p: MLP, task_inputs: torch.Tensor) -> torch.Tensor:
    """OneFormerTaskModel: the 2-layer MLP on the (B, 77) tokenized task text."""
    dtype = p.layers[0].weight.dtype
    return p(torch.as_tensor(task_inputs).to(device=p.layers[0].weight.device, dtype=dtype))


# ---------------------------------------------------------------------------
# get_masks (with the substitution) and semantic post-processing
# ---------------------------------------------------------------------------


@torch.no_grad()
def get_masks(
    decoder: OneFormerDecoder,
    cfg: OneFormerDecoderConfig,
    swin: SwinBackbone,
    pixel_values: torch.Tensor,                           # (B, H, W, 3) normalised
    task_inputs: torch.Tensor,                            # (B, 77)
    backbone_last_feature: Optional[torch.Tensor] = None,  # (B, 24, 24, C) substitution
    use_kernel: Optional[bool] = None,
) -> Dict[str, torch.Tensor]:
    """OneFormerHead.get_masks: the Swin backbone's four stages (B4 on CUDA
    unless use_kernel=False); with backbone_last_feature, that prediction
    replaces the last stage's map and the lower three are resized
    bilinearly to its grid."""
    dtype = decoder.pixel_decoder.level_embed.dtype
    feats = swin_forward(swin, pixel_values.to(next(swin.parameters()).dtype),
                         use_kernel=use_kernel)
    feats = [f.to(dtype) for f in feats]
    if backbone_last_feature is not None:
        target_hw = tuple(feats[-1].shape[1:3])
        sub = resize_bilinear(backbone_last_feature.to(dtype), target_hw, align_corners=False)
        feats = [resize_bilinear(f, target_hw, align_corners=False) for f in feats[:-1]] + [sub]
    mask_features, multi_scale = pixel_decoder_forward(decoder.pixel_decoder, cfg, feats)
    task_token = task_encoder_forward(decoder.task_encoder, task_inputs)
    return transformer_decoder_forward(decoder.transformer_decoder, cfg, multi_scale,
                                       mask_features, task_token)


def semantic_segmentation(
    class_queries_logits: torch.Tensor,   # (B, Q, num_classes + 1)
    masks_queries_logits: torch.Tensor,   # (B, Q, H, W)
    target_hw: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """OneFormerImageProcessor.post_process_semantic_segmentation: the
    (B, H, W) class map."""
    masks = masks_queries_logits.float()
    if target_hw is not None:
        masks = resize_bilinear(masks.permute(0, 2, 3, 1), tuple(target_hw),
                                align_corners=False).permute(0, 3, 1, 2)
    class_probs = torch.softmax(class_queries_logits.float(), dim=-1)[..., :-1]
    return torch.einsum("bqc,bqhw->bchw", class_probs, torch.sigmoid(masks)).argmax(dim=1)


# ---------------------------------------------------------------------------
# HF importer -> the JAX package's tree layout (numpy)
# ---------------------------------------------------------------------------


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(host_array(w).T)


def _lin(sd, prefix: str) -> Dict[str, np.ndarray]:
    p = {"kernel": _t(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["bias"] = host_array(sd[f"{prefix}.bias"])
    return p


def _ln(sd, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": host_array(sd[f"{prefix}.weight"]), "bias": host_array(sd[f"{prefix}.bias"])}


def _conv1x1(sd, key: str) -> np.ndarray:
    w = host_array(sd[key])
    return _t(w.reshape(w.shape[0], -1))


def _mha_from_torch(sd, prefix: str, d: int) -> Dict[str, Any]:
    """nn.MultiheadAttention's in_proj_{weight,bias} and out_proj."""
    w, bias = host_array(sd[prefix + "in_proj_weight"]), host_array(sd[prefix + "in_proj_bias"])
    return {
        "q": {"kernel": _t(w[:d]), "bias": bias[:d]},
        "k": {"kernel": _t(w[d:2 * d]), "bias": bias[d:2 * d]},
        "v": {"kernel": _t(w[2 * d:]), "bias": bias[2 * d:]},
        "out": _lin(sd, prefix + "out_proj"),
    }


def _mlp_from_torch(sd, prefix: str, n_layers: int) -> Dict[str, Any]:
    return {"layers": [_lin(sd, f"{prefix}layers.{i}.0") for i in range(n_layers)]}


def configs_from_hf(hf: Mapping[str, Any]) -> Tuple[OneFormerDecoderConfig, SwinConfig]:
    """JAX `configs_from_hf`: an HF OneFormerConfig JSON dict (with its
    backbone_config) -> (decoder config, Swin config)."""
    bb = hf.get("backbone_config", {})
    embed_dim = bb.get("embed_dim", 192)
    dec = OneFormerDecoderConfig(
        d_model=hf.get("conv_dim", 256),
        encoder_layers=hf.get("encoder_layers", 6),
        decoder_layers=hf.get("decoder_layers", 10),
        encoder_ffn_dim=hf.get("encoder_feedforward_dim", 1024),
        dim_feedforward=hf.get("dim_feedforward", 2048),
        num_heads=hf.get("num_attention_heads", 8),
        num_queries=hf.get("num_queries", 150),
        num_classes=hf.get("num_labels", 133),
        task_seq_len=hf.get("task_seq_len", 77),
        backbone_dims=tuple(embed_dim * 2 ** i for i in range(4)),
    )
    swin = SwinConfig(
        embed_dim=embed_dim,
        depths=tuple(bb.get("depths", (2, 2, 18, 2))),
        num_heads=tuple(bb.get("num_heads", (6, 12, 24, 48))),
        window_size=bb.get("window_size", 12),
    )
    return dec, swin


def import_oneformer_decoder(
    sd: Mapping[str, Any], cfg: OneFormerDecoderConfig = ONEFORMER_COCO,
) -> Dict[str, Any]:
    """JAX `import_oneformer_decoder`: the non-backbone parts of an HF
    OneFormerModel state dict ("model." stripped) -> the JAX tree (numpy)."""
    pd = "pixel_level_module.decoder."
    pixel: Dict[str, Any] = {
        "level_embed": host_array(sd[pd + "level_embed"]),
        "input_projections": [],
        "encoder_layers": [],
        "lateral_convs": [],
        "output_convs": [],
        "mask_projection": {"kernel": _conv1x1(sd, pd + "mask_projection.weight"),
                            "bias": host_array(sd[pd + "mask_projection.bias"])},
    }
    for i in range(cfg.num_feature_levels):
        pixel["input_projections"].append({
            "proj": {"kernel": _conv1x1(sd, f"{pd}input_projections.{i}.0.weight"),
                     "bias": host_array(sd[f"{pd}input_projections.{i}.0.bias"])},
            "norm": _ln(sd, f"{pd}input_projections.{i}.1"),
        })
    i = 0
    while f"{pd}encoder.layers.{i}.self_attn.value_proj.weight" in sd:
        lp = f"{pd}encoder.layers.{i}."
        pixel["encoder_layers"].append({
            "self_attn": {n: _lin(sd, lp + "self_attn." + n) for n in (
                "value_proj", "sampling_offsets", "attention_weights", "output_proj")},
            "norm1": _ln(sd, lp + "self_attn_layer_norm"),
            "fc1": _lin(sd, lp + "fc1"),
            "fc2": _lin(sd, lp + "fc2"),
            "norm2": _ln(sd, lp + "final_layer_norm"),
        })
        i += 1
    # the FPN convs are registered adapter_k / layer_k, adapter_1 the shallowest;
    # the forward runs deep to shallow, so they are listed in reverse
    ks = []
    i = 1
    while f"{pd}adapter_{i}.0.weight" in sd:
        ks.append(i)
        i += 1
    for i in reversed(ks):
        pixel["lateral_convs"].append({
            "conv": {"kernel": _conv1x1(sd, f"{pd}adapter_{i}.0.weight")},
            "norm": _ln(sd, f"{pd}adapter_{i}.1"),
        })
        ow = host_array(sd[f"{pd}layer_{i}.0.weight"])
        pixel["output_convs"].append({
            "conv": {"kernel": np.ascontiguousarray(np.transpose(ow, (2, 3, 1, 0)))},
            "norm": _ln(sd, f"{pd}layer_{i}.1"),
        })

    td = "transformer_module."
    dec: Dict[str, Any] = {
        "level_embed": host_array(sd[td + "level_embed.weight"]),
        "queries_embedder": host_array(sd[td + "queries_embedder.weight"]),
        "input_projections": [],
        "query_input_projection": {
            "kernel": _conv1x1(sd, td + "decoder.query_input_projection.weight"),
            "bias": host_array(sd[td + "decoder.query_input_projection.bias"]),
        },
        "decoder_norm": _ln(sd, td + "decoder.decoder_norm"),
        "class_embed": _lin(sd, td + "decoder.class_embed"),
        "mask_embed": _mlp_from_torch(sd, td + "decoder.mask_embed.", 3),
        "query_transformer_layers": [],
        "query_transformer_norm": _ln(sd, td + "decoder.query_transformer.decoder.norm"),
        "decoder_layers": [],
    }
    for i in range(cfg.num_feature_levels):
        key = f"{td}input_projections.{i}.weight"
        if key not in sd:
            dec["input_projections"].append(None)   # identity (conv_dim == hidden_dim)
            continue
        w = host_array(sd[key])
        bias = sd.get(f"{td}input_projections.{i}.bias")
        dec["input_projections"].append({
            "kernel": _t(w.reshape(w.shape[0], -1)),
            "bias": np.zeros(w.shape[0], np.float32) if bias is None else host_array(bias),
        })
    i = 0
    qt = td + "decoder.query_transformer.decoder.layers."
    while f"{qt}{i}.self_attn.in_proj_weight" in sd:
        lp = f"{qt}{i}."
        dec["query_transformer_layers"].append({
            "self_attn": _mha_from_torch(sd, lp + "self_attn.", cfg.d_model),
            "norm1": _ln(sd, lp + "norm1"),
            "cross_attn": _mha_from_torch(sd, lp + "multihead_attn.", cfg.d_model),
            "norm2": _ln(sd, lp + "norm2"),
            "fc1": _lin(sd, lp + "linear1"),
            "fc2": _lin(sd, lp + "linear2"),
            "norm3": _ln(sd, lp + "norm3"),
        })
        i += 1
    i = 0
    dl = td + "decoder.layers."
    while f"{dl}{i}.cross_attn.multihead_attn.in_proj_weight" in sd:
        lp = f"{dl}{i}."
        sa = lp + "self_attn.self_attn."
        dec["decoder_layers"].append({
            "cross_attn": _mha_from_torch(sd, lp + "cross_attn.multihead_attn.", cfg.d_model),
            "cross_norm": _ln(sd, lp + "cross_attn.norm"),
            "self_attn": {"q": _lin(sd, sa + "q_proj"), "k": _lin(sd, sa + "k_proj"),
                          "v": _lin(sd, sa + "v_proj"), "out": _lin(sd, sa + "out_proj")},
            "self_norm": _ln(sd, lp + "self_attn.norm"),
            "fc1": _lin(sd, lp + "ffn.linear1"),
            "fc2": _lin(sd, lp + "ffn.linear2"),
            "ffn_norm": _ln(sd, lp + "ffn.norm"),
        })
        i += 1
    task = _mlp_from_torch(sd, "task_encoder.task_mlp.", 2)
    return {"pixel_decoder": pixel, "transformer_decoder": dec, "task_encoder": task}
