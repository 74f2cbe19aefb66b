"""HF checkpoint import: safetensors files and HF / OLA state dicts -> the
port's VLM (counterpart of visper_lm_tpu/checkpoint/hf_import.py).

The key surface is the reference loader's:
  * the causal LM: model.embed_tokens / model.layers.N.* / model.norm /
    lm_head (Phi3's fused qkv_proj and gate_up_proj are split here);
  * the mm projector Sequential model.mm_projector.{0,2}.*;
  * the CLIP tower model.vision_tower.vision_tower.vision_model.*, or the
    ConvNeXt trunk in OpenCLIP / timm layout under
    model.vision_tower.vision_tower.* (models/convnext.py);
  * image_newline model.image_newline;
  * the task tokens model.special_{depth,seg,gen}_tokens, the per-layer heads
    image_{gen,seg,depth}_heads.N.projector.* and the logit scales
    {gen,seg,depth}_logit_scale.

HF linears are (out, in), as `nn.Linear` holds them, so the mapping is a
renaming onto the port's state-dict names (`import_*` return
{port name: tensor}); Phi3's fused weights are split into views and only
the CLIP tower's q/k/v are concatenated. Tensors keep their file dtype.

The safetensors reader is the port's own (the format: an 8-byte
little-endian header length, a JSON header of dtype / shape / data_offsets
and an optional __metadata__, then the raw bytes); it maps the file and
returns tensors that share the mapping, BF16 included.
"""

from __future__ import annotations

import json
import mmap
import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from visper_lm_tpu_torch.config import (
    DecoderConfig,
    DistillTaskConfig,
    ResamplerConfig,
    VisionConfig,
    VLMConfig,
)
from visper_lm_tpu_torch.device import resolve_device
from visper_lm_tpu_torch.models.convnext import import_openclip_convnext
from visper_lm_tpu_torch.models.vlm import VLM

StateDict = Dict[str, torch.Tensor]

# safetensors dtype names <-> torch dtypes
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}

HEAD_NAMES = {"gen": "image_gen_heads", "seg": "image_seg_heads", "depth": "image_depth_heads"}
TOWER_PREFIX = "model.vision_tower.vision_tower.vision_model."
CONVNEXT_PREFIX = "model.vision_tower.vision_tower."


# ---------------------------------------------------------------------------
# File loading
# ---------------------------------------------------------------------------


def read_safetensors_header(path: str) -> Tuple[Dict[str, Any], int]:
    """(the JSON header, the byte offset where the tensor data starts)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    return header, 8 + n


def load_safetensors(path: str) -> StateDict:
    """{name: tensor} of a .safetensors file, each in its file dtype and
    shape; the tensors share a private (copy-on-write) map of the file."""
    header, start = read_safetensors_header(path)
    header.pop("__metadata__", None)
    if not header:
        return {}
    with open(path, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    data = np.frombuffer(buf, dtype=np.uint8)
    out: StateDict = {}
    for name, info in header.items():
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the port does not read")
        begin, end = info["data_offsets"]
        raw = torch.from_numpy(data[start + begin : start + end])
        elem = torch.empty((), dtype=dtype).element_size()
        if (start + begin) % elem:
            raw = raw.clone()                   # a misaligned tensor: copy it
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out


def load_sharded_safetensors(model_dir: str) -> StateDict:
    """model.safetensors, or the shards a model.safetensors.index.json names."""
    index = os.path.join(model_dir, "model.safetensors.index.json")
    single = os.path.join(model_dir, "model.safetensors")
    out: StateDict = {}
    if os.path.exists(index):
        with open(index) as f:
            shards = set(json.load(f)["weight_map"].values())
        for shard in sorted(shards):
            out.update(load_safetensors(os.path.join(model_dir, shard)))
    elif os.path.exists(single):
        out.update(load_safetensors(single))
    else:
        raise FileNotFoundError(f"no safetensors found under {model_dir}")
    return out


def as_state_dict(sd: Mapping[str, Any]) -> StateDict:
    """{name: tensor} from torch tensors or numpy arrays (bfloat16 arrays
    bit for bit), each in its own dtype: the counterpart of JAX's
    `torch_state_dict_to_numpy`, without its f32 copy."""
    out: StateDict = {}
    for k, v in sd.items():
        if torch.is_tensor(v):
            out[k] = v.detach()
        else:
            a = np.asarray(v)
            if a.dtype.name == "bfloat16":
                out[k] = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
            else:
                out[k] = torch.from_numpy(np.ascontiguousarray(a))
    return out


# ---------------------------------------------------------------------------
# Name mapping
# ---------------------------------------------------------------------------


def _lin(out: StateDict, name: str, sd: Mapping[str, torch.Tensor], prefix: str) -> None:
    out[f"{name}.weight"] = sd[f"{prefix}.weight"]
    if f"{prefix}.bias" in sd:
        out[f"{name}.bias"] = sd[f"{prefix}.bias"]


def _ln(out: StateDict, name: str, sd: Mapping[str, torch.Tensor], prefix: str) -> None:
    out[f"{name}.scale"] = sd[f"{prefix}.weight"]
    out[f"{name}.bias"] = sd[f"{prefix}.bias"]


def import_decoder(sd: Mapping[str, torch.Tensor], cfg: DecoderConfig,
                   prefix: str = "model.") -> StateDict:
    """A Llama / Phi3 causal LM -> `Decoder` state-dict names. Phi3's fused
    qkv_proj and gate_up_proj rows are split into views."""
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out: StateDict = {"embed_tokens.weight": sd[f"{prefix}embed_tokens.weight"]}
    for i in range(cfg.num_layers):
        lp, bp = f"{prefix}layers.{i}.", f"blocks.{i}."
        out[bp + "attn_norm.scale"] = sd[lp + "input_layernorm.weight"]
        out[bp + "mlp_norm.scale"] = sd[lp + "post_attention_layernorm.weight"]
        _lin(out, bp + "o_proj", sd, lp + "self_attn.o_proj")
        _lin(out, bp + "down_proj", sd, lp + "mlp.down_proj")
        if cfg.family == "phi3":
            q_rows, kv_rows = nh * hd, nkv * hd
            qkv = sd[lp + "self_attn.qkv_proj.weight"]          # (q + 2 kv, D)
            out[bp + "q_proj.weight"] = qkv[:q_rows]
            out[bp + "k_proj.weight"] = qkv[q_rows : q_rows + kv_rows]
            out[bp + "v_proj.weight"] = qkv[q_rows + kv_rows :]
            gu = sd[lp + "mlp.gate_up_proj.weight"]             # (2 M, D)
            out[bp + "gate_proj.weight"] = gu[: cfg.mlp_dim]
            out[bp + "up_proj.weight"] = gu[cfg.mlp_dim :]
        else:
            for name in ("q_proj", "k_proj", "v_proj"):
                _lin(out, bp + name, sd, lp + "self_attn." + name)
            for name in ("gate_proj", "up_proj"):
                _lin(out, bp + name, sd, lp + "mlp." + name)
    out["final_norm.scale"] = sd[f"{prefix}norm.weight"]
    if not cfg.tie_embeddings:
        _lin(out, "lm_head", sd, "lm_head")
    return out


def import_clip_vision(sd: Mapping[str, torch.Tensor], cfg: VisionConfig,
                       prefix: str = "vision_model.") -> StateDict:
    """HF CLIPVisionModel weights -> `VisionTower` state-dict names (q, k and
    v concatenated into the tower's fused qkv)."""
    d = cfg.hidden_size
    patch_w = sd[f"{prefix}embeddings.patch_embedding.weight"]    # (D, 3, P, P)
    out: StateDict = {
        "patch_embed.weight": patch_w.reshape(d, -1),
        "patch_embed.bias": sd.get(f"{prefix}embeddings.patch_embedding.bias",
                                   torch.zeros((d,), dtype=patch_w.dtype, device=patch_w.device)),
        "pos_embed": sd[f"{prefix}embeddings.position_embedding.weight"],
    }
    if cfg.use_class_token:
        out["cls_token"] = sd[f"{prefix}embeddings.class_embedding"].reshape(-1)
    if cfg.use_pre_norm:
        # sic: HF CLIP spells it 'pre_layrnorm'
        key = (f"{prefix}pre_layrnorm" if f"{prefix}pre_layrnorm.weight" in sd
               else f"{prefix}pre_layernorm")
        _ln(out, "pre_norm", sd, key)
    for i in range(cfg.num_layers):
        lp, bp = f"{prefix}encoder.layers.{i}.", f"blocks.{i}."
        _ln(out, bp + "norm1", sd, lp + "layer_norm1")
        for part in ("weight", "bias"):
            out[f"{bp}qkv.{part}"] = torch.cat(
                [sd[f"{lp}self_attn.{n}.{part}"] for n in ("q_proj", "k_proj", "v_proj")])
        _lin(out, bp + "proj", sd, lp + "self_attn.out_proj")
        _ln(out, bp + "norm2", sd, lp + "layer_norm2")
        _lin(out, bp + "fc1", sd, lp + "mlp.fc1")
        _lin(out, bp + "fc2", sd, lp + "mlp.fc2")
    _ln(out, "final_norm", sd, f"{prefix}post_layernorm")
    if "visual_projection.weight" in sd:
        _lin(out, "visual_projection", sd, "visual_projection")
    return out


def import_mlp_projector(sd: Mapping[str, torch.Tensor],
                         prefix: str = "model.mm_projector.") -> StateDict:
    """mlpNx_gelu Sequential: its Linears at indices 0, 2, 4, ..."""
    out: StateDict = {}
    i = 0
    while f"{prefix}{i}.weight" in sd:
        _lin(out, f"layers.{i // 2}", sd, f"{prefix}{i}")
        i += 2
    if not out and f"{prefix}weight" in sd:     # a plain 'linear' projector
        _lin(out, "layers.0", sd, prefix.rstrip("."))
    return out


def import_resampler(sd: Mapping[str, torch.Tensor], prefix: str, cfg: ResamplerConfig,
                     task_token: bool) -> StateDict:
    """The open_flamingo-style Resampler layout -> `Resampler` names."""
    out: StateDict = {}
    _lin(out, "proj_in", sd, prefix + "proj_in")
    _lin(out, "proj_out", sd, prefix + "proj_out")
    _ln(out, "norm_out", sd, prefix + "norm_out")
    if not task_token:
        out["latents"] = sd[prefix + "latents"].reshape(cfg.num_tokens, -1)
    for i in range(cfg.depth):
        lp, bp = f"{prefix}layers.{i}.", f"layers.{i}."
        _ln(out, bp + "attn.norm1", sd, lp + "0.norm1")
        _ln(out, bp + "attn.norm2", sd, lp + "0.norm2")
        for name in ("to_q", "to_kv", "to_out"):
            _lin(out, f"{bp}attn.{name}", sd, f"{lp}0.{name}")
        # FeedForward Sequential: 0 LayerNorm, 1 Linear, 3 Linear
        _ln(out, bp + "ff.norm", sd, lp + "1.0")
        _lin(out, bp + "ff.fc1", sd, lp + "1.1")
        _lin(out, bp + "ff.fc2", sd, lp + "1.3")
    return out


def import_task_head(sd: Mapping[str, torch.Tensor], prefix: str, task_cfg: DistillTaskConfig,
                     task_token: bool) -> StateDict:
    out = _prefixed("resampler.", import_resampler(
        sd, prefix + "projector.", task_cfg.head, task_token))
    if f"{prefix}linear_1.0.weight" in sd:      # the depth head's intermediate MLPs
        for j in (1, 2, 3):
            _lin(out, f"intermediate.{j - 1}.fc1", sd, f"{prefix}linear_{j}.0")
            _lin(out, f"intermediate.{j - 1}.fc2", sd, f"{prefix}linear_{j}.2")
    return out


def _prefixed(prefix: str, sd: StateDict) -> StateDict:
    return {prefix + k: v for k, v in sd.items()}


def import_vlm(sd: Mapping[str, torch.Tensor], cfg: VLMConfig) -> StateDict:
    """A full OLA / LLaVA checkpoint -> the port's `VLM` state-dict names,
    with image_newline, task tokens, heads and logit scales where the
    checkpoint has them. A ConvNeXt config reads its trunk from the timm
    keys under model.vision_tower.vision_tower. (where the reference's
    post-hoc tower reload finds them), unless the checkpoint holds a CLIP
    tower there, as JAX's importer decides."""
    out = _prefixed("decoder.", import_decoder(sd, cfg.decoder))
    out.update(_prefixed("mm_projector.", import_mlp_projector(sd)))
    if "model.image_newline" in sd:
        out["image_newline"] = sd["model.image_newline"]
    if any(k.startswith(TOWER_PREFIX) for k in sd):
        out.update(_prefixed("vision_tower.", import_clip_vision(sd, cfg.vision, TOWER_PREFIX)))
    elif cfg.use_convnext_tower and any(k.startswith(CONVNEXT_PREFIX) for k in sd):
        out.update(_prefixed("vision_tower.", import_openclip_convnext(
            sd, cfg.convnext, prefix=CONVNEXT_PREFIX)))

    d = cfg.distill
    if d is not None:
        for task in d.task_order():
            key = f"model.special_{task}_tokens"
            if key in sd:
                out[f"special_tokens.{task}"] = sd[key]
        for tcfg in d.tasks:
            for i in range(len(tcfg.layer_indices)):
                hp = f"{HEAD_NAMES[tcfg.task]}.{i}."
                if not any(k.startswith(hp) for k in sd):
                    break
                out.update(_prefixed(f"heads.{tcfg.task}.{i}.", import_task_head(
                    sd, hp, tcfg, d.num_task_tokens > 0)))
            scale_key = f"{tcfg.task}_logit_scale"
            if scale_key in sd:
                out[f"logit_scales.{tcfg.task}"] = sd[scale_key].reshape(())
    return out


def to_model(
    sd: Mapping[str, torch.Tensor],
    cfg: VLMConfig,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
) -> VLM:
    """The port's VLM holding `import_vlm`'s tensors on `device` (CUDA when
    None), moved there one tensor at a time; dtype=None keeps each tensor's
    dtype, otherwise floating tensors are cast (the counterpart of JAX's
    `to_jax`). Heads and logit scales the checkpoint lacks are left out of
    the model, as JAX's tree leaves them out; anything else missing raises."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = VLM(cfg)
        # JAX's tree holds image_newline when the checkpoint does, whatever the config
        model.image_newline = (nn.Parameter(torch.empty(cfg.decoder.hidden_size))
                               if "image_newline" in sd else None)
        if not any(k.startswith("lora.") for k in sd):
            model.lora = None           # an HF checkpoint holds no adapters
    for task in list(model.heads):
        for i in reversed(range(len(model.heads[task]))):
            if not any(k.startswith(f"heads.{task}.{i}.") for k in sd):
                del model.heads[task][i]
        if len(model.heads[task]) == 0:
            del model.heads[task]
    for task in list(model.logit_scales):
        if f"logit_scales.{task}" not in sd:
            del model.logit_scales[task]
    tensors = {}
    for name in model.state_dict():
        if name not in sd:
            raise KeyError(f"the checkpoint has no tensor for {name}")
        t = sd[name]
        cast = dtype if dtype is not None and t.is_floating_point() else t.dtype
        tensors[name] = t.to(device=device, dtype=cast)
    model.load_state_dict(tensors, strict=True, assign=True)
    return model.eval()
