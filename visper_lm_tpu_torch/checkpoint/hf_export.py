"""HF checkpoint export: the port's VLM -> the reference's state-dict keys
and safetensors files (counterpart of visper_lm_tpu/checkpoint/hf_export.py).

The inverse of hf_import: the same key surface, Phi3's q/k/v and gate/up
fused again, the CLIP tower's fused qkv split into q/k/v (views), a ConvNeXt
trunk in timm layout. Tensors keep their dtype (bf16 on the card) and stay
where they are until the writer copies them to the host one at a time.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Union

import torch
import torch.nn as nn

from visper_lm_tpu_torch.checkpoint.hf_import import (
    CONVNEXT_PREFIX,
    HEAD_NAMES,
    SAFETENSORS_DTYPES,
    TOWER_PREFIX,
)
from visper_lm_tpu_torch.config import DecoderConfig, VisionConfig, VLMConfig, config_to_json
from visper_lm_tpu_torch.models.convnext import export_openclip_convnext

StateDict = Dict[str, torch.Tensor]
_DTYPE_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}


def export_linear(sd: StateDict, prefix: str, params: Mapping[str, torch.Tensor], name: str) -> None:
    sd[prefix + ".weight"] = params[name + ".weight"]
    if name + ".bias" in params:
        sd[prefix + ".bias"] = params[name + ".bias"]


def export_ln(sd: StateDict, prefix: str, params: Mapping[str, torch.Tensor], name: str) -> None:
    sd[prefix + ".weight"] = params[name + ".scale"]
    if name + ".bias" in params:
        sd[prefix + ".bias"] = params[name + ".bias"]


def _sub(params: Mapping[str, torch.Tensor], prefix: str) -> StateDict:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def export_decoder(params: Mapping[str, torch.Tensor], cfg: DecoderConfig,
                   prefix: str = "model.") -> StateDict:
    """`Decoder` state-dict names -> a Llama / Phi3 causal LM's keys."""
    sd: StateDict = {f"{prefix}embed_tokens.weight": params["embed_tokens.weight"]}
    export_ln(sd, f"{prefix}norm", params, "final_norm")
    if "lm_head.weight" in params:
        export_linear(sd, "lm_head", params, "lm_head")
    for i in range(cfg.num_layers):
        lp, bp = f"{prefix}layers.{i}.", f"blocks.{i}."
        export_ln(sd, lp + "input_layernorm", params, bp + "attn_norm")
        export_ln(sd, lp + "post_attention_layernorm", params, bp + "mlp_norm")
        export_linear(sd, lp + "self_attn.o_proj", params, bp + "o_proj")
        export_linear(sd, lp + "mlp.down_proj", params, bp + "down_proj")
        if cfg.family == "phi3":
            sd[lp + "self_attn.qkv_proj.weight"] = torch.cat(
                [params[f"{bp}{n}.weight"] for n in ("q_proj", "k_proj", "v_proj")])
            sd[lp + "mlp.gate_up_proj.weight"] = torch.cat(
                [params[f"{bp}{n}.weight"] for n in ("gate_proj", "up_proj")])
        else:
            for name in ("q_proj", "k_proj", "v_proj"):
                export_linear(sd, lp + "self_attn." + name, params, bp + name)
            for name in ("gate_proj", "up_proj"):
                export_linear(sd, lp + "mlp." + name, params, bp + name)
    return sd


def export_clip_vision(params: Mapping[str, torch.Tensor], cfg: VisionConfig,
                       prefix: str = "vision_model.") -> StateDict:
    """`VisionTower` state-dict names -> HF CLIPVisionModel keys."""
    d = cfg.hidden_size
    sd: StateDict = {
        f"{prefix}embeddings.patch_embedding.weight":
            params["patch_embed.weight"].reshape(d, 3, cfg.patch_size, cfg.patch_size),
        f"{prefix}embeddings.position_embedding.weight": params["pos_embed"],
    }
    if "cls_token" in params:
        sd[f"{prefix}embeddings.class_embedding"] = params["cls_token"]
    if "pre_norm.scale" in params:
        export_ln(sd, f"{prefix}pre_layrnorm", params, "pre_norm")
    export_ln(sd, f"{prefix}post_layernorm", params, "final_norm")
    for i in range(cfg.num_layers):
        lp, bp = f"{prefix}encoder.layers.{i}.", f"blocks.{i}."
        export_ln(sd, lp + "layer_norm1", params, bp + "norm1")
        export_ln(sd, lp + "layer_norm2", params, bp + "norm2")
        for part in ("weight", "bias"):
            qkv = params[f"{bp}qkv.{part}"]
            for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
                sd[f"{lp}self_attn.{name}.{part}"] = qkv[j * d : (j + 1) * d]
        export_linear(sd, lp + "self_attn.out_proj", params, bp + "proj")
        export_linear(sd, lp + "mlp.fc1", params, bp + "fc1")
        export_linear(sd, lp + "mlp.fc2", params, bp + "fc2")
    if "visual_projection.weight" in params:
        export_linear(sd, "visual_projection", params, "visual_projection")
    return sd


def export_resampler(sd: StateDict, prefix: str, params: Mapping[str, torch.Tensor]) -> None:
    """`Resampler` state-dict names -> the open_flamingo-style layout."""
    export_linear(sd, prefix + "proj_in", params, "proj_in")
    export_linear(sd, prefix + "proj_out", params, "proj_out")
    export_ln(sd, prefix + "norm_out", params, "norm_out")
    if "latents" in params:
        sd[prefix + "latents"] = params["latents"][None]
    i = 0
    while f"layers.{i}.attn.to_q.weight" in params:
        lp, bp = f"{prefix}layers.{i}.", f"layers.{i}."
        export_ln(sd, lp + "0.norm1", params, bp + "attn.norm1")
        export_ln(sd, lp + "0.norm2", params, bp + "attn.norm2")
        for name in ("to_q", "to_kv", "to_out"):
            export_linear(sd, f"{lp}0.{name}", params, f"{bp}attn.{name}")
        export_ln(sd, lp + "1.0", params, bp + "ff.norm")
        export_linear(sd, lp + "1.1", params, bp + "ff.fc1")
        export_linear(sd, lp + "1.3", params, bp + "ff.fc2")
        i += 1


def export_vlm(model: Union[nn.Module, Mapping[str, torch.Tensor]], cfg: VLMConfig) -> StateDict:
    """The full OLA / LLaVA state dict of a `VLM` (or of its state dict)."""
    params = model.state_dict() if isinstance(model, nn.Module) else dict(model)
    if any(".blocks_chunks." in k for k in params):
        raise NotImplementedError(
            "the stream-grads decoder layout is not ported yet (ROADMAP queue A, item 11)")
    sd = export_decoder(_sub(params, "decoder."), cfg.decoder)
    projector = _sub(params, "mm_projector.")
    i = 0
    while f"layers.{i}.weight" in projector:
        export_linear(sd, f"model.mm_projector.{2 * i}", projector, f"layers.{i}")
        i += 1
    if "image_newline" in params:
        sd["model.image_newline"] = params["image_newline"]
    tower = _sub(params, "vision_tower.")
    if tower and cfg.use_convnext_tower:
        sd.update(export_openclip_convnext(tower, cfg.convnext, prefix=CONVNEXT_PREFIX))
    elif tower:
        sd.update(export_clip_vision(tower, cfg.vision, prefix=TOWER_PREFIX))
    if cfg.distill is not None:
        for task, tok in _sub(params, "special_tokens.").items():
            sd[f"model.special_{task}_tokens"] = tok
        for tcfg in cfg.distill.tasks:
            for i in range(len(tcfg.layer_indices)):
                head = _sub(params, f"heads.{tcfg.task}.{i}.")
                if not head:
                    break
                hp = f"{HEAD_NAMES[tcfg.task]}.{i}."
                export_resampler(sd, hp + "projector.", _sub(head, "resampler."))
                for j in (1, 2, 3):
                    if f"intermediate.{j - 1}.fc1.weight" in head:
                        export_linear(sd, f"{hp}linear_{j}.0", head, f"intermediate.{j - 1}.fc1")
                        export_linear(sd, f"{hp}linear_{j}.2", head, f"intermediate.{j - 1}.fc2")
        for task, scale in _sub(params, "logit_scales.").items():
            sd[f"{task}_logit_scale"] = scale.reshape(())
    return sd


def save_safetensors(sd: Mapping[str, torch.Tensor], path: str) -> None:
    """Write a .safetensors file (the port's own writer): tensors in their
    dtype, ordered as the safetensors package orders them (wider dtypes
    first, then by name) so every tensor's data is aligned, the header
    padded with spaces to a multiple of 8 bytes, {"format": "pt"} as its
    metadata (what transformers' loader accepts). Device tensors are copied
    to the host one at a time."""
    def order(item):
        name, t = item
        return (-t.element_size(), name)

    items = sorted(((k, v.detach()) for k, v in sd.items()), key=order)
    header: Dict[str, Any] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, t in items:
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name here")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for _, t in items:
            host = t.contiguous().reshape(-1).cpu()
            f.write(memoryview(host.view(torch.uint8).numpy()))


def save_hf_checkpoint(model_dir: str, model: Union[nn.Module, Mapping[str, torch.Tensor]],
                       cfg: VLMConfig) -> None:
    """A complete HF-layout checkpoint directory: model.safetensors in the
    reference's keys and a config.json that holds both the HF decoder fields
    (LlamaForCausalLM / Phi3ForCausalLM) and the whole VLMConfig under
    "visper_config", which `api.VisperModel.from_hf_checkpoint` reads back."""
    os.makedirs(model_dir, exist_ok=True)
    sd = export_vlm(model, cfg)
    save_safetensors(sd, os.path.join(model_dir, "model.safetensors"))
    d = cfg.decoder
    arch = "Phi3ForCausalLM" if d.family == "phi3" else "LlamaForCausalLM"
    dtype = sd["model.embed_tokens.weight"].dtype
    hf_cfg = {
        "architectures": [arch],
        "model_type": "phi3" if d.family == "phi3" else "llama",
        "vocab_size": d.vocab_size,
        "hidden_size": d.hidden_size,
        "intermediate_size": d.mlp_dim,
        "num_hidden_layers": d.num_layers,
        "num_attention_heads": d.num_heads,
        "num_key_value_heads": d.num_kv_heads,
        "head_dim": d.head_dim,
        "rope_theta": d.rope_theta,
        "rms_norm_eps": d.norm_eps,
        "max_position_embeddings": d.max_seq_len,
        "max_sequence_length": d.max_seq_len,
        "tie_word_embeddings": d.tie_embeddings,
        "torch_dtype": str(dtype).removeprefix("torch."),
        "mm_vision_tower": "convnext" if cfg.use_convnext_tower else "clip",
        "mm_patch_merge_type": cfg.mm_patch_merge_type,
        "image_aspect_ratio": cfg.image_aspect_ratio,
        "mm_use_im_patch_token": False,
        "visper_config": json.loads(config_to_json(cfg)),
    }
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=1)
