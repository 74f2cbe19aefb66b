"""Carry a JAX-package parameter tree onto the port's modules.

The only place that knows the JAX tree's layout (visper_lm_tpu/models/vlm.py
`init_vlm`): decoder block leaves are stacked (L, ...) and get unstacked, and
linear kernels are input-major (in, out) where `nn.Linear` holds (out, in).
The tree is nested dicts/lists of numpy arrays (np.asarray of the JAX leaves);
bfloat16 leaves (ml_dtypes) are carried bit for bit.

The `heads` and `logit_scales` subtrees (distillation heads and their
contrastive scales) are not on the serving path and are ignored.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from visper_lm_tpu_torch.config import VLMConfig
from visper_lm_tpu_torch.device import resolve_device
from visper_lm_tpu_torch.models.vlm import VLM

IGNORED_SUBTREES = ("heads", "logit_scales")
_SERVED_SUBTREES = ("decoder", "vision_tower", "mm_projector", "special_tokens")

_DECODER_LINEARS = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"
)
_VIT_LINEARS = ("qkv", "proj", "fc1", "fc2")


def _tensor(x: Any) -> torch.Tensor:
    # an owned, writable C-order copy: JAX leaves convert to read-only arrays
    a = np.array(x, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _linear(sd: Dict[str, Any], prefix: str, p: Dict[str, Any], index=None) -> None:
    kernel = np.asarray(p["kernel"])
    if index is not None:
        kernel = kernel[index]
    sd[f"{prefix}.weight"] = kernel.T
    if "bias" in p:
        bias = np.asarray(p["bias"])
        sd[f"{prefix}.bias"] = bias if index is None else bias[index]


def _norm(sd: Dict[str, Any], prefix: str, p: Dict[str, Any], index=None) -> None:
    for name in ("scale", "bias"):
        if name in p:
            leaf = np.asarray(p[name])
            sd[f"{prefix}.{name}"] = leaf if index is None else leaf[index]


def jax_tree_to_state_dict(tree: Dict[str, Any], cfg: VLMConfig) -> Dict[str, Any]:
    """Map the JAX param tree onto the port's state_dict names (numpy values)."""
    unknown = set(tree) - set(_SERVED_SUBTREES) - set(IGNORED_SUBTREES)
    if unknown:
        raise NotImplementedError(f"param subtrees not ported yet: {sorted(unknown)}")
    sd: Dict[str, Any] = {}

    dec = tree["decoder"]
    blocks = dec["blocks"]
    sd["decoder.embed_tokens.weight"] = dec["embed_tokens"]["embedding"]
    for i in range(cfg.decoder.num_layers):
        pre = f"decoder.blocks.{i}"
        _norm(sd, f"{pre}.attn_norm", blocks["attn_norm"], i)
        _norm(sd, f"{pre}.mlp_norm", blocks["mlp_norm"], i)
        for name in _DECODER_LINEARS:
            _linear(sd, f"{pre}.{name}", blocks[name], i)
    _norm(sd, "decoder.final_norm", dec["final_norm"])
    if "lm_head" in dec:
        _linear(sd, "decoder.lm_head", dec["lm_head"])

    vt = tree["vision_tower"]
    _linear(sd, "vision_tower.patch_embed", vt["patch_embed"])
    sd["vision_tower.pos_embed"] = vt["pos_embed"]
    sd["vision_tower.cls_token"] = vt["cls_token"]
    _norm(sd, "vision_tower.pre_norm", vt["pre_norm"])
    _norm(sd, "vision_tower.final_norm", vt["final_norm"])
    for i in range(cfg.vision.num_layers):
        pre = f"vision_tower.blocks.{i}"
        _norm(sd, f"{pre}.norm1", vt["blocks"]["norm1"], i)
        _norm(sd, f"{pre}.norm2", vt["blocks"]["norm2"], i)
        for name in _VIT_LINEARS:
            _linear(sd, f"{pre}.{name}", vt["blocks"][name], i)

    for j, layer in enumerate(tree["mm_projector"].get("layers", ())):
        _linear(sd, f"mm_projector.layers.{j}", layer)
    for task, tok in tree.get("special_tokens", {}).items():
        sd[f"special_tokens.{task}"] = tok
    return sd


def from_jax_params(
    tree: Dict[str, Any],
    cfg: VLMConfig,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
) -> VLM:
    """A VLM holding the JAX tree's weights on `device` (CUDA when None).

    dtype=None keeps each leaf's dtype; otherwise floating leaves are cast."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = VLM(cfg)
    sd = {}
    for name, leaf in jax_tree_to_state_dict(tree, cfg).items():
        t = _tensor(leaf)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        sd[name] = t.to(device)
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval()
