"""Carry JAX-package parameter trees onto the port's modules.

The only place that knows the JAX trees' layouts (visper_lm_tpu/models/vlm.py
`init_vlm`, models/teachers `init_teachers`): stacked block leaves (L, ...)
are unstacked, linear kernels are input-major (in, out) where `nn.Linear`
holds (out, in), and conv kernels are HWIO where `nn.Conv2d` holds OIHW.
A tree is nested dicts/lists of numpy arrays (np.asarray of the JAX leaves);
bfloat16 leaves (ml_dtypes) are carried bit for bit.

`from_jax_params` maps the whole VLM tree, the distillation heads and their
logit scales included, and a decoder quantized by the JAX package
(`quantize_linear_weights` / `quantize_linear_weights_int4`): its
{kernel_q8, out_scale} and {kernel_q4p, q4_scale[, q4_in_scale]} leaves
become `QuantLinear` buffers as they are (both input-major), bit for bit.
`teachers_from_jax_params` maps the teachers' tree (dinov2, clip_h, swin; the
DPT decoder is not ported yet and is skipped).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from visper_lm_tpu_torch.config import VLMConfig
from visper_lm_tpu_torch.device import resolve_device
from visper_lm_tpu_torch.models.decoder import LINEAR_NAMES, Decoder
from visper_lm_tpu_torch.models.teachers import TeacherConfigs, build_teachers
from visper_lm_tpu_torch.models.vlm import VLM
from visper_lm_tpu_torch.utils.param import QuantLinear

_VLM_SUBTREES = (
    "decoder", "vision_tower", "mm_projector", "special_tokens", "heads", "logit_scales",
)
# JAX quantized-linear leaf -> QuantLinear buffer (same layout, no transpose)
_QUANT_LEAVES = {
    "kernel_q8": "weight_q8", "out_scale": "out_scale", "kernel_q4p": "weight_q4p",
    "q4_scale": "q4_scale", "q4_in_scale": "q4_in_scale",
}


def _tensor(x: Any) -> torch.Tensor:
    # an owned, writable C-order copy: JAX leaves convert to read-only arrays
    a = np.array(x, copy=True, order="C")
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):   # V2: bf16 read from an npz
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaf(name: str, x: Any):
    """(port leaf name, value) for one JAX leaf name."""
    a = np.asarray(x)
    if name == "kernel":
        if a.ndim == 4:                     # conv HWIO -> OIHW
            return "weight", a.transpose(3, 2, 0, 1)
        return "weight", a.T
    if name == "embedding":
        return "weight", a
    return _QUANT_LEAVES.get(name, name), a


def _flatten(sd: Dict[str, Any], prefix: str, tree: Any) -> None:
    """Every leaf of a (non-stacked) subtree under `prefix`."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(v, (dict, list, tuple)):
                _flatten(sd, f"{prefix}.{k}", v)
            else:
                name, val = _leaf(k, v)
                sd[f"{prefix}.{name}"] = val
    else:
        for i, v in enumerate(tree):
            _flatten(sd, f"{prefix}.{i}", v)


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _stacked(sd: Dict[str, Any], prefix: str, blocks: Dict[str, Any], n: int) -> None:
    for i in range(n):
        _flatten(sd, f"{prefix}.{i}", _unstack(blocks, i))


def _vit(sd: Dict[str, Any], prefix: str, tree: Dict[str, Any], num_layers: int) -> None:
    rest = {k: v for k, v in tree.items() if k != "blocks"}
    _flatten(sd, prefix, rest)
    _stacked(sd, f"{prefix}.blocks", tree["blocks"], num_layers)


def jax_tree_to_state_dict(tree: Dict[str, Any], cfg: VLMConfig) -> Dict[str, Any]:
    """Map the JAX VLM param tree onto the port's state_dict names (numpy values)."""
    unknown = set(tree) - set(_VLM_SUBTREES)
    if unknown:
        raise NotImplementedError(f"param subtrees not ported yet: {sorted(unknown)}")
    sd: Dict[str, Any] = {}
    dec = tree["decoder"]
    _flatten(sd, "decoder", {k: v for k, v in dec.items() if k != "blocks"})
    _stacked(sd, "decoder.blocks", dec["blocks"], cfg.decoder.num_layers)
    _vit(sd, "vision_tower", tree["vision_tower"], cfg.vision.num_layers)
    for name in ("mm_projector", "special_tokens", "heads", "logit_scales"):
        if name in tree:
            _flatten(sd, name, tree[name])
    return sd


def _quant_shells(decoder: Decoder, tree: Dict[str, Any]) -> None:
    """Put a meta-device `QuantLinear` of the right buffer shapes wherever the
    JAX decoder tree holds a quantized linear (stacked blocks: (L, ...))."""

    def shell(p: Dict[str, Any], stacked: bool) -> QuantLinear:
        bufs = {}
        for k, v in p.items():
            a = np.asarray(v)
            dt = torch.from_numpy(np.zeros((0,), a.dtype)).dtype
            bufs[_QUANT_LEAVES[k]] = torch.empty(a.shape[1:] if stacked else a.shape, dtype=dt)
        return QuantLinear(**bufs)

    for name in LINEAR_NAMES:
        p = tree["blocks"][name]
        if "kernel" not in p:
            for block in decoder.blocks:
                setattr(block, name, shell(p, stacked=True))
    if "lm_head" in tree and "kernel" not in tree["lm_head"]:
        decoder.lm_head = shell(tree["lm_head"], stacked=False)


def _load(module: nn.Module, sd: Dict[str, Any], device, dtype) -> None:
    tensors = {}
    for name, leaf in sd.items():
        t = _tensor(leaf)
        # quantized linears keep their f32 scales whatever the model dtype
        if dtype is not None and t.is_floating_point() and name.rsplit(".", 1)[-1] not in _QUANT_LEAVES.values():
            t = t.to(dtype)
        tensors[name] = t.to(device)
    module.load_state_dict(tensors, strict=True, assign=True)


def load_jax_tree(
    module: nn.Module, tree: Dict[str, Any], device: Union[str, torch.device],
    dtype: Optional[torch.dtype] = None,
) -> nn.Module:
    """Load a JAX subtree with no stacked blocks (a head, a resampler) into
    `module` in place, strictly; returns the module."""
    sd: Dict[str, Any] = {}
    _flatten(sd, "", tree)
    _load(module, {k[1:]: v for k, v in sd.items()}, torch.device(device), dtype)
    return module


def from_jax_params(
    tree: Dict[str, Any],
    cfg: VLMConfig,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
) -> VLM:
    """A VLM holding the JAX tree's weights on `device` (CUDA when None);
    quantized decoder linears become `QuantLinear`s.

    dtype=None keeps each leaf's dtype; otherwise floating leaves other than
    the quantization scales are cast."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = VLM(cfg)
        _quant_shells(model.decoder, tree["decoder"])
    _load(model, jax_tree_to_state_dict(tree, cfg), device, dtype)
    return model.eval()


def teachers_from_jax_params(
    tree: Dict[str, Any],
    cfg: VLMConfig,
    tcfgs: Optional[TeacherConfigs] = None,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
) -> nn.ModuleDict:
    """The teachers (frozen, eval) holding the JAX `init_teachers` tree's
    weights, for each of dinov2, clip_h and swin the tree holds: the towers
    with their stacked blocks unstacked, swin with its stacked blocks per
    stage unstacked, rel_bias and downsample weights carried."""
    device = resolve_device(device)
    tcfgs = tcfgs or TeacherConfigs()
    with torch.device("meta"):
        built = build_teachers(cfg, tcfgs)
    teachers = nn.ModuleDict({n: m for n, m in built.items() if n in tree})
    sd: Dict[str, Any] = {}
    for name in teachers:
        sub = tree[name]
        if name == "dinov2":
            _vit(sd, name, sub, tcfgs.dinov2.num_layers)
        elif name == "clip_h":
            _vit(sd, name, sub, tcfgs.clip_h.num_layers)
        else:
            _flatten(sd, name, {k: v for k, v in sub.items() if k != "stages"})
            for s, stage in enumerate(sub["stages"]):
                pre = f"{name}.stages.{s}"
                _stacked(sd, f"{pre}.blocks", stage["blocks"], tcfgs.swin.depths[s])
                if "downsample" in stage:
                    _flatten(sd, f"{pre}.downsample", stage["downsample"])
    _load(teachers, sd, device, dtype)
    return teachers.requires_grad_(False).eval()
