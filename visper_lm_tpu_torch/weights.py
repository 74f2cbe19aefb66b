"""Carry JAX-package parameter trees onto the port's modules.

The only place that knows the JAX trees' layouts (visper_lm_tpu/models/vlm.py
`init_vlm`, models/teachers `init_teachers`): stacked block leaves (L, ...)
are unstacked, linear kernels are input-major (in, out) where `nn.Linear`
holds (out, in), and conv kernels are HWIO where `nn.Conv2d` holds OIHW.
A tree is nested dicts/lists of numpy arrays (np.asarray of the JAX leaves);
bfloat16 leaves (ml_dtypes) are carried bit for bit.

`from_jax_params` maps the whole VLM tree (a CLIP or ConvNeXt tower, each
ConvNeXt stage's stacked blocks unstacked; image_newline), the distillation
heads and their logit scales, the LoRA factors (`params["lora"]`, stacked
as they are), and a decoder quantized by the JAX package
(`quantize_linear_weights` / `quantize_linear_weights_int4`): its
{kernel_q8, out_scale} and {kernel_q4p, q4_scale[, q4_in_scale]} leaves
become `QuantLinear` buffers as they are (both input-major), bit for bit.
`decoder_from_jax_params` maps a bare decoder tree (beam search and
speculative decoding take one). A MoE decoder's `moe_router` (L, D, E) is
transposed like a linear kernel and stays f32 whatever `dtype` asks; its
expert banks `moe_gate` / `moe_up` / `moe_down` (L, E, din, dout) keep
JAX's layout (`ExpertBank`), and with `ep=` a rank takes its E/ep experts
on the host. `teachers_from_jax_params` maps the
teachers' tree (dinov2, clip_h, swin and the DPT depth decoder `dpt`).
`load_jax_tree` loads a subtree with no stacked blocks into a module: a probe
head (`ProbeHead`), an `AttentionPool2d`, a task head; a None leaf (an
identity projection) is skipped. The visualisation decoders have loaders of
their own: `dpt_from_jax_params` (its two transposed convs are (kh, kw, in,
out) in JAX, (in, out, kh, kw) in `nn.ConvTranspose2d`),
`oneformer_from_jax_params`, `swin_from_jax_params` and
`genpipe_from_jax_params` (the text encoder's stacked blocks unstacked).
`module_to_jax_tree` is the way back: a module's JAX-layout tree, which
`utils.param.save_tree_npz` writes as the JAX package's .npz bundles.

A tree trained with JAX's gradient streaming holds its decoder blocks as
`blocks_chunks` sub-stacks: every decoder entry point here stacks them
back first (`normalize_stream_layout`, JAX's rule at its serving and export
boundaries).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from visper_lm_tpu_torch.config import DecoderConfig, VLMConfig
from visper_lm_tpu_torch.device import resolve_device
from visper_lm_tpu_torch.models.decoder import Decoder, block_linears, normalize_stream_layout
from visper_lm_tpu_torch.models.teachers import TeacherConfigs, build_teachers
from visper_lm_tpu_torch.models.vlm import VLM
from visper_lm_tpu_torch.parallel.pipeline import foreign_names, shard_pipeline
from visper_lm_tpu_torch.parallel.tensor import model_placements, shard_model
from visper_lm_tpu_torch.utils.param import QuantLinear, is_expert_kernel, jax_path, to_numpy

_VLM_SUBTREES = (
    "decoder", "vision_tower", "mm_projector", "special_tokens", "heads", "logit_scales",
    "image_newline", "lora",
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


def _leaf(name: str, x: Any, prefix: str = ""):
    """(port leaf name, value) for one JAX leaf name under `prefix`."""
    a = np.asarray(x)
    if name == "kernel" and is_expert_kernel(jax_path(f"{prefix}.kernel")):
        return "kernel", a                  # (E, din, dout) as JAX holds it
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
            if v is None:
                continue
            if isinstance(v, (dict, list, tuple)):
                _flatten(sd, f"{prefix}.{k}", v)
            else:
                name, val = _leaf(k, v, prefix)
                sd[f"{prefix}.{name}"] = val
    else:
        for i, v in enumerate(tree):
            if v is not None:
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


def _convnext(sd: Dict[str, Any], prefix: str, tree: Dict[str, Any]) -> None:
    _flatten(sd, prefix, {k: v for k, v in tree.items() if k != "stages"})
    for s, stage in enumerate(tree["stages"]):
        pre = f"{prefix}.stages.{s}"
        depth = np.asarray(stage["blocks"]["gamma"]).shape[0]
        _stacked(sd, f"{pre}.blocks", stage["blocks"], depth)
        if "downsample" in stage:
            _flatten(sd, f"{pre}.downsample", stage["downsample"])


def decoder_tree_to_state_dict(tree: Dict[str, Any], num_layers: int) -> Dict[str, Any]:
    """A bare JAX decoder tree -> `Decoder` state-dict names (numpy values)."""
    tree = normalize_stream_layout({"decoder": tree})["decoder"]
    sd: Dict[str, Any] = {}
    _flatten(sd, "", {k: v for k, v in tree.items() if k != "blocks"})
    _stacked(sd, ".blocks", tree["blocks"], num_layers)
    return {k[1:]: v for k, v in sd.items()}


def vit_tree_to_state_dict(tree: Dict[str, Any], num_layers: int) -> Dict[str, Any]:
    """A JAX ViT tree -> `VisionTower` state-dict names (numpy values)."""
    sd: Dict[str, Any] = {}
    _vit(sd, "", tree, num_layers)
    return {k[1:]: v for k, v in sd.items()}


def convnext_tree_to_state_dict(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX ConvNeXt tree -> `ConvNeXt` state-dict names (numpy values)."""
    sd: Dict[str, Any] = {}
    _convnext(sd, "", tree)
    return {k[1:]: v for k, v in sd.items()}


def jax_tree_to_state_dict(tree: Dict[str, Any], cfg: VLMConfig) -> Dict[str, Any]:
    """Map the JAX VLM param tree onto the port's state_dict names (numpy values)."""
    tree = normalize_stream_layout(tree)
    unknown = set(tree) - set(_VLM_SUBTREES)
    if unknown:
        raise NotImplementedError(f"param subtrees not ported yet: {sorted(unknown)}")
    sd: Dict[str, Any] = {}
    dec = tree["decoder"]
    _flatten(sd, "decoder", {k: v for k, v in dec.items() if k != "blocks"})
    _stacked(sd, "decoder.blocks", dec["blocks"], cfg.decoder.num_layers)
    if cfg.use_convnext_tower:
        _convnext(sd, "vision_tower", tree["vision_tower"])
    else:
        _vit(sd, "vision_tower", tree["vision_tower"], cfg.vision.num_layers)
    # lora: {target: {a (L, din, r), b (L, r, dout)}}, stacked as the port keeps it
    for name in ("mm_projector", "special_tokens", "heads", "logit_scales", "lora"):
        if name in tree:
            _flatten(sd, name, tree[name])
    if "image_newline" in tree:
        sd["image_newline"] = np.asarray(tree["image_newline"])
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

    for name in block_linears(decoder.cfg):
        p = tree["blocks"][name]
        if "kernel" not in p:
            for block in decoder.blocks:
                setattr(block, name, shell(p, stacked=True))
    if "lm_head" in tree and "kernel" not in tree["lm_head"]:
        decoder.lm_head = shell(tree["lm_head"], stacked=False)


def _load(module: nn.Module, sd: Dict[str, Any], device, dtype, freed=()) -> None:
    """The state dict `sd` (host leaves) into `module` on `device`; the
    names in `freed` (blocks another pipeline stage owns) get storage-less
    tensors of their shape instead, one at a time."""
    tensors = {}
    for name, leaf in sd.items():
        if name in freed:
            a = np.asarray(leaf)
            t = torch.empty(a.shape, dtype=dtype or _tensor(a.reshape(-1)[:1]).dtype,
                            device=device)
            t.untyped_storage().resize_(0)
            tensors[name] = t
            continue
        t = _tensor(leaf)
        # quantized linears keep their f32 scales, a MoE router its f32
        # weight, whatever the model dtype
        if (dtype is not None and t.is_floating_point() and ".moe_router." not in f".{name}"
                and name.rsplit(".", 1)[-1] not in _QUANT_LEAVES.values()):
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
    tp=None,
    pp=None,
    ep=None,
) -> VLM:
    """A VLM holding the JAX tree's weights on `device` (CUDA when None);
    quantized decoder linears become `QuantLinear`s.

    dtype=None keeps each leaf's dtype; otherwise floating leaves other than
    the quantization scales are cast. tp (parallel/tensor.TensorParallel):
    the rank's tensor-parallel form, each split leaf (a quantized linear's
    buffers too, `parallel/tensor.QUANT_DIMS`) sliced on the host before it
    is copied (a rank never holds the whole decoder on the device); the
    LoRA factors stay whole.
    pp (parallel/pipeline.PipeParallel): the stage's form, the stacked
    blocks cut on the host: only the stage's own blocks are copied, the
    others are storage-less (`pipeline.whole_params` gathers them back).
    ep (parallel/distributed.AxisGroup): a MoE decoder's expert-parallel form, each
    bank's E/ep experts of the rank cut on the host."""
    device = resolve_device(device)
    tree = normalize_stream_layout(tree)
    with torch.device("meta"):
        model = VLM(cfg, ep=ep)
        # the tree holds image_newline when JAX's init or importer put it there
        model.image_newline = (nn.Parameter(torch.empty(cfg.decoder.hidden_size))
                               if "image_newline" in tree else None)
        _quant_shells(model.decoder, tree["decoder"])
        shard_pipeline(shard_model(model, tp), pp)
    sd = jax_tree_to_state_dict(tree, cfg)
    expert_slices(model.decoder, sd, "decoder.")
    _tp_slices(model, sd, tp)
    _load(model, sd, device, dtype, freed=set(foreign_names(model)))
    return model.eval()


def _tp_slices(model: nn.Module, sd: Dict[str, Any], tp) -> None:
    """In place: each leaf of `sd` (host arrays) that tensor parallelism
    splits cut to the rank's slice (nothing without tp)."""
    for name, pl in model_placements(model).items():
        a = np.asarray(sd[name])
        size = a.shape[pl.model_dim] // pl.model_parts
        index = [slice(None)] * a.ndim
        index[pl.model_dim] = slice(tp.rank * size, (tp.rank + 1) * size)
        sd[name] = a[tuple(index)]


def expert_slices(decoder: Decoder, sd: Dict[str, Any], prefix: str = "") -> None:
    """In place: each expert bank of `sd` (host arrays, all E experts) cut
    to the experts the decoder's rank holds (nothing without expert
    parallelism)."""
    for name, p in decoder.named_parameters():
        if is_expert_kernel(jax_path(f"decoder.{name}")):
            bank = decoder.get_submodule(name.rsplit(".", 1)[0])
            sd[prefix + name] = np.asarray(sd[prefix + name])[
                bank.first:bank.first + p.shape[0]]


def decoder_from_jax_params(
    tree: Dict[str, Any],
    decoder_cfg: DecoderConfig,
    device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
    tp=None,
) -> Decoder:
    """A `Decoder` holding a bare JAX decoder tree's weights (what
    `init_decoder` returns, and what beam search and speculative decoding
    take) on `device` (CUDA when None): stacked blocks unstacked, quantized
    linears as `QuantLinear`s, dtype and tp as in `from_jax_params`."""
    device = resolve_device(device)
    tree = normalize_stream_layout({"decoder": tree})["decoder"]
    with torch.device("meta"):
        decoder = Decoder(decoder_cfg)
        _quant_shells(decoder, tree)
        shard_model(decoder, tp)
    sd = decoder_tree_to_state_dict(tree, decoder_cfg.num_layers)
    _tp_slices(decoder, sd, tp)
    _load(decoder, sd, device, dtype)
    return decoder.eval()


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
        elif name == "dpt":
            _dpt(sd, name, sub)
        else:
            _swin(sd, name, sub, tcfgs.swin.depths)
    _load(teachers, sd, device, dtype)
    return teachers.requires_grad_(False).eval()


def _swin(sd: Dict[str, Any], prefix: str, tree: Dict[str, Any], depths: Sequence[int]) -> None:
    _flatten(sd, prefix, {k: v for k, v in tree.items() if k != "stages"})
    for s, stage in enumerate(tree["stages"]):
        pre = f"{prefix}.stages.{s}"
        _stacked(sd, f"{pre}.blocks", stage["blocks"], depths[s])
        if "downsample" in stage:
            _flatten(sd, f"{pre}.downsample", stage["downsample"])


# the DPT head's transposed convs: JAX (kh, kw, in, out), nn.ConvTranspose2d (in, out, kh, kw)
_DPT_DECONVS = ("resize0", "resize1")


def _dpt(sd: Dict[str, Any], prefix: str, tree: Dict[str, Any]) -> None:
    _flatten(sd, prefix, tree)
    for name in _DPT_DECONVS:
        sd[f"{prefix}.{name}.weight"] = np.asarray(tree[name]["kernel"]).transpose(2, 3, 0, 1)


def dpt_from_jax_params(
    tree: Dict[str, Any], device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
) -> nn.Module:
    """A frozen `DPTHead` holding a JAX `init_dpt_head` / `import_dpt_head`
    tree, its widths read from the tree (DAv2-L's, or a smaller test head's)."""
    from visper_lm_tpu_torch.models.teachers.dpt import DPTHead

    device = resolve_device(device)
    projects = [np.asarray(p["kernel"]) for p in tree["projects"]]
    with torch.device("meta"):
        head = DPTHead(
            in_channels=projects[0].shape[2], out_channels=tuple(k.shape[3] for k in projects),
            features=np.asarray(tree["layer_rn"][0]["kernel"]).shape[3],
        )
    sd: Dict[str, Any] = {}
    _dpt(sd, "", tree)
    _load(head, {k[1:]: v for k, v in sd.items()}, device, dtype)
    return head.requires_grad_(False).eval()


def swin_from_jax_params(
    tree: Dict[str, Any], cfg, device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
) -> nn.Module:
    """A frozen `SwinBackbone` of `cfg` holding a JAX `init_swin` /
    `import_swin_backbone` tree (its stacked blocks unstacked per stage)."""
    from visper_lm_tpu_torch.models.teachers.swin import SwinBackbone

    device = resolve_device(device)
    with torch.device("meta"):
        model = SwinBackbone(cfg)
    sd: Dict[str, Any] = {}
    _swin(sd, "", tree, cfg.depths)
    _load(model, {k[1:]: v for k, v in sd.items()}, device, dtype)
    return model.requires_grad_(False).eval()


def oneformer_from_jax_params(
    tree: Dict[str, Any], cfg, device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
) -> nn.Module:
    """A frozen `OneFormerDecoder` of `cfg` holding a JAX
    `import_oneformer_decoder` tree; a transformer-decoder input projection
    the tree holds as None (conv_dim == hidden_dim) is an identity. The layer
    counts, feed-forward widths, query, class and task-text sizes are the
    tree's (JAX reads them from the params, not the config; an HF
    config.json without num_labels gives the config COCO's 133)."""
    import dataclasses

    from visper_lm_tpu_torch.models.teachers.oneformer import OneFormerDecoder

    device = resolve_device(device)
    pd, td = tree["pixel_decoder"], tree["transformer_decoder"]
    projections = tuple(p is not None for p in td["input_projections"])
    cfg = dataclasses.replace(
        cfg, encoder_layers=len(pd["encoder_layers"]),
        encoder_ffn_dim=np.shape(pd["encoder_layers"][0]["fc1"]["kernel"])[1],
        decoder_layers=len(td["decoder_layers"]) + 1,
        query_dec_layers=len(td["query_transformer_layers"]),
        dim_feedforward=np.shape(td["query_transformer_layers"][0]["fc1"]["kernel"])[1],
        num_queries=np.shape(td["queries_embedder"])[0],
        num_classes=np.shape(td["class_embed"]["kernel"])[1] - 1,
        task_seq_len=np.shape(tree["task_encoder"]["layers"][0]["kernel"])[0])
    with torch.device("meta"):
        model = OneFormerDecoder(cfg, input_projections=projections)
    return load_jax_tree(model, tree, device, dtype).requires_grad_(False).eval()


def genpipe_from_jax_params(
    tree: Dict[str, Any], cfg, device: Optional[Union[str, torch.device]] = None,
    dtype: Optional[torch.dtype] = None,
) -> nn.Module:
    """A frozen `GenPipe` of `cfg` holding a JAX `init_genpipe` /
    `import_genpipe` tree (the text encoder's stacked blocks unstacked)."""
    from visper_lm_tpu_torch.models.genpipe.pipeline import GenPipe

    device = resolve_device(device)
    with torch.device("meta"):
        pipe = GenPipe(cfg)
    sd: Dict[str, Any] = {}
    text = tree["text"]
    _flatten(sd, "text", {k: v for k, v in text.items() if k != "blocks"})
    _stacked(sd, "text.blocks", text["blocks"], cfg.text.num_layers)
    _flatten(sd, "", {k: v for k, v in tree.items() if k != "text"})
    _load(pipe, {k.lstrip("."): v for k, v in sd.items()}, device, dtype)
    return pipe.requires_grad_(False).eval()


def module_to_jax_tree(module: nn.Module, stacked: Sequence[str] = ()) -> Dict[str, Any]:
    """The JAX-layout tree of a module's parameters and buffers, the inverse
    of the loaders above: linear kernels (in, out), convs HWIO, transposed
    convs (kh, kw, in, out), embedding tables under "embedding", an
    `nn.Identity` as None, module-list indices as list positions, and the
    module lists named in `stacked` ("text.blocks", "stages.*.blocks")
    stacked into (L, ...) leaves. bf16 leaves are raw 2-byte values, as the
    JAX package's .npz files hold them."""
    import fnmatch

    root: Dict[str, Any] = {}

    def put(path, value):
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    for mname, m in module.named_modules():
        parts = mname.split(".") if mname else []
        if isinstance(m, nn.Identity):
            put(parts, None)
            continue
        leaves = list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False))
        for name, t in leaves:
            if t is None:
                continue
            a = to_numpy(t)
            if name == "weight" and isinstance(m, nn.Embedding):
                name = "embedding"
            elif name == "weight" and isinstance(m, nn.ConvTranspose2d):
                name, a = "kernel", a.transpose(2, 3, 0, 1)
            elif name == "weight" and isinstance(m, nn.Conv2d):
                name, a = "kernel", a.transpose(2, 3, 1, 0)
            elif name == "weight" and isinstance(m, nn.Linear):
                name, a = "kernel", a.T
            put(parts + [name], np.ascontiguousarray(a))

    def listify(node, path):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v, path + [k]) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            items = [out[str(i)] for i in range(len(out))]
            if any(fnmatch.fnmatch(".".join(path), pat) for pat in stacked):
                return _stack_trees(items)
            return items
        return out

    return listify(root, [])


def _stack_trees(items):
    if isinstance(items[0], dict):
        return {k: _stack_trees([it[k] for it in items]) for k in items[0]}
    return np.stack(items)
