"""Parameter names and shapes of the benchmark's models, from a configuration
file's `model` section alone: the layout the reference reads its weights in
(and which the benchmark checks the program's parameters against)."""

from __future__ import annotations

from typing import Dict, Tuple

Shapes = Dict[str, Tuple[int, ...]]


def _ln(out: Shapes, name: str, dim: int) -> None:
    out[f"{name}.scale"] = (dim,)
    out[f"{name}.bias"] = (dim,)


def _lin(out: Shapes, name: str, din: int, dout: int, bias: bool = True) -> None:
    out[f"{name}.weight"] = (dout, din)
    if bias:
        out[f"{name}.bias"] = (dout,)


def decoder(d: dict) -> Shapes:
    h, hd, m = d["hidden_size"], d["head_dim"], d["mlp_dim"]
    out: Shapes = {"decoder.embed_tokens.weight": (d["vocab_size"], h),
                   "decoder.final_norm.scale": (h,)}
    if not d.get("tie_embeddings", False):
        out["decoder.lm_head.weight"] = (d["vocab_size"], h)
    for i in range(d["num_layers"]):
        p = f"decoder.blocks.{i}."
        out[p + "attn_norm.scale"] = (h,)
        out[p + "mlp_norm.scale"] = (h,)
        _lin(out, p + "q_proj", h, d["num_heads"] * hd, False)
        _lin(out, p + "k_proj", h, d["num_kv_heads"] * hd, False)
        _lin(out, p + "v_proj", h, d["num_kv_heads"] * hd, False)
        _lin(out, p + "o_proj", d["num_heads"] * hd, h, False)
        _lin(out, p + "gate_proj", h, m, False)
        _lin(out, p + "up_proj", h, m, False)
        _lin(out, p + "down_proj", m, h, False)
    return out


def vit(v: dict, prefix: str, layerscale: bool = False, projection_dim: int = 0) -> Shapes:
    h, ps = v["hidden_size"], v["patch_size"]
    n = (v["image_size"] // ps) ** 2 + int(v.get("use_class_token", True))
    out: Shapes = {}
    _lin(out, prefix + "patch_embed", 3 * ps * ps, h)
    out[prefix + "pos_embed"] = (n, h)
    if v.get("use_class_token", True):
        out[prefix + "cls_token"] = (h,)
    if v.get("use_pre_norm", True):
        _ln(out, prefix + "pre_norm", h)
    for i in range(v["num_layers"]):
        p = f"{prefix}blocks.{i}."
        _ln(out, p + "norm1", h)
        _ln(out, p + "norm2", h)
        _lin(out, p + "qkv", h, 3 * h)
        _lin(out, p + "proj", h, h)
        _lin(out, p + "fc1", h, v["mlp_dim"])
        _lin(out, p + "fc2", v["mlp_dim"], h)
        if layerscale:
            out[p + "ls1.gamma"] = (h,)
            out[p + "ls2.gamma"] = (h,)
    _ln(out, prefix + "final_norm", h)
    if projection_dim:
        _lin(out, prefix + "visual_projection", h, projection_dim, False)
    return out


def convnext(c: dict, prefix: str) -> Shapes:
    dims, out = c["dims"], {}
    out[prefix + "stem_conv.weight"] = (dims[0], 3, 4, 4)
    out[prefix + "stem_conv.bias"] = (dims[0],)
    _ln(out, prefix + "stem_norm", dims[0])
    for s, (depth, d) in enumerate(zip(c["depths"], dims)):
        sp = f"{prefix}stages.{s}."
        if s:
            _ln(out, sp + "downsample.norm", dims[s - 1])
            out[sp + "downsample.conv.weight"] = (d, dims[s - 1], 2, 2)
            out[sp + "downsample.conv.bias"] = (d,)
        for i in range(depth):
            p = f"{sp}blocks.{i}."
            out[p + "dwconv.weight"] = (d, 1, 7, 7)
            out[p + "dwconv.bias"] = (d,)
            _ln(out, p + "norm", d)
            _lin(out, p + "fc1", d, 4 * d)
            _lin(out, p + "fc2", 4 * d, d)
            out[p + "gamma"] = (d,)
    _ln(out, prefix + "norm_pre", dims[-1])
    return out


def swin(s: dict, prefix: str) -> Shapes:
    ws, out = s["window_size"], {}
    e, ps = s["embed_dim"], s["patch_size"]
    out[prefix + "patch_embed.weight"] = (e, 3, ps, ps)
    out[prefix + "patch_embed.bias"] = (e,)
    _ln(out, prefix + "patch_norm", e)
    for st, (depth, heads) in enumerate(zip(s["depths"], s["num_heads"])):
        dim = e * 2 ** st
        hidden = int(dim * s["mlp_ratio"])
        for i in range(depth):
            p = f"{prefix}stages.{st}.blocks.{i}."
            _ln(out, p + "norm1", dim)
            _ln(out, p + "norm2", dim)
            _lin(out, p + "qkv", dim, 3 * dim)
            _lin(out, p + "proj", dim, dim)
            out[p + "rel_bias"] = ((2 * ws - 1) ** 2, heads)
            _lin(out, p + "fc1", dim, hidden)
            _lin(out, p + "fc2", hidden, dim)
        if st < len(s["depths"]) - 1:
            _ln(out, f"{prefix}stages.{st}.downsample.norm", 4 * dim)
            _lin(out, f"{prefix}stages.{st}.downsample.reduction", 4 * dim, 2 * dim, False)
        _ln(out, f"{prefix}out_norms.{st}", dim)
    return out


def head_dims(m: dict, task: dict) -> Tuple[int, int]:
    """(inner width, output width) of a task's resampler: the depth head runs
    at the LLM's width in task-token mode."""
    h = m["decoder"]["hidden_size"]
    out_dim = task["head"]["output_dim"]
    inner = h if (task["task"] == "depth" and m["distill"]["num_task_tokens"] > 0) else out_dim
    return inner, out_dim


def vlm(m: dict) -> Shapes:
    """The VLM: decoder, tower, projector, task tokens, heads, logit scales."""
    out = decoder(m["decoder"])
    t = m["tower"]
    if t["kind"] == "convnext":
        out.update(convnext(t, "vision_tower."))
    else:
        out.update(vit(t, "vision_tower."))
    p = m["projector"]
    _lin(out, "mm_projector.layers.0", p["input_dim"], p["output_dim"])
    for i in range(1, p["mlp_depth"]):
        _lin(out, f"mm_projector.layers.{i}", p["output_dim"], p["output_dim"])
    d = m.get("distill")
    if d:
        h = m["decoder"]["hidden_size"]
        for task in d["tasks"]:
            name = task["task"]
            if d["num_task_tokens"] > 0:
                rows = d["num_task_tokens"] if name == "gen" else task["head"]["num_tokens"]
                out[f"special_tokens.{name}"] = (rows, h)
            if d["use_contrastive"]:
                out[f"logit_scales.{name}"] = ()
            inner, od = head_dims(m, task)
            hd = task["head"]
            for j in range(len(task["layer_indices"])):
                p = f"heads.{name}.{j}."
                _lin(out, p + "resampler.proj_in", h, inner)
                _lin(out, p + "resampler.proj_out", inner, od)
                _ln(out, p + "resampler.norm_out", od)
                if d["num_task_tokens"] == 0:
                    out[p + "resampler.latents"] = (hd["num_tokens"], inner)
                ai = hd["dim_head"] * hd["num_heads"]
                for k in range(hd["depth"]):
                    lp = f"{p}resampler.layers.{k}."
                    _ln(out, lp + "attn.norm1", inner)
                    _ln(out, lp + "attn.norm2", inner)
                    _lin(out, lp + "attn.to_q", inner, ai, False)
                    _lin(out, lp + "attn.to_kv", inner, 2 * ai, False)
                    _lin(out, lp + "attn.to_out", ai, inner, False)
                    _ln(out, lp + "ff.norm", inner)
                    _lin(out, lp + "ff.fc1", inner, inner * hd["ff_mult"], False)
                    _lin(out, lp + "ff.fc2", inner * hd["ff_mult"], inner, False)
                if name == "depth":
                    for k in range(3):
                        _lin(out, f"{p}intermediate.{k}.fc1", od, od)
                        _lin(out, f"{p}intermediate.{k}.fc2", od, od)
    return out


def teachers(m: dict) -> Shapes:
    """The frozen teachers the distillation tasks read (the depth teacher's
    DPT decoder renders pictures only and is not part of the targets)."""
    t, out = m["teachers"], {}
    tasks = {task["task"] for task in m["distill"]["tasks"]}
    if "depth" in tasks:
        out.update(vit(t["dinov2"], "dinov2.", layerscale=True))
    if "gen" in tasks:
        out.update(vit(t["clip_h"], "clip_h.", projection_dim=t["clip_h"]["projection_dim"]))
    if "seg" in tasks:
        out.update(swin(t["swin"], "swin."))
    return out
