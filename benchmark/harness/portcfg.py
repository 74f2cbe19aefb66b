"""The program's configuration objects for a configuration file, and the
checks that tie the program to the file: the preset the file names must
describe the same model, and the program's parameters must have the
reference's names, shapes and dtypes."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


def _vision(v) -> dict:
    return {k: getattr(v, k) for k in ("image_size", "patch_size", "hidden_size", "num_layers",
                                       "num_heads", "mlp_dim", "norm_eps", "hidden_act",
                                       "select_layer", "select_feature", "use_pre_norm",
                                       "use_class_token")}


def describe(cfg, tcfgs=None) -> dict:
    """A program VLMConfig (and teacher configs) in the files' `model` form."""
    d = cfg.decoder
    out = {
        "decoder": {k: getattr(d, k) for k in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                                               "num_kv_heads", "head_dim", "mlp_dim", "rope_theta",
                                               "norm_eps", "tie_embeddings")},
        "projector": {"input_dim": cfg.projector.input_dim, "output_dim": cfg.projector.output_dim,
                      "mlp_depth": cfg.projector.mlp_depth},
        "num_sys_tokens": cfg.num_sys_tokens,
        "num_image_tokens": cfg.num_image_tokens,
    }
    if cfg.use_convnext_tower:
        c = cfg.convnext
        out["tower"] = {"kind": "convnext", "image_size": c.image_size, "depths": list(c.depths),
                        "dims": list(c.dims), "norm_eps": c.norm_eps}
    else:
        out["tower"] = {"kind": "clip", **_vision(cfg.vision)}
    if cfg.distill is not None:
        dd = cfg.distill
        out["distill"] = {
            "mode": dd.mode, "num_task_tokens": dd.num_task_tokens,
            "contrastive_loss_weight": dd.contrastive_loss_weight,
            "use_contrastive": dd.use_contrastive, "pass_text_to_aux": dd.pass_text_to_aux,
            "tasks": [{"task": t.task, "layer_indices": list(t.layer_indices),
                       "loss_weight": t.loss_weight, "target_dim": t.target_dim,
                       "target_tokens": t.target_tokens, "head": dataclasses.asdict(t.head)}
                      for t in dd.tasks]}
    if tcfgs is not None:
        from visper_lm_tpu_torch.models.teachers.dinov2 import DAV2_INTERMEDIATE_LAYERS

        dino = _vision(tcfgs.dinov2)
        n = tcfgs.dinov2.num_layers
        dino["layers"] = (list(DAV2_INTERMEDIATE_LAYERS) if n >= 24 else
                          sorted({round((i + 1) * n / min(4, n)) - 1 for i in range(min(4, n))}))
        clip_h = _vision(tcfgs.clip_h)
        clip_h["projection_dim"] = tcfgs.gen_embed_dim
        sw = dataclasses.asdict(tcfgs.swin)
        sw.pop("dtype")
        sw["depths"], sw["num_heads"] = list(sw["depths"]), list(sw["num_heads"])
        out["teachers"] = {"dinov2": dino, "clip_h": clip_h, "swin": sw}
    return out


def build(config: dict, with_teachers: bool):
    """(VLMConfig, TeacherConfigs or None) from the file's `preset`: a
    function of visper_lm_tpu_torch.config with its keywords, optionally
    passed through a wrapper of it (`with_convnext_tower`)."""
    from visper_lm_tpu_torch import config as pc
    from visper_lm_tpu_torch.models.teachers import TeacherConfigs

    p = config["preset"]
    cfg = getattr(pc, p["function"])(**p.get("kwargs", {}))
    for w in p.get("wrappers", []):
        cfg = getattr(pc, w)(cfg)
    tcfgs = None
    if with_teachers:
        tcfgs = TeacherConfigs() if "teachers" not in p else _tiny_teachers(p["teachers"])
    got = describe(cfg, tcfgs)
    want = {k: v for k, v in config["model"].items() if k in got}
    if "teachers" in want:
        want["teachers"] = dict(want["teachers"])
        want["teachers"]["swin"] = {k: v for k, v in want["teachers"]["swin"].items()
                                    if k != "image_size"}
    if not with_teachers:
        got.pop("teachers", None)
    if _norm(got) != _norm(want):
        diff = [k for k in want if _norm(got.get(k)) != _norm(want[k])]
        raise SystemExit(f"benchmark: the preset does not describe the file's model ({diff})")
    return cfg, tcfgs


def _tiny_teachers(t: dict):
    from visper_lm_tpu_torch.config import VisionConfig
    from visper_lm_tpu_torch.models.teachers import TeacherConfigs
    from visper_lm_tpu_torch.models.teachers.swin import SwinConfig

    return TeacherConfigs(dinov2=VisionConfig(**t["dinov2"]), clip_h=VisionConfig(**t["clip_h"]),
                          swin=SwinConfig(**{k: tuple(v) if isinstance(v, list) else v
                                             for k, v in t["swin"].items()}),
                          gen_embed_dim=t["gen_embed_dim"])


def _norm(x):
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, float) and x.is_integer():
        return int(x)
    return x


def dtype_rules(config: dict) -> Dict[str, torch.dtype]:
    return {k: getattr(torch, v) for k, v in config["dtypes"].items()}


def check_params(named, shapes: Dict[str, Tuple[int, ...]], rules: Dict[str, torch.dtype],
                 what: str, exact: bool = True) -> None:
    """The program's parameters against the reference's layout: every
    reference name present with its shape and the file's dtype (and, with
    exact, nothing else)."""
    named = dict(named)
    missing = sorted(set(shapes) - set(named))
    extra = sorted(set(named) - set(shapes)) if exact else []
    bad = [n for n in shapes if n in named and tuple(named[n].shape) != tuple(shapes[n])]
    from benchmark.reference.weights import Weights

    probe = Weights(shapes, 0, what, "cpu", rules)
    wrong = [n for n in shapes if n in named and named[n].dtype != probe.dtype_of(n)]
    if missing or extra or bad or wrong:
        raise SystemExit(f"benchmark: {what} parameters differ from the reference's layout: "
                         f"missing {missing[:5]}, extra {extra[:5]}, shapes {bad[:5]}, "
                         f"dtypes {wrong[:5]}")
