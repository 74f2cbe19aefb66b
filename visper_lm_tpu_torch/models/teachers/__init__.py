"""The frozen teacher stack and its target function (counterpart of
visper_lm_tpu/models/teachers/__init__.py).

`init_teachers` builds the three teachers of the PT step (DINOv2-L for depth,
CLIP-H for generation, Swin-L for segmentation) with seeded random weights,
frozen; `make_teacher_fn` returns the function the train step calls for the
distillation targets, under torch.no_grad(), micro-batched as a Python loop.
The DPT depth decoder (JAX `teachers["dpt"]`) is not on the target path and
belongs to a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.nn as nn

from visper_lm_tpu_torch.config import CLIP_VIT_H_224, DINOV2_VIT_L, VLMConfig
from visper_lm_tpu_torch.device import resolve_device
from visper_lm_tpu_torch.models.teachers import dinov2 as dinov2_lib
from visper_lm_tpu_torch.models.teachers import swin as swin_lib
from visper_lm_tpu_torch.models.teachers import unclip as unclip_lib
from visper_lm_tpu_torch.models.vit import init_tower_

IMAGE_KEYS = {"depth": "depth_images", "gen": "gen_images", "seg": "seg_images"}


class TeacherConfigs:
    """Teacher architecture configs (defaults: the reference teacher zoo).
    gen_embed_dim is CLIP-H's projection width (the gen target's width)."""

    def __init__(self, dinov2=None, clip_h=None, swin=None, gen_embed_dim: int = unclip_lib.GEN_EMBED_DIM):
        self.dinov2 = dinov2 or DINOV2_VIT_L
        self.clip_h = clip_h or CLIP_VIT_H_224
        self.swin = swin or swin_lib.SWIN_L
        self.gen_embed_dim = gen_embed_dim


def build_teachers(
    cfg: VLMConfig, tcfgs: Optional[TeacherConfigs] = None, *, device=None,
    dtype: torch.dtype = torch.bfloat16,
) -> nn.ModuleDict:
    """The teacher modules the config's tasks need (weights not set)."""
    tcfgs = tcfgs or TeacherConfigs()
    tasks = {t.task for t in cfg.distill.tasks}
    kw = dict(device=device, dtype=dtype)
    teachers = nn.ModuleDict()
    if "depth" in tasks:
        teachers["dinov2"] = dinov2_lib.init_dinov2(tcfgs.dinov2, **kw)
    if "gen" in tasks:
        teachers["clip_h"] = unclip_lib.init_clip_h(tcfgs.clip_h, tcfgs.gen_embed_dim, **kw)
    if "seg" in tasks:
        teachers["swin"] = swin_lib.SwinBackbone(tcfgs.swin, **kw)
    return teachers


def init_teachers(
    cfg: VLMConfig,
    tcfgs: Optional[TeacherConfigs] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 7,
) -> nn.ModuleDict:
    """Seeded random teachers (real use imports pretrained weights) on
    `device` (CUDA when None), frozen and in eval mode."""
    device = resolve_device(device)
    with torch.device("meta"):
        teachers = build_teachers(cfg, tcfgs, dtype=dtype)
    teachers = teachers.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, module in teachers.items():
        if name == "swin":
            swin_lib.init_swin_(module, gen)
        else:
            init_tower_(module, gen)
    return teachers.requires_grad_(False).eval()


def make_teacher_fn(
    cfg: VLMConfig,
    tcfgs: Optional[TeacherConfigs] = None,
    microbatch: Optional[int] = 2,
    use_kernel: Optional[bool] = None,
) -> Callable[[nn.ModuleDict, Dict[str, Any]], Dict[str, torch.Tensor]]:
    """teacher_fn(teachers, batch) -> {task: detached f32 target}.

    batch keys: depth_images (B,336,336,3), gen_images (B,224,224,3),
    seg_images (B,768,768,3). The pixels are cast to the teachers' parameter
    dtype. microbatch bounds the teachers' activation memory: the batch runs
    in chunks of that many images (None/0, or a batch it does not divide,
    runs whole)."""
    tasks = {t.task for t in cfg.distill.tasks}

    def compute(teachers: nn.ModuleDict, imgs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        targets: Dict[str, torch.Tensor] = {}
        if "depth_images" in imgs:
            targets["depth"] = dinov2_lib.dav2_depth_target(teachers["dinov2"], imgs["depth_images"])
        if "gen_images" in imgs:
            targets["gen"] = unclip_lib.gen_target(teachers["clip_h"], imgs["gen_images"])
        if "seg_images" in imgs:
            targets["seg"] = swin_lib.seg_target(
                teachers["swin"], imgs["seg_images"], use_kernel=use_kernel
            )
        return targets

    @torch.no_grad()
    def teacher_fn(teachers: nn.ModuleDict, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        wanted = [IMAGE_KEYS[t] for t in sorted(tasks) if IMAGE_KEYS[t] in batch]
        if not wanted:
            return {}
        param = next(teachers.parameters())
        imgs = {
            k: torch.as_tensor(batch[k]).to(device=param.device, dtype=param.dtype)
            for k in wanted
        }
        b = next(iter(imgs.values())).shape[0]
        mb = microbatch or 0
        if mb <= 0 or mb >= b or b % mb:
            return {k: v.detach() for k, v in compute(teachers, imgs).items()}
        chunks = [
            compute(teachers, {k: v[i:i + mb] for k, v in imgs.items()})
            for i in range(0, b, mb)
        ]
        return {k: torch.cat([c[k] for c in chunks]).detach() for k in chunks[0]}

    return teacher_fn
