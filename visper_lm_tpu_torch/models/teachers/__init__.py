"""The frozen teacher stack and its target function (counterpart of
visper_lm_tpu/models/teachers/__init__.py).

`init_teachers` builds the three teachers of the PT step (DINOv2-L for depth,
CLIP-H for generation, Swin-L for segmentation) and, with the depth task,
the DPT decoder that renders depth predictions (`dpt`, at DINOv2's width;
not on the target path), with seeded random weights, frozen; `load_teacher`
puts imported weights into one of them;
`make_teacher_fn` returns the function the train step calls for the
distillation targets, under torch.no_grad(), micro-batched as a Python loop.
`teacher_batch` is the host side: each teacher's pixels from uint8 images,
through the native resize (native/).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from visper_lm_tpu_torch.config import CLIP_VIT_H_224, DINOV2_VIT_L, VLMConfig
from visper_lm_tpu_torch.device import resolve_device
from visper_lm_tpu_torch.models.teachers import dinov2 as dinov2_lib
from visper_lm_tpu_torch.models.teachers import dpt as dpt_lib
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
        teachers["dpt"] = dpt_lib.DPTHead(tcfgs.dinov2.hidden_size, **kw)
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
        elif name == "dpt":
            dpt_lib.init_dpt_(module, gen)
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


def load_teacher(teachers: nn.ModuleDict, name: str, sd: Mapping[str, torch.Tensor]) -> None:
    """Copy an importer's state dict (`import_dav2_dinov2`, `import_clip_h`,
    `import_swin_backbone`) into teacher `name`, strictly, in its device and
    dtype."""
    module = teachers[name]
    p = next(module.parameters())
    module.load_state_dict(
        {k: v.to(device=p.device, dtype=p.dtype) for k, v in sd.items()}, strict=True)


def teacher_batch(
    cfg: VLMConfig, images: Sequence[np.ndarray], workers: int = 0
) -> Dict[str, np.ndarray]:
    """Each teacher's f32 pixels for a batch of uint8 (H, W, 3) images, through
    the native fused resize + normalize (JAX `teacher_batch_from_pil` with its
    library built; there is no other path):

      * depth_images (B, 336, 336, 3): bicubic to 336, ImageNet normalize,
        BGR (the normalize with reversed statistics, then the channel flip);
      * gen_images (B, 224, 224, 3): shortest edge to 224, centre crop, CLIP
        normalize;
      * seg_images (B, 768, 768, 3): bicubic to 768, ImageNet normalize,
        written straight into the batch slab.

    workers > 1 runs the images on a thread pool (the library releases the
    GIL). The plain numpy versions it is held against are
    `dinov2.dav2_preprocess_np`, `unclip.unclip_preprocess_np` and
    `swin.seg_preprocess_np` (PIL's fixed-point resize)."""
    from visper_lm_tpu_torch import native
    from visper_lm_tpu_torch.data.mm_utils import (
        CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, IMAGENET_MEAN, IMAGENET_STD, to_rgb_array,
    )

    tasks = {t.task for t in cfg.distill.tasks}
    arrays = [to_rgb_array(im) for im in images]

    def depth(arr: np.ndarray) -> np.ndarray:
        out = native.resize_normalize(arr, 336, IMAGENET_MEAN[::-1], IMAGENET_STD[::-1],
                                      native.BICUBIC)
        return out[..., ::-1]

    def gen(arr: np.ndarray) -> np.ndarray:
        # CLIPImageProcessor at 224: shortest edge, centre crop (the crop
        # commutes with the fused normalize)
        h, w = arr.shape[:2]
        size = 224
        if min(w, h) == size:
            nw, nh = w, h
        elif w <= h:
            nw, nh = size, int(size * h / w)
        else:
            nw, nh = int(size * w / h), size
        out = native.resize_normalize(arr, (nh, nw), CLIP_IMAGE_MEAN, CLIP_IMAGE_STD,
                                      native.BICUBIC)
        top, left = (nh - size) // 2, (nw - size) // 2
        return out[top:top + size, left:left + size]

    def run(fn, items):
        if workers > 1 and len(items) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(workers, len(items))) as pool:
                return list(pool.map(fn, items))
        return [fn(x) for x in items]

    out: Dict[str, np.ndarray] = {}
    if "depth" in tasks:
        out["depth_images"] = np.stack(run(depth, arrays))
    if "gen" in tasks:
        out["gen_images"] = np.stack(run(gen, arrays))
    if "seg" in tasks:
        slab = np.empty((len(arrays), 768, 768, 3), np.float32)
        run(lambda i: native.resize_normalize(arrays[i], 768, IMAGENET_MEAN, IMAGENET_STD,
                                              native.BICUBIC, out=slab[i]),
            list(range(len(arrays))))
        out["seg_images"] = slab
    return out
