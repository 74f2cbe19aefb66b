"""The teachers' host side in the port (models/teachers `teacher_batch`, the
plain numpy pixel pipelines, the weight importers) against the JAX package's.

  * `teacher_batch` on uint8 arrays is BIT-EQUAL to JAX's
    `teacher_batch_from_pil` on PIL images of the same arrays with its native
    library built (the same C++ source and flags): depth at 336 (reversed
    statistics, BGR), gen at 224 (shortest edge, centre crop), seg at 768;
    grey and RGBA inputs are converted as PIL's convert("RGB") does; a thread
    pool gives the same bytes.
  * The plain numpy versions (`dav2_preprocess_np`, `unclip_preprocess_np`,
    `seg_preprocess_np`, PIL's fixed-point bicubic in numpy) EQUAL JAX's PIL
    versions; the native path is within test_teacher_preprocess_native.py's
    bound of them (mean |diff| < 0.02, max < 0.5).
  * `import_dav2_dinov2`, `import_swin_backbone(prefix=)` and `import_clip_h`
    on random state dicts in the reference layouts equal JAX's importers
    carried through `teachers_from_jax_params`: every tensor exact but the
    DINOv2 position grid, which JAX interpolates with jax.image.resize
    (atol 1e-6), and `load_teacher` puts them into the port's modules.
"""

import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.models import teachers as jteach
from visper_lm_tpu.models.teachers import dinov2 as jdinov2
from visper_lm_tpu.models.teachers import swin as jswin
from visper_lm_tpu.models.teachers import unclip as junclip
from visper_lm_tpu.data import mm_utils as jmm

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.models import teachers as tteach
from visper_lm_tpu_torch.models.teachers import dinov2 as tdinov2
from visper_lm_tpu_torch.models.teachers import swin as tswin
from visper_lm_tpu_torch.models.teachers import unclip as tunclip
from visper_lm_tpu_torch.weights import teachers_from_jax_params

torch.set_num_threads(2)

SHAPES = [(640, 480), (300, 500), (224, 224), (200, 900), (1024, 1024)]


def _jax_native_ready():
    from visper_lm_tpu import native as jn

    for _ in range(60):
        if jn.available():
            return
        jn._tried = False            # a concurrent `make` of the same library
        time.sleep(0.5)
    pytest.fail("the JAX package's native library did not build")


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SHAPES]


def test_teacher_batch_bit_equal_to_jax_native_path():
    _jax_native_ready()
    cfg_j, cfg_t = jconfig.phi3_clip_vlm(distill=True), tconfig.phi3_clip_vlm(distill=True)
    arrays = _arrays()
    grey = arrays[1][..., 0]
    rgba = np.concatenate([arrays[3], arrays[3][..., :1]], axis=-1)
    pils = [Image.fromarray(a) for a in arrays] + [Image.fromarray(grey), Image.fromarray(rgba)]
    ref = jteach.teacher_batch_from_pil(cfg_j, pils)
    got = tteach.teacher_batch(cfg_t, arrays + [grey, rgba])
    assert sorted(got) == sorted(ref) == ["depth_images", "gen_images", "seg_images"]
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32 and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    pooled = tteach.teacher_batch(cfg_t, arrays + [grey, rgba], workers=3)
    for k in ref:
        np.testing.assert_array_equal(pooled[k], got[k], err_msg=k)


def test_teacher_batch_follows_the_tasks():
    cfg = tconfig.phi3_clip_vlm(distill=True)
    d = tconfig.make_distill_config(mode="depth-seg", layer_indices="d18-20_s10-18")
    import dataclasses

    out = tteach.teacher_batch(dataclasses.replace(cfg, distill=d), _arrays()[:2])
    assert sorted(out) == ["depth_images", "seg_images"]
    assert out["seg_images"].shape == (2, 768, 768, 3)


def test_plain_versions_equal_jax_and_bound_the_native_path():
    arrays = _arrays(seed=1)[:3]
    cfg = tconfig.phi3_clip_vlm(distill=True)
    fast = tteach.teacher_batch(cfg, arrays)
    plain = {
        "depth_images": np.stack([tdinov2.dav2_preprocess_np(a) for a in arrays]),
        "gen_images": np.stack([tunclip.unclip_preprocess_np(a) for a in arrays]),
        "seg_images": np.stack([tswin.seg_preprocess_np(a) for a in arrays]),
    }
    pils = [Image.fromarray(a) for a in arrays]
    ref = {
        "depth_images": np.stack([jdinov2.dav2_preprocess_np(p) for p in pils]),
        "gen_images": np.stack([junclip.unclip_preprocess_np(p) for p in pils]),
        "seg_images": np.stack([jmm.normalize_image(p.resize((768, 768)), jmm.IMAGENET_MEAN,
                                                    jmm.IMAGENET_STD) for p in pils]),
    }
    for k in ref:
        np.testing.assert_array_equal(plain[k], ref[k], err_msg=k)
        diff = np.abs(fast[k] - plain[k])
        assert float(diff.mean()) < 0.02, (k, diff.mean())
        assert float(diff.max()) < 0.5, (k, diff.max())


# ---------------------------------------------------------------------------
# importers
# ---------------------------------------------------------------------------

TINY = dict(
    dinov2=dict(image_size=28, patch_size=14, hidden_size=24, num_layers=2, num_heads=2,
                mlp_dim=48, norm_eps=1e-6, hidden_act="gelu", use_pre_norm=False, dtype="float32"),
    clip_h=dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=2,
                mlp_dim=64, hidden_act="gelu", dtype="float32"),
    swin=dict(embed_dim=4, depths=(1, 2, 1, 1), num_heads=(1, 2, 2, 4), window_size=2),
)
GEN_DIM = 24


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _dav2_sd(rng, c):
    d, p = c["hidden_size"], "pretrained."
    sd = {p + "patch_embed.proj.weight": _rand(rng, d, 3, 14, 14), p + "patch_embed.proj.bias": _rand(rng, d),
          p + "pos_embed": _rand(rng, 1, 1 + 3 * 3, d), p + "cls_token": _rand(rng, 1, 1, d),
          p + "norm.weight": _rand(rng, d), p + "norm.bias": _rand(rng, d),
          "depth_head.scratch.weight": _rand(rng, 3)}           # the DPT head: not read
    for i in range(c["num_layers"]):
        b = f"{p}blocks.{i}."
        for name, shape in (("norm1", (d,)), ("norm2", (d,))):
            sd[b + name + ".weight"], sd[b + name + ".bias"] = _rand(rng, *shape), _rand(rng, *shape)
        for name, (o, n) in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                             ("mlp.fc1", (c["mlp_dim"], d)), ("mlp.fc2", (d, c["mlp_dim"]))):
            sd[b + name + ".weight"], sd[b + name + ".bias"] = _rand(rng, o, n), _rand(rng, o)
        sd[b + "ls1.gamma"], sd[b + "ls2.gamma"] = _rand(rng, d), _rand(rng, d)
    return sd


def _clip_h_sd(rng, c):
    d, p = c["hidden_size"], "vision_model."
    n = (c["image_size"] // c["patch_size"]) ** 2 + 1
    sd = {p + "embeddings.patch_embedding.weight": _rand(rng, d, 3, 14, 14),
          p + "embeddings.class_embedding": _rand(rng, d),
          p + "embeddings.position_embedding.weight": _rand(rng, n, d),
          "visual_projection.weight": _rand(rng, GEN_DIM, d)}
    for ln in ("pre_layrnorm", "post_layernorm"):
        sd[f"{p}{ln}.weight"], sd[f"{p}{ln}.bias"] = _rand(rng, d), _rand(rng, d)
    for i in range(c["num_layers"]):
        b = f"{p}encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{b}{ln}.weight"], sd[f"{b}{ln}.bias"] = _rand(rng, d), _rand(rng, d)
        for name, (o, m) in (("self_attn.q_proj", (d, d)), ("self_attn.k_proj", (d, d)),
                             ("self_attn.v_proj", (d, d)), ("self_attn.out_proj", (d, d)),
                             ("mlp.fc1", (c["mlp_dim"], d)), ("mlp.fc2", (d, c["mlp_dim"]))):
            sd[b + name + ".weight"], sd[b + name + ".bias"] = _rand(rng, o, m), _rand(rng, o)
    return sd


def _swin_sd(rng, c, prefix):
    e, ws = c["embed_dim"], c["window_size"]
    sd = {prefix + "embeddings.patch_embeddings.projection.weight": _rand(rng, e, 3, 4, 4),
          prefix + "embeddings.patch_embeddings.projection.bias": _rand(rng, e),
          prefix + "embeddings.norm.weight": _rand(rng, e), prefix + "embeddings.norm.bias": _rand(rng, e)}
    for s, (depth, heads) in enumerate(zip(c["depths"], c["num_heads"])):
        dim = e * 2 ** s
        sp = f"{prefix}encoder.layers.{s}."
        for i in range(depth):
            b = f"{sp}blocks.{i}."
            for ln in ("layernorm_before", "layernorm_after"):
                sd[f"{b}{ln}.weight"], sd[f"{b}{ln}.bias"] = _rand(rng, dim), _rand(rng, dim)
            for name, (o, m) in (("attention.self.query", (dim, dim)), ("attention.self.key", (dim, dim)),
                                 ("attention.self.value", (dim, dim)), ("attention.output.dense", (dim, dim)),
                                 ("intermediate.dense", (4 * dim, dim)), ("output.dense", (dim, 4 * dim))):
                sd[b + name + ".weight"], sd[b + name + ".bias"] = _rand(rng, o, m), _rand(rng, o)
            sd[b + "attention.self.relative_position_bias_table"] = _rand(rng, (2 * ws - 1) ** 2, heads)
        if s < len(c["depths"]) - 1:
            sd[sp + "downsample.norm.weight"], sd[sp + "downsample.norm.bias"] = (
                _rand(rng, 4 * dim), _rand(rng, 4 * dim))
            sd[sp + "downsample.reduction.weight"] = _rand(rng, 2 * dim, 4 * dim)
        sd[f"{prefix}hidden_states_norms.stage{s + 1}.weight"] = _rand(rng, dim)
        sd[f"{prefix}hidden_states_norms.stage{s + 1}.bias"] = _rand(rng, dim)
    return sd


def test_importers_equal_jax_and_load_into_the_teachers():
    rng = np.random.default_rng(0)
    prefix = "pixel_level_module.encoder."
    sds = dict(dinov2=_dav2_sd(rng, TINY["dinov2"]), clip_h=_clip_h_sd(rng, TINY["clip_h"]),
               swin=_swin_sd(rng, TINY["swin"], prefix))
    jt = dict(dinov2=jconfig.VisionConfig(**TINY["dinov2"]), clip_h=jconfig.VisionConfig(**TINY["clip_h"]),
              swin=jswin.SwinConfig(**TINY["swin"]))
    jtree = {
        "dinov2": jdinov2.import_dav2_dinov2(sds["dinov2"], jt["dinov2"]),
        "clip_h": junclip.import_clip_h(sds["clip_h"], jt["clip_h"]),
        "swin": jswin.import_swin_backbone(sds["swin"], jt["swin"], prefix=prefix),
    }
    tcfgs = tteach.TeacherConfigs(
        dinov2=tconfig.VisionConfig(**TINY["dinov2"]), clip_h=tconfig.VisionConfig(**TINY["clip_h"]),
        swin=tswin.SwinConfig(**TINY["swin"]), gen_embed_dim=GEN_DIM)
    cfg = tconfig.tiny_test_vlm(distill=True)
    ref = teachers_from_jax_params(jax.tree_util.tree_map(np.asarray, jtree), cfg, tcfgs,
                                   device="cpu", dtype=torch.float32)
    ported = {
        "dinov2": tdinov2.import_dav2_dinov2(sds["dinov2"], tcfgs.dinov2),
        "clip_h": tunclip.import_clip_h(sds["clip_h"], tcfgs.clip_h),
        "swin": tswin.import_swin_backbone(sds["swin"], tcfgs.swin, prefix=prefix),
    }
    teachers = tteach.init_teachers(cfg, tcfgs, device="cpu", dtype=torch.float32)
    for name, sd in ported.items():
        want = ref[name].state_dict()
        assert sorted(sd) == sorted(want), name
        for k, v in sd.items():
            if name == "dinov2" and k == "pos_embed":
                np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=f"{name}.{k}")
        tteach.load_teacher(teachers, name, sd)
        for k, v in teachers[name].state_dict().items():
            np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=f"{name}.{k}")
    # torch tensors in, as torch.load gives them
    from_torch = tdinov2.import_dav2_dinov2({k: torch.from_numpy(v) for k, v in sds["dinov2"].items()},
                                           tcfgs.dinov2)
    for k, v in from_torch.items():
        assert torch.equal(v, ported["dinov2"][k]), k
