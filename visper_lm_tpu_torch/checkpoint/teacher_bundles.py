"""Pack the visualisation decoders' weights into the demo's teachers-dir
bundles (counterpart of visper_lm_tpu/checkpoint/teacher_bundles.py).

The reference demo loads three teacher decoders from HF / torch checkpoints
at start-up; here the conversion runs once and the demo reads small
self-describing bundles (`demo.load_viz_decoders`):

    python -m visper_lm_tpu_torch.checkpoint.teacher_bundles \\
        --dav2 depth_anything_v2_vitl.pth \\
        --oneformer oneformer_coco_swin_large_dir \\
        --genpipe stable-diffusion-2-1-unclip_dir \\
        --out ckpts/teachers

It writes dav2_head.npz, oneformer.npz + oneformer.json and genpipe.npz +
genpipe.json in the JAX package's layout (`utils.param.save_tree_npz`), so a
bundle packed by either package loads in both. `.pth` files are read with
torch.load, safetensors with the port's own reader (checkpoint/hf_import.py).
`pack_modules` writes the same bundles from decoders already in memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import Any, Dict, Optional

import torch

from visper_lm_tpu_torch.checkpoint.hf_import import load_safetensors, load_sharded_safetensors
from visper_lm_tpu_torch.utils.param import save_tree_npz

SWIN_STACKED = ("stages.*.blocks",)
TEXT_STACKED = ("text.blocks",)


def pack_dav2(src: str, out_dir: str) -> str:
    """A DAv2 torch checkpoint (.pth with depth_head.*) or an OLA HF checkpoint
    directory (da_v2_head.depth_head.*) -> <out>/dav2_head.npz."""
    from visper_lm_tpu_torch.models.teachers.dpt import import_dpt_head

    if os.path.isdir(src):
        sd = load_sharded_safetensors(src)
        prefix = next((c for c in ("da_v2_head.depth_head.", "model.da_v2_head.depth_head.",
                                   "depth_head.") if any(k.startswith(c) for k in sd)), None)
        if prefix is None:
            raise ValueError(f"no DPT-head keys found in {src}")
    else:
        sd = torch.load(src, map_location="cpu", weights_only=True)
        prefix = "depth_head."
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "dav2_head.npz")
    save_tree_npz(path, import_dpt_head(sd, prefix=prefix))
    return path


def _write_oneformer(out_dir: str, dec_tree: Any, swin_tree: Any, dec_cfg, swin_cfg,
                     image_size: int) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "oneformer.npz")
    save_tree_npz(path, {"dec": dec_tree, "swin": swin_tree})
    with open(os.path.join(out_dir, "oneformer.json"), "w") as f:
        json.dump({"decoder": dataclasses.asdict(dec_cfg), "swin": dataclasses.asdict(swin_cfg),
                   "image_size": image_size}, f)
    return path


def pack_oneformer(src_dir: str, out_dir: str, image_size: int = 768) -> str:
    """An HF OneFormer checkpoint directory -> <out>/oneformer.npz +
    oneformer.json (the demo also reads HF directories as they are)."""
    from visper_lm_tpu_torch.models.teachers.oneformer import configs_from_hf, import_oneformer_decoder
    from visper_lm_tpu_torch.models.teachers.swin import SwinBackbone, import_swin_backbone
    from visper_lm_tpu_torch.weights import module_to_jax_tree

    with open(os.path.join(src_dir, "config.json")) as f:
        dec_cfg, swin_cfg = configs_from_hf(json.load(f))
    sd = load_sharded_safetensors(src_dir)
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
    with torch.device("meta"):
        swin = SwinBackbone(swin_cfg)
    swin.load_state_dict(import_swin_backbone(sd, swin_cfg, prefix="pixel_level_module.encoder."),
                         strict=True, assign=True)
    return _write_oneformer(out_dir, import_oneformer_decoder(sd, dec_cfg),
                            module_to_jax_tree(swin, stacked=SWIN_STACKED), dec_cfg, swin_cfg,
                            image_size)


def _component(src_dir: str, name: str) -> Dict[str, torch.Tensor]:
    """A diffusers component directory's tensors: model.safetensors (or its
    index), else the directory's *.safetensors files (diffusers names the
    UNet's and the VAE's diffusion_pytorch_model.safetensors)."""
    path = os.path.join(src_dir, name)
    try:
        return load_sharded_safetensors(path)
    except FileNotFoundError:
        files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        if not files:
            raise
        out: Dict[str, torch.Tensor] = {}
        for f in files:
            out.update(load_safetensors(f))
        return out


def _write_genpipe(out_dir: str, tree: Any, cfg, num_inference_steps: int) -> str:
    from visper_lm_tpu_torch.models.genpipe import genpipe_config_to_dict

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "genpipe.npz")
    save_tree_npz(path, tree)
    d = genpipe_config_to_dict(cfg)
    d["num_inference_steps"] = num_inference_steps
    with open(os.path.join(out_dir, "genpipe.json"), "w") as f:
        json.dump(d, f)
    return path


def pack_genpipe(src_dir: str, out_dir: str, cfg=None, num_inference_steps: int = 25) -> str:
    """A diffusers stable-diffusion-2-1-unclip checkout (unet/ vae/
    text_encoder/ image_normalizer/ with safetensors) -> <out>/genpipe.npz +
    genpipe.json."""
    from visper_lm_tpu_torch.models.genpipe import SD21_UNCLIP, import_genpipe

    cfg = cfg or SD21_UNCLIP
    tree = import_genpipe(
        cfg, unet_sd=_component(src_dir, "unet"), vae_sd=_component(src_dir, "vae"),
        text_sd=_component(src_dir, "text_encoder"),
        normalizer_sd=_component(src_dir, "image_normalizer"))
    return _write_genpipe(out_dir, tree, cfg, num_inference_steps)


def pack_modules(out_dir: str, *, dpt=None, oneformer: Optional[dict] = None,
                 genpipe: Optional[dict] = None) -> Dict[str, str]:
    """The same bundles from decoders in memory (`load_viz_decoders`' dict
    entries: a DPTHead; {"decoder", "cfg", "swin", "swin_cfg", "image_size"};
    {"pipe", "cfg", "num_inference_steps"}), each leaf in its dtype (bf16 as
    raw 2-byte values, as `utils.param.save_params_npz` writes it)."""
    from visper_lm_tpu_torch.weights import module_to_jax_tree as tree

    out = {}
    if dpt is not None:
        os.makedirs(out_dir, exist_ok=True)
        out["dpt"] = os.path.join(out_dir, "dav2_head.npz")
        save_tree_npz(out["dpt"], tree(dpt))
    if oneformer is not None:
        out["oneformer"] = _write_oneformer(
            out_dir, tree(oneformer["decoder"]), tree(oneformer["swin"], stacked=SWIN_STACKED),
            oneformer["cfg"], oneformer["swin_cfg"], oneformer.get("image_size", 768))
    if genpipe is not None:
        out["genpipe"] = _write_genpipe(out_dir, tree(genpipe["pipe"], stacked=TEXT_STACKED),
                                        genpipe["cfg"], genpipe.get("num_inference_steps", 25))
    return out



def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dav2", default=None, help=".pth or OLA checkpoint dir")
    p.add_argument("--oneformer", default=None, help="HF OneFormer dir")
    p.add_argument("--genpipe", default=None, help="diffusers sd-2-1-unclip dir")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.dav2:
        print("dav2:", pack_dav2(args.dav2, args.out))
    if args.oneformer:
        print("oneformer:", pack_oneformer(args.oneformer, args.out))
    if args.genpipe:
        print("genpipe:", pack_genpipe(args.genpipe, args.out))


if __name__ == "__main__":
    main()
