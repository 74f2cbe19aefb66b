"""Interactive demo: streamed chat and the visualisation of the LLM's
intermediate representations (counterpart of visper_lm_tpu/demo.py).

Two capabilities, as in the reference Gradio demo: a streamed chat over an
image, and "visualize", which decodes the distillation heads' predictions at
the tapped layers through the teachers' decoders into PNGs:

  * depth: the predicted embedding -> the depth head's intermediate-feature
    pyramid (or [emb] * 4) -> the frozen DPT decoder -> a colour-mapped PNG;
  * seg: the predicted embedding substituted for the OneFormer backbone's
    last feature -> mask decoding -> a semantic-map PNG;
  * gen: the predicted CLIP image embedding -> the unCLIP pipeline -> a PNG.

Every embedding is also dumped as .npy. `load_viz_decoders` finds the
decoders: the DPT head in the model checkpoint (da_v2_head.depth_head.*) or
<teachers>/dav2_head.npz; OneFormer as an HF directory <teachers>/oneformer/
or <teachers>/oneformer.npz + .json; the pipeline as <teachers>/genpipe.npz +
.json (checkpoint/teacher_bundles.py packs them). A missing decoder leaves
its task to the .npy dumps, with a notice. The decoders run on the model's
device: DPT and the OneFormer decoder in f32, the Swin backbone (B4 on CUDA)
and the pipeline in bf16 on CUDA, f32 on the CPU.

PNGs are written by the port's own encoder (`data.image_io.write_png`) and the
seg input is resized with the Pillow-exact `data.mm_utils.resize_bicubic`:
no PIL on the card. gradio (the web UI) and transformers (a tokenizer, the
OneFormer task text) are imported inside the functions that need them.

    python -m visper_lm_tpu_torch.demo --model-path ckpt --tokenizer tok \\
        --image cat.png --question "What is here?" --viz --teachers ckpts/teachers
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from visper_lm_tpu_torch.config import dataclass_from_dict
from visper_lm_tpu_torch.data.image_io import load_image, write_png
from visper_lm_tpu_torch.data.mm_utils import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    resize_bicubic,
    to_rgb_array,
)


def _dtypes(device: torch.device):
    """(decoders' dtype, Swin / pipeline dtype) on `device`."""
    return torch.float32, (torch.bfloat16 if device.type == "cuda" else torch.float32)


def load_viz_decoders(model, model_dir: Optional[str] = None, teachers_dir: Optional[str] = None,
                      quiet: bool = False) -> Dict[str, Any]:
    """Find and load the visualisation decoders onto the model's device (see
    the module docstring). Returns a dict with any of: "dpt" (a DPTHead),
    "oneformer" ({"decoder", "cfg", "swin", "swin_cfg", "task_inputs",
    "image_size"}), "genpipe" ({"pipe", "cfg", "num_inference_steps"})."""
    from visper_lm_tpu_torch import weights
    from visper_lm_tpu_torch.checkpoint.hf_import import load_sharded_safetensors
    from visper_lm_tpu_torch.utils.param import load_params_npz

    device = model.device
    f32, wide = _dtypes(device)
    out: Dict[str, Any] = {}

    def note(msg: str) -> None:
        if not quiet:
            print(f"[viz] {msg}", file=sys.stderr)

    # depth: the frozen DPT decoder
    dpt = None
    if model_dir and os.path.isdir(model_dir):
        import glob

        try:
            if glob.glob(os.path.join(model_dir, "*.safetensors")):
                from visper_lm_tpu_torch.models.teachers.dpt import import_dpt_head

                sd = load_sharded_safetensors(model_dir)
                prefix = next((c for c in ("da_v2_head.depth_head.", "model.da_v2_head.depth_head.")
                               if any(k.startswith(c) for k in sd)), None)
                if prefix:
                    dpt = weights.dpt_from_jax_params(import_dpt_head(sd, prefix=prefix), device, f32)
                    note("depth: DPT decoder loaded from the model checkpoint")
        except (OSError, ValueError, KeyError, RuntimeError) as e:
            note(f"depth: checkpoint scan failed ({e})")
    if dpt is None and teachers_dir:
        npz = os.path.join(teachers_dir, "dav2_head.npz")
        if os.path.exists(npz):
            dpt = weights.dpt_from_jax_params(load_params_npz(npz), device, f32)
            note("depth: DPT decoder loaded from the teachers dir")
    if dpt is not None:
        out["dpt"] = dpt
    else:
        note("depth: no DPT decoder found -> .npy only")

    # seg: the OneFormer decoder and its Swin backbone
    if teachers_dir:
        from visper_lm_tpu_torch.models.teachers import oneformer as of
        from visper_lm_tpu_torch.models.teachers import swin as swin_lib

        of_dir = os.path.join(teachers_dir, "oneformer")
        of_npz = os.path.join(teachers_dir, "oneformer.npz")
        try:
            if os.path.exists(os.path.join(of_dir, "config.json")):
                with open(os.path.join(of_dir, "config.json")) as f:
                    dec_cfg, swin_cfg = of.configs_from_hf(json.load(f))
                sd = load_sharded_safetensors(of_dir)
                sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}
                swin = swin_lib.SwinBackbone(swin_cfg, device=device, dtype=wide)
                swin.load_state_dict(swin_lib.import_swin_backbone(
                    sd, swin_cfg, prefix="pixel_level_module.encoder."), strict=True)
                out["oneformer"] = {
                    "decoder": weights.oneformer_from_jax_params(
                        of.import_oneformer_decoder(sd, dec_cfg), dec_cfg, device, f32),
                    "cfg": dec_cfg, "swin": swin.requires_grad_(False).eval(), "swin_cfg": swin_cfg,
                    "task_inputs": _oneformer_task_inputs(of_dir, dec_cfg),
                }
                note("seg: OneFormer loaded from the teachers dir (HF layout)")
            elif os.path.exists(of_npz):
                bundle = load_params_npz(of_npz)
                with open(os.path.join(teachers_dir, "oneformer.json")) as f:
                    cfg_json = json.load(f)
                dec_cfg = dataclass_from_dict(of.OneFormerDecoderConfig, cfg_json["decoder"])
                swin_cfg = dataclass_from_dict(swin_lib.SwinConfig, cfg_json["swin"])
                out["oneformer"] = {
                    "decoder": weights.oneformer_from_jax_params(bundle["dec"], dec_cfg, device, f32),
                    "cfg": dec_cfg,
                    "swin": weights.swin_from_jax_params(bundle["swin"], swin_cfg, device, wide),
                    "swin_cfg": swin_cfg,
                    "task_inputs": np.zeros((1, dec_cfg.task_seq_len), np.int32),
                    "image_size": int(cfg_json.get("image_size", 768)),
                }
                note("seg: OneFormer loaded from the teachers dir (npz bundle)")
        except (OSError, ValueError, KeyError, RuntimeError) as e:
            note(f"seg: OneFormer load failed ({e}) -> .npy only")
    if "oneformer" not in out:
        note("seg: no OneFormer decoder found -> .npy only")

    # gen: the unCLIP pipeline
    if teachers_dir:
        gp_npz = os.path.join(teachers_dir, "genpipe.npz")
        try:
            if os.path.exists(gp_npz):
                from visper_lm_tpu_torch.models.genpipe import genpipe_config_from_dict

                with open(os.path.join(teachers_dir, "genpipe.json")) as f:
                    cfg_json = json.load(f)
                cfg = genpipe_config_from_dict(cfg_json)
                out["genpipe"] = {
                    "pipe": weights.genpipe_from_jax_params(load_params_npz(gp_npz), cfg, device, wide),
                    "cfg": cfg,
                    "num_inference_steps": cfg_json.get("num_inference_steps", 25),
                }
                note("gen: unCLIP pipeline loaded from the teachers dir")
        except (OSError, ValueError, KeyError, RuntimeError) as e:
            note(f"gen: pipeline load failed ({e}) -> .npy only")
    if "genpipe" not in out:
        note("gen: no unCLIP pipeline found -> .npy only")
    return out


def _oneformer_task_inputs(of_dir: str, dec_cfg) -> np.ndarray:
    """'the task is semantic' tokenized by the checkpoint's CLIP tokenizer
    (the OneFormer processor's task conditioning), (1, task_seq_len); zeros,
    with a notice, where transformers or the tokenizer is missing."""
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(of_dir)
        ids = tok("the task is semantic", padding="max_length", max_length=dec_cfg.task_seq_len,
                  truncation=True).input_ids
        return np.asarray([ids], dtype=np.int32)
    except Exception as e:  # noqa: BLE001 - any tokenizer failure: JAX's zero fallback
        print(f"[viz] seg: no task tokenizer ({e!r}); task inputs are zeros", file=sys.stderr)
        return np.zeros((1, dec_cfg.task_seq_len), np.int32)


def _depth_pyramid(model, layer: int, emb) -> List[torch.Tensor]:
    """The depth head's 4-level pyramid for the DPT decoder: its intermediate
    MLP outputs where the head has them (use_intermediate_depth), else
    [emb] * 4."""
    from visper_lm_tpu_torch.models.heads import depth_intermediate_features

    d = model.cfg.distill
    heads = model.model.heads["depth"] if "depth" in model.model.heads else None
    if d is not None and heads is not None:
        for tcfg in d.tasks:
            if tcfg.task == "depth" and layer in tcfg.layer_indices:
                head = heads[tcfg.layer_indices.index(layer)]
                p = next(head.parameters())
                x = torch.as_tensor(np.asarray(emb)).to(device=p.device, dtype=p.dtype)
                with torch.no_grad():
                    feats = depth_intermediate_features(head, x)
                return feats if len(feats) >= 4 else [feats[-1]] * 4
    return [torch.as_tensor(np.asarray(emb), device=model.device)] * 4


@torch.no_grad()
def visualize_interpretations(model, question: str, image, out_dir: str, dpt=None,
                              oneformer: Optional[dict] = None,
                              genpipe: Optional[dict] = None) -> Dict[str, str]:
    """`get_visual_interpretations`, then every task the loaded decoders
    cover rendered to PNG (the embeddings always dumped as .npy). Returns
    the manifest {"<task>/<layer + 1>": npy path, "..._png" / "..._sem": PNG
    path}, JAX's keys and file names."""
    from visper_lm_tpu_torch.models.teachers.dpt import normalized_depth

    os.makedirs(out_dir, exist_ok=True)
    interp = model.get_visual_interpretations(question, image)
    manifest: Dict[str, str] = {}
    for task, layers in interp.items():
        for layer, emb in layers.items():
            base = os.path.join(out_dir, f"{task}_layer{layer + 1}")
            np.save(base + ".npy", emb)
            manifest[f"{task}/{layer + 1}"] = base + ".npy"
            if task == "depth" and dpt is not None:
                depth = normalized_depth(dpt, _depth_pyramid(model, layer, emb))[0]
                _save_colormap(depth.cpu().numpy(), base + ".png")
                manifest[f"{task}/{layer + 1}_png"] = base + ".png"
            if task == "seg" and oneformer is not None:
                sem = _semantic_map(model, oneformer, image, emb)
                _save_colormap(sem / max(sem.max(), 1), base + "_sem.png")
                manifest[f"{task}/{layer + 1}_sem"] = base + "_sem.png"
            if task == "gen" and genpipe is not None:
                from visper_lm_tpu_torch.models.genpipe import generate_from_embeds

                imgs = generate_from_embeds(
                    genpipe["pipe"], genpipe["cfg"], np.asarray(emb).reshape(1, -1),
                    num_inference_steps=genpipe.get("num_inference_steps", 25))
                write_png(base + ".png", (imgs[0] * 255).clip(0, 255).astype(np.uint8))
                manifest[f"{task}/{layer + 1}_png"] = base + ".png"
    return manifest


def _semantic_map(model, oneformer: dict, image, emb) -> np.ndarray:
    """The (H, W) class map of `image` with the predicted seg embedding
    substituted for the backbone's last feature; the backbone runs at the
    bundle's image size (the processor's resolution)."""
    from visper_lm_tpu_torch.models.teachers.oneformer import get_masks, semantic_segmentation

    dev = model.device
    side = int(emb.shape[1] ** 0.5)
    pred_map = torch.as_tensor(np.asarray(emb), device=dev).reshape(1, side, side, -1)
    seg_res = oneformer.get("image_size", 768)
    arr = to_rgb_array(image)
    pixels = resize_bicubic(arr, (seg_res, seg_res)).astype(np.float32)[None] / 255.0
    pixels = (pixels - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
    out = get_masks(oneformer["decoder"], oneformer["cfg"], oneformer["swin"],
                    torch.as_tensor(pixels.astype(np.float32), device=dev),
                    oneformer["task_inputs"], backbone_last_feature=pred_map)
    sem = semantic_segmentation(out["class_queries_logits"], out["masks_queries_logits"],
                                (arr.shape[0], arr.shape[1]))
    return sem[0].cpu().numpy()


def _save_colormap(x01: np.ndarray, path: str) -> None:
    """A [0, 1] map as an inferno-like RGB PNG (no matplotlib)."""
    x = np.clip(x01, 0, 1)
    r = np.clip(1.5 * x, 0, 1)
    g = np.clip(1.5 * (x - 0.33), 0, 1)
    b = np.clip(1.5 * (x - 0.66), 0, 1)
    write_png(path, (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8))


def _print_stream(text: str) -> None:
    print(text, end="", flush=True)


def repl(model, image_path: str, out_dir: str = "demo_out", decoders=None) -> None:
    """The CLI chat: a multi-turn ChatSession over one image (each turn
    prefills only its own tokens), `/viz <question>` renders the
    interpretations, `/quit` ends."""
    decoders = decoders or {}
    image = load_image(image_path)
    session = model.chat_session(image)
    print(f"Loaded {image_path}. Commands: /viz <question>, /quit, or just chat.")
    while True:
        try:
            line = input("user> ").strip()
        except EOFError:
            return
        if not line:
            continue
        if line == "/quit":
            return
        if line.startswith("/viz"):
            q = line[4:].strip() or "Describe the image."
            print(json.dumps(visualize_interpretations(model, q, image, out_dir, **decoders),
                             indent=2))
            continue
        print("assistant> ", end="", flush=True)
        session.ask(line, max_new_tokens=256, stream_callback=_print_stream)
        print()


def build_ui(model, gr, out_dir: str = "demo_out", decoders=None, max_new_tokens: int = 256):
    """The Gradio Blocks graph: an image upload, a STREAMED chat (a worker
    thread decodes while the handler yields the accumulated text) and a
    "Visualize" button wired to the decoders. `gr` is the gradio module,
    passed in so tests can drive the graph under a stub. Returns (ui,
    {"chat": fn, "viz": fn})."""
    import queue
    import threading

    decoders = decoders or {}

    def _chat(message, history, image):
        if image is None:
            yield "Please upload an image first."
            return
        q: "queue.Queue" = queue.Queue()
        done = object()
        err: list = []

        def _run():
            try:
                model.chat([message], [image], max_new_tokens=max_new_tokens, stream_callback=q.put)
            except BaseException as e:   # noqa: BLE001 - re-raised on the handler's side
                err.append(e)
            finally:
                q.put(done)

        threading.Thread(target=_run, daemon=True).start()
        text = ""
        while True:
            piece = q.get()
            if piece is done:
                break
            text += piece
            yield text
        if err:
            raise err[0]
        if not text:
            yield text   # an empty generation still resolves the turn

    def _viz(question, image):
        if image is None:
            return {}
        return visualize_interpretations(model, question or "Describe the image.", image,
                                         out_dir, **decoders)

    with gr.Blocks(title="VisPer-LM TPU demo") as ui:
        image = gr.Image(type="pil", label="image")
        chat = gr.ChatInterface(fn=_chat, additional_inputs=[image])
        question = gr.Textbox(label="viz question", value="Describe the image.")
        viz_btn = gr.Button("Visualize intermediate representations")
        manifest = gr.JSON(label="rendered artifacts")
        viz_btn.click(_viz, inputs=[question, image], outputs=[manifest])
        _ = chat
    return ui, {"chat": _chat, "viz": _viz}


def serve(model, port: int = 7860, out_dir: str = "demo_out", decoders=None) -> None:
    """The Gradio web UI; the CLI REPL has the same capabilities without gradio."""
    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit("--serve needs gradio, which is not installed here; use the CLI REPL "
                         "(omit --serve)") from e
    ui, _ = build_ui(model, gr, out_dir=out_dir, decoders=decoders)
    ui.launch(server_port=port)


def main(argv: Optional[list] = None, model=None) -> None:
    """The demo CLI. A caller that already holds a `VisperModel` passes it
    as `model` (then --model-path only names where the DPT head may be
    found); otherwise --model-path is an HF-layout checkpoint directory."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model-path", required=model is None, help="HF-layout checkpoint dir")
    parser.add_argument("--tokenizer", default=None,
                        help="a transformers tokenizer (default: --model-path), or fake-whitespace")
    parser.add_argument("--image", default=None)
    parser.add_argument("--question", default=None, help="one-shot question (no REPL)")
    parser.add_argument("--viz", action="store_true", help="render interpretations")
    parser.add_argument("--teachers", default=None,
                        help="dir of visualisation decoder bundles (see the module doc); "
                             "defaults to <model-path>/teachers when present")
    parser.add_argument("--out-dir", default="demo_out")
    parser.add_argument("--serve", action="store_true", help="gradio web UI (optional)")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)

    if model is None:
        from visper_lm_tpu_torch.api import VisperModel
        from visper_lm_tpu_torch.train.cli import load_tokenizer

        tokenizer = load_tokenizer(args.tokenizer or args.model_path)
        model = VisperModel.from_hf_checkpoint(args.model_path, tokenizer=tokenizer,
                                               device=args.device)
    teachers = args.teachers
    if teachers is None and args.model_path and os.path.isdir(os.path.join(args.model_path, "teachers")):
        teachers = os.path.join(args.model_path, "teachers")
    decoders = (load_viz_decoders(model, args.model_path, teachers)
                if (args.viz or not args.question) else {})

    if args.serve:
        serve(model, port=args.port, out_dir=args.out_dir, decoders=decoders)
    elif args.question:
        if args.image is None:
            parser.error("--question needs --image")
        image = load_image(args.image)
        print(model.chat([args.question], [image])[0])
        if args.viz:
            manifest = visualize_interpretations(model, args.question, image, args.out_dir,
                                                 **decoders)
            print(json.dumps(manifest, indent=2))
    else:
        if args.image is None:
            parser.error("the REPL needs --image")
        repl(model, args.image, args.out_dir, decoders=decoders)


if __name__ == "__main__":
    main()
