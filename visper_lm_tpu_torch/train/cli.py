"""Training CLI (counterpart of visper_lm_tpu/train/cli.py): one entry point
for the reference's launch scripts, with the JAX CLI's flags and stages.

  pretrain (PT, distillation)   recipes/pretrain.args
  finetune (IFT)                recipes/finetune.args, recipes/vpt_ift.args
  vpt                           recipes/vpt.args
  probe                         recipes/probe.args
  pretrain_full                 recipes/pretrain_full.args (needs items 7-8)

    python -m visper_lm_tpu_torch.train.cli @recipes/pretrain.args \\
        --data-path data.json --image-folder images --tokenizer fake-whitespace \\
        --output-dir out --per-device-batch-size 4 --max-steps 3

A recipe file holds one '--flag value' per line with '#' comments; flags
given after it override it. `--device` (default cuda) is where the model
and the step run; the tests pass `--device cpu`. One device only: the
multi-process flags (--coordinator, --num-processes, --process-id), a mesh
(--dp / --tp other than 1), ZeRO (--zero-params, --zero-frozen), the
offloaded optimizer state, sharded teachers and gradient streaming parse as
in JAX and then raise NotImplementedError (ROADMAP queue A, items 7 and 8).

The model is made on the device from seed 0 (`init_vlm`); `--init-from`
overlays an HF-layout checkpoint directory on it (`import_vlm`, each tensor
rounded to bf16 as JAX's overlay does). Teachers load from their files where
they exist, else are seeded (with a WARNING). `--tokenizer fake-whitespace`
is the port's own whitespace tokenizer (`FakeTokenizer`); any other name is
loaded with `transformers`, imported there. `main(argv)` returns the final
`TrainStep`.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Any, List, Optional, Sequence

import numpy as np


class _RecipeArgumentParser(argparse.ArgumentParser):
    """Reads @recipes/<stage>.args files: '--flag value' per line, '#' comments."""

    def convert_arg_line_to_args(self, arg_line: str):
        line = arg_line.split("#", 1)[0].strip()
        return line.split() if line else []


def build_argparser() -> argparse.ArgumentParser:
    """Every flag of the JAX CLI's parser, with its defaults, plus --device."""
    p = _RecipeArgumentParser(description=__doc__, fromfile_prefix_chars="@",
                              formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--stage", required=True,
                   choices=["pretrain", "finetune", "vpt", "probe", "pretrain_full"],
                   help="pretrain_full: the PT distillation losses with the whole "
                        "model trainable")
    p.add_argument("--model", default="llama3", choices=["llama3", "phi3", "vicuna"])
    p.add_argument("--version", default=None, help="conversation template")
    p.add_argument("--vision-tower", default="clip", choices=["clip", "convnext"])
    p.add_argument("--mm-projector-type", default="mlp2x_gelu")
    p.add_argument("--image-aspect-ratio", default="square", choices=["square", "pad", "anyres"])
    # distillation
    p.add_argument("--mode", default="gen-depth-seg")
    p.add_argument("--layer-indices", default="d18-20_s10-18_g12-20")
    p.add_argument("--loss-weights", default="d0.5_s0.5_g0.5")
    p.add_argument("--num-task-tokens", type=int, default=8)
    p.add_argument("--contrastive-loss-weight", type=float, default=0.3)
    p.add_argument("--probe-mode", default="depth", choices=["gen", "seg", "depth"])
    # teachers (checkpoint paths; seeded random weights with a warning when absent)
    p.add_argument("--depth-estimator", default="depth_anything_v2_vitl.pth")
    p.add_argument("--image-segmentor", default="shi-labs/oneformer_coco_swin_large")
    p.add_argument("--image-generator", default="stabilityai/stable-diffusion-2-1-unclip")
    # data
    p.add_argument("--data-path", required=True)
    p.add_argument("--image-folder", default=None)
    p.add_argument("--tokenizer", required=True,
                   help="a transformers tokenizer name, or fake-whitespace")
    p.add_argument("--model-max-length", type=int, default=4096)
    p.add_argument("--group-by-modality-length", action="store_true")
    # init
    p.add_argument("--init-from", default=None,
                   help="HF checkpoint dir to initialize trunk+tower from")
    # optimization
    p.add_argument("--per-device-batch-size", type=int, default=32)
    p.add_argument("--gradient-accumulation-steps", type=int, default=1)
    # input pipeline
    p.add_argument("--dataloader-num-workers", type=int, default=4,
                   help="threads for per-sample image decode (0 = inline)")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="batches assembled ahead on a background thread (0 = synchronous)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--mm-projector-lr", type=float, default=None)
    p.add_argument("--mm-vision-lr", type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--warmup-ratio", type=float, default=0.03)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--max-steps", type=int, default=None)
    # checkpointing / logging
    p.add_argument("--output-dir", required=True)
    p.add_argument("--save-steps", type=int, default=200)
    p.add_argument("--save-total-limit", type=int, default=3)
    p.add_argument("--logging-steps", type=int, default=1)
    # mesh / multi-process runtime: parsed, not ported (raise)
    p.add_argument("--dp", type=int, default=None)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--zero-params", action="store_true")
    p.add_argument("--offload-opt-state", action="store_true")
    p.add_argument("--zero-frozen", action="store_true")
    p.add_argument("--shard-teachers", action="store_true")
    p.add_argument("--stream-grads", type=int, default=0)
    p.add_argument("--remat-policy", default=None,
                   help="remat save set (models/decoder.REMAT_POLICIES); none given: "
                        "every block rematerialised in full")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--seq-buckets", default="1024,2048,4096")
    p.add_argument("--smoke", action="store_true",
                   help="tiny model + random distill targets (CI/CPU smoke)")
    # the port's own
    p.add_argument("--device", default="cuda", help="where the model and the step run")
    return p


def unported_flags(args) -> List[str]:
    """The flags asked for that need more than one device or host-memory
    machinery the port does not have yet."""
    asked = []
    if args.coordinator is not None:
        asked.append("--coordinator")
    if args.num_processes not in (None, 1):
        asked.append("--num-processes")
    if args.process_id not in (None, 0):
        asked.append("--process-id")
    if args.dp not in (None, 1):
        asked.append("--dp")
    if args.tp != 1:
        asked.append("--tp")
    for flag in ("zero_params", "zero_frozen", "offload_opt_state", "shard_teachers"):
        if getattr(args, flag):
            asked.append("--" + flag.replace("_", "-"))
    if args.stream_grads:
        asked.append("--stream-grads")
    return asked


def build_vlm_config(args) -> Any:
    from visper_lm_tpu_torch import config as C

    decoder = {"llama3": C.LLAMA3_8B, "phi3": C.PHI3_MINI_4K, "vicuna": C.VICUNA_7B}[args.model]
    template = args.version or {
        "llama3": "llava_llama_3", "phi3": "llava_phi_3", "vicuna": "vicuna_v1"}[args.model]
    num_sys = {"llama3": 38, "phi3": 13, "vicuna": 26}[args.model]
    use_convnext = args.vision_tower == "convnext"
    vision = C.CLIP_VIT_L_336
    # the heads and teachers exist only in PT: vpt and IFT train plain NTP
    distill = None
    if args.stage in ("pretrain", "pretrain_full"):
        distill = C.make_distill_config(
            mode=args.mode, layer_indices=args.layer_indices, loss_weights=args.loss_weights,
            num_task_tokens=args.num_task_tokens,
            contrastive_loss_weight=args.contrastive_loss_weight,
        )
    elif args.stage == "probe":
        distill = C.probe_distill_config(args.probe_mode, decoder.num_layers)
    return C.VLMConfig(
        decoder=decoder,
        vision=vision,
        projector=C.ProjectorConfig(
            projector_type=args.mm_projector_type,
            input_dim=3072 if use_convnext else vision.hidden_size,
            output_dim=decoder.hidden_size,
        ),
        distill=distill,
        conv_template=template,
        num_sys_tokens=num_sys,
        image_aspect_ratio=args.image_aspect_ratio,
        use_convnext_tower=use_convnext,
        convnext=C.CONVNEXT_XXL_768 if use_convnext else None,
    )


class FakeTokenizer:
    """Whitespace + special-token tokenizer with a BOS, with the HF call
    interface: ids 100 + hash(word) % 400 (Python's string hash, so the ids
    hold within one process), BOS 1. Additive (len(tok(a + b)) == len(tok(a))
    + len(tok(b)) - 1), so the templates' round-length arithmetic holds."""

    bos_token_id = 1
    _SPECIALS = ("<|end|>", "<|eot_id|>", "</s>", "<|system|>", "<|user|>",
                 "<|assistant|>", "<|start_header_id|>", "<|end_header_id|>")
    _PATTERN = re.compile("(" + "|".join(re.escape(s) for s in _SPECIALS) + "|\\n)")

    def _words(self, text: str) -> List[str]:
        words = []
        for part in self._PATTERN.split(text):
            if part in self._SPECIALS or part == "\n":
                words.append(part)
            else:
                words.extend(w for w in part.split(" ") if w)
        return words

    def __call__(self, text: str):
        return argparse.Namespace(
            input_ids=[self.bos_token_id] + [100 + (hash(w) % 400) for w in self._words(text)])

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        return " ".join(str(i) for i in ids)


def load_tokenizer(name: str):
    if name == "fake-whitespace":
        return FakeTokenizer()
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(name)


def load_teachers(args, cfg, device) -> tuple:
    """(teacher_fn, teachers): weights imported where their files exist,
    seeded random weights (with a WARNING) otherwise; (None, None) without
    distillation."""
    import torch

    from visper_lm_tpu_torch.checkpoint.hf_import import load_sharded_safetensors
    from visper_lm_tpu_torch.models import teachers as T
    from visper_lm_tpu_torch.models.teachers.dinov2 import import_dav2_dinov2
    from visper_lm_tpu_torch.models.teachers.swin import SWIN_L, import_swin_backbone
    from visper_lm_tpu_torch.models.teachers.unclip import import_clip_h

    if cfg.distill is None:
        return None, None
    teachers = T.init_teachers(cfg, device=device, seed=7)
    mode = cfg.distill.mode
    loaded = []
    if os.path.exists(args.depth_estimator) and "depth" in mode:
        sd = torch.load(args.depth_estimator, map_location="cpu", weights_only=True)
        T.load_teacher(teachers, "dinov2", import_dav2_dinov2(sd))
        loaded.append("depth")
    if os.path.isdir(str(args.image_segmentor)) and "seg" in mode:
        sd = load_sharded_safetensors(args.image_segmentor)
        T.load_teacher(teachers, "swin", import_swin_backbone(
            sd, SWIN_L, prefix="pixel_level_module.encoder."))
        loaded.append("seg")
    if os.path.isdir(str(args.image_generator)) and "gen" in mode:
        enc_dir = os.path.join(args.image_generator, "image_encoder")
        sd = load_sharded_safetensors(enc_dir if os.path.isdir(enc_dir) else args.image_generator)
        T.load_teacher(teachers, "clip_h", import_clip_h(sd))
        loaded.append("gen")
    missing = set(cfg.distill.task_order()) - set(loaded)
    if missing:
        print(f"WARNING: teachers randomly initialized (no weights found): {sorted(missing)}")
    return T.make_teacher_fn(cfg), teachers


def overlay_checkpoint(model, cfg, model_dir: str) -> int:
    """Copy `import_vlm` of an HF-layout checkpoint onto the model's
    parameters, each tensor rounded to bf16 first (JAX imports with
    to_jax(dtype=bfloat16)); what the checkpoint lacks keeps its init.
    Returns the number of tensors copied."""
    import torch

    from visper_lm_tpu_torch.checkpoint.hf_import import import_vlm, load_sharded_safetensors

    imported = import_vlm(load_sharded_safetensors(model_dir), cfg)
    params = dict(model.named_parameters())
    unknown = sorted(set(imported) - set(params))
    if unknown:
        raise KeyError(f"{model_dir}: tensors the model does not hold: {unknown[:5]}")
    with torch.no_grad():
        for name, t in imported.items():
            p = params[name]
            p.copy_(t.to(torch.bfloat16).to(device=p.device, dtype=p.dtype))
    return len(imported)


def main(argv: Optional[Sequence[str]] = None):
    args = build_argparser().parse_args(argv)
    asked = unported_flags(args)
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: multi-device and host-offload training are not ported yet "
            "(ROADMAP queue A, items 7 and 8); the port trains on one device")

    from visper_lm_tpu_torch.config import tiny_test_vlm
    from visper_lm_tpu_torch.data.dataset import RAW_IMAGES, BatchIterator, DataConfig, SupervisedDataset
    from visper_lm_tpu_torch.data.prefetch import PrefetchIterator
    from visper_lm_tpu_torch.models.teachers import teacher_batch
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.train.optimizer import OptimizerConfig
    from visper_lm_tpu_torch.train.trainer import TrainerConfig, train

    if args.smoke:
        cfg = tiny_test_vlm(distill=args.stage in ("pretrain", "pretrain_full", "probe"))
    else:
        cfg = build_vlm_config(args)
    tokenizer = load_tokenizer(args.tokenizer)
    dcfg = DataConfig(
        data_path=args.data_path,
        image_folder=args.image_folder,
        image_aspect_ratio=args.image_aspect_ratio,
        image_size=cfg.convnext.image_size if cfg.use_convnext_tower else cfg.vision.image_size,
        model_max_length=args.model_max_length,
        group_by_modality_length=args.group_by_modality_length,
    )
    ds = SupervisedDataset(dcfg, tokenizer, cfg)
    n_batches_per_epoch = len(ds) // (args.per_device_batch_size * args.gradient_accumulation_steps)
    total_steps = args.max_steps or n_batches_per_epoch * args.epochs
    distill_tasks = tuple(t.task for t in cfg.distill.tasks) if cfg.distill else ()
    buckets = tuple(int(x) for x in args.seq_buckets.split(","))

    def data_iter(epoch: int, skip_batches: int = 0):
        it = BatchIterator(
            ds, args.per_device_batch_size, seq_buckets=buckets, seed=epoch,
            distill_tasks=distill_tasks, num_workers=args.dataloader_num_workers,
            skip_batches=skip_batches,
        )
        size = dcfg.image_size
        for batch in it:
            raw = batch.pop(RAW_IMAGES)
            if cfg.distill is not None:
                if args.smoke:
                    rng = np.random.default_rng(0)
                    b = batch["labels"].shape[0]
                    for t in cfg.distill.tasks:
                        batch[f"{t.task}_target"] = rng.normal(
                            size=(b, t.target_tokens, t.target_dim)).astype(np.float32)
                else:
                    # text-only samples get a black placeholder; their task masks
                    # are 0, so their targets never reach the loss
                    raw = [im if im is not None else np.zeros((size, size, 3), np.uint8)
                           for im in raw]
                    batch.update(teacher_batch(cfg, raw, workers=args.dataloader_num_workers))
            yield batch

    def prefetched_iter(epoch: int, skip_batches: int = 0):
        if args.prefetch_depth <= 0:
            yield from data_iter(epoch, skip_batches)
            return
        # batch assembly and the teachers' pixels overlap the device step; the
        # producer thread stops when the trainer lets go of this iterator
        it = PrefetchIterator(data_iter(epoch, skip_batches), depth=args.prefetch_depth)
        try:
            yield from it
        finally:
            it.close()

    model = init_vlm(cfg, device=args.device, seed=0)
    if args.init_from:
        overlay_checkpoint(model, cfg, args.init_from)
    teacher_fn, teachers = (None, None) if args.smoke else load_teachers(args, cfg, args.device)

    opt_cfg = OptimizerConfig(
        learning_rate=args.lr,
        mm_projector_lr=args.mm_projector_lr,
        mm_vision_lr=args.mm_vision_lr,
        weight_decay=args.weight_decay,
        warmup_ratio=args.warmup_ratio,
        total_steps=total_steps,
        stage={"pretrain": "pretrain", "finetune": "finetune", "vpt": "vpt",
               "probe": "probe", "pretrain_full": "full"}[args.stage],
    )
    trainer_cfg = TrainerConfig(
        output_dir=args.output_dir,
        num_epochs=args.epochs,
        max_steps=args.max_steps,
        save_steps=args.save_steps,
        save_total_limit=args.save_total_limit,
        logging_steps=args.logging_steps,
        remat_policy=args.remat_policy,
        grad_accum_steps=args.gradient_accumulation_steps,
        device=args.device,
    )
    return train(cfg, opt_cfg, trainer_cfg, model, prefetched_iter,
                 teacher_fn=teacher_fn, teacher_params=teachers)


if __name__ == "__main__":
    main()
