"""Turnkey real-checkpoint validation: one command from a downloaded HF
checkpoint directory to a BASELINE-comparable scores table (the port's
counterpart of visper_lm_tpu/eval/validate.py).

    python -m visper_lm_tpu_torch.eval.validate --ckpt <dir> --tasks cvbench,mmstar \
        --cvbench-path cvbench_dir --mmstar-path mmstar.jsonl --device cuda

(`--device cpu` scores on the CPU; `--tokenizer fake-whitespace` is the port's
whitespace tokenizer where no tokenizer files or transformers are at hand.)

Steps, in order:
  1. import the checkpoint through the zoo loader
     (api.VisperModel.from_hf_checkpoint — the same path the demo and evals
     use; reference parity anchor: ola_vlm/model/builder.py:26-191), in bf16
     on the device (CUDA unless --device says otherwise);
  2. logit-parity gate: when transformers can instantiate the checkpoint's
     decoder as a torch model (the exported key surface is HF-Llama-shaped,
     checkpoint/hf_export.py), compare text-only logits on a fixed prompt and
     abort on drift beyond tolerance — numerics are checked BEFORE any
     benchmark decodes. The port's side is an f32 copy of the decoder on the
     plain path (no kernel, TF32 off); without transformers mode "auto"
     prints the skip and "require" raises;
  3. run the requested benchmark loaders batched (eval/cvbench.py,
     eval/mmstar.py — ports of model_cvbench_loader.py / model_mmstar_loader.py)
     and print per-task scores next to the reference's published numbers
     (the reference's README.md:95-99) for the matching model family.

The shi-labs weights are not in the repository; the exact command path is
dress-rehearsed end-to-end on a synthetic HF checkpoint in
tests/test_torch_eval_model.py (against the JAX package's run), so the day
real weights are available this is one invocation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

# reference README.md:95-99 (CV-Bench / MMStar per shipped checkpoint family)
REFERENCE_SCORES: Dict[str, Dict[str, float]] = {
    "phi3+clip": {"cvbench": 62.5, "mmstar": 36.0},
    "phi3+convnext": {"cvbench": 63.9, "mmstar": 38.4},
    "llama3+clip": {"cvbench": 61.4, "mmstar": 39.5},
    "llama3+convnext": {"cvbench": 61.5, "mmstar": 38.5},
    "llama3+convnext-vpt": {"cvbench": 64.6, "mmstar": 40.6},
}


def _family(model) -> Optional[str]:
    dec = "llama3" if model.cfg.decoder.hidden_size >= 4096 else "phi3"
    tower = "convnext" if model.cfg.use_convnext_tower else "clip"
    return f"{dec}+{tower}"


def logit_parity_gate(
    model, ckpt_dir: str, *, prompt_ids: Optional[Sequence[int]] = None,
    atol: float = 0.12, mode: str = "auto",
) -> Optional[Dict[str, float]]:
    """Compare our decoder's text-only logits against the torch model loaded
    from the SAME safetensors via transformers. Returns the diff stats, None
    when skipped (mode='auto' and transformers can't instantiate the arch —
    e.g. checkpoints whose config names ola_* classes)."""
    if mode == "off":
        return None
    try:
        from transformers import AutoConfig, AutoModelForCausalLM

        hf_cfg = AutoConfig.from_pretrained(ckpt_dir)
        torch_model = AutoModelForCausalLM.from_pretrained(
            ckpt_dir, torch_dtype=torch.float32
        ).eval()
    except Exception as e:
        if mode == "require":
            raise
        print(f"# parity gate skipped (transformers load failed: {e})",
              file=sys.stderr)
        return None

    from visper_lm_tpu_torch.checkpoint.hf_import import (
        import_vlm, load_sharded_safetensors, to_model,
    )

    if prompt_ids is None:
        rng = np.random.default_rng(0)
        prompt_ids = [1] + list(
            rng.integers(3, model.cfg.decoder.vocab_size - 10, size=31)
        )
    ids = np.asarray(prompt_ids, dtype=np.int64)[None]

    with torch.no_grad():
        t_logits = torch_model(input_ids=torch.from_numpy(ids)).logits.numpy()

    # our decoder in f32 on the plain path for an apples-to-apples diff
    dev = model.device
    m32 = to_model(import_vlm(load_sharded_safetensors(ckpt_dir), model.cfg), model.cfg,
                   device=dev, dtype=torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            tokens = torch.as_tensor(ids, device=dev)
            out = m32.decoder(
                m32.decoder.embed(tokens),
                positions=torch.arange(ids.shape[1], device=dev)[None], use_kernel=False,
            )
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del m32
    our_logits = out["logits"].float().cpu().numpy()
    diff = float(np.max(np.abs(our_logits - t_logits)))
    scale = float(np.max(np.abs(t_logits)))
    stats = {"max_abs_diff": diff, "logit_scale": scale}
    if diff > atol * max(scale, 1.0):
        raise AssertionError(
            f"logit parity FAILED: max|delta|={diff:.4g} vs torch "
            f"(scale {scale:.3g}, budget {atol * max(scale, 1.0):.4g})"
        )
    return stats


def validate(
    ckpt: str,
    tasks: Sequence[str],
    *,
    data_paths: Dict[str, str],
    tokenizer=None,
    limit: Optional[int] = None,
    batch_size: int = 16,
    max_new_tokens: int = 128,
    hf_parity: str = "auto",
    output_dir: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """The full validation flow; returns {task: scores} + parity stats. The
    model is loaded in bf16 on `device` (CUDA unless given)."""
    from visper_lm_tpu_torch.api import VisperModel

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    model = VisperModel.from_hf_checkpoint(ckpt, tokenizer=tokenizer, device=device)
    report: Dict[str, Any] = {"checkpoint": os.path.abspath(ckpt)}
    parity = logit_parity_gate(model, ckpt, mode=hf_parity)
    if parity is not None:
        report["logit_parity"] = parity

    fam = _family(model)
    ref = REFERENCE_SCORES.get(fam, {})
    for task in tasks:
        path = data_paths.get(task)
        if not path:
            raise ValueError(f"--{task}-path is required for task '{task}'")
        out_path = (
            os.path.join(output_dir, f"{task}_answers.jsonl")
            if output_dir else None
        )
        if task == "cvbench":
            from visper_lm_tpu_torch.eval.cvbench import prepare_cvbench, run_cvbench

            data = prepare_cvbench(path)[: limit or None]
            scores = run_cvbench(
                model, data, batch_size=batch_size,
                max_new_tokens=max_new_tokens, output_path=out_path,
            )
        elif task == "mmstar":
            from visper_lm_tpu_torch.eval.mmstar import prepare_mmstar, run_mmstar

            if path.endswith(".jsonl"):
                # pre-prepared records (image/question/answer/category/
                # l2_category) — used by offline dress rehearsals
                from visper_lm_tpu_torch.eval.cvbench import load_jsonl

                data = load_jsonl(path)[: limit or None]
            else:
                data = prepare_mmstar(path)[: limit or None]
            scores = run_mmstar(
                model, data, batch_size=batch_size,
                max_new_tokens=max_new_tokens, output_path=out_path,
            )
        else:
            raise ValueError(f"unknown task '{task}' (cvbench|mmstar)")
        report[task] = scores
        key = "accuracy" if "accuracy" in scores else next(iter(scores))
        line = f"{task:10s} {100 * scores[key]:6.2f}"
        if task in ref:
            line += f"   (reference {fam}: {ref[task]:.1f}, README.md:95-99)"
        print(line)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True, help="HF checkpoint directory")
    p.add_argument("--tasks", default="cvbench,mmstar")
    p.add_argument("--cvbench-path", default=None, help="CV-Bench test.jsonl")
    p.add_argument("--mmstar-path", default=None, help="MMStar val jsonl")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer name/dir (default: the checkpoint dir), or "
                        "fake-whitespace")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--hf-parity", default="auto",
                   choices=["auto", "require", "off"],
                   help="torch logit-parity gate before scoring")
    p.add_argument("--out", default=None, help="write the report JSON here")
    args = p.parse_args(argv)

    from visper_lm_tpu_torch.train.cli import load_tokenizer

    tokenizer = load_tokenizer(args.tokenizer or args.ckpt)
    tasks = [t.strip() for t in args.tasks.split(",") if t.strip()]
    report = validate(
        args.ckpt, tasks,
        data_paths={"cvbench": args.cvbench_path, "mmstar": args.mmstar_path},
        tokenizer=tokenizer,
        limit=args.limit,
        batch_size=args.batch_size,
        max_new_tokens=args.max_new_tokens,
        hf_parity=args.hf_parity,
        output_dir=os.path.dirname(args.out) if args.out else None,
        device=args.device,
    )
    line = json.dumps(report)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
