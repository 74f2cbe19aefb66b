"""Batched greedy decode throughput, tokens/s (counterpart of the root
bench_decode.py).

    python -m visper_lm_tpu_torch.tools.bench_decode [--batch 8] [--prompt 768]
        [--new 64] [--kv-quant] [--weight-quant | --weight-quant4]
        [--tower clip|convnext] [--smoke] [--device cuda|cpu]

Phi3-mini-4k + CLIP-ViT-L/14-336 (distill task tokens) with seeded random
weights serves B left-padded multimodal prompts through `Generator`. Three
timings, as the JAX script takes them: the prefill alone, the decode chunks
alone (`Generator._decode_chunk` after a warm chunk, one synchronize at the
end), then `generate` end to end. Prints one JSON line; the record also
names the device (`"device"`).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from visper_lm_tpu_torch.tools import device_name, sync


def decode_batch(cfg, batch_size: int, prompt: int) -> Dict[str, np.ndarray]:
    """The script's prompts from np.random.default_rng(0): sample b is the
    system ids, one image and 16 + b text tokens, left-padded to `prompt`,
    with its image."""
    from visper_lm_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from visper_lm_tpu_torch.data.collate import build_splice_plan
    from visper_lm_tpu_torch.serve.generate import left_pad_plans

    rng = np.random.default_rng(0)
    vocab = cfg.decoder.vocab_size
    plans = [
        build_splice_plan(
            list(rng.integers(3, vocab - 10, size=cfg.num_sys_tokens)) + [IMAGE_TOKEN_INDEX]
            + list(rng.integers(3, vocab - 10, size=16 + b)),
            None, prompt, num_image_tokens=cfg.num_image_tokens,
            num_task_tokens=cfg.distill.num_task_tokens,
            num_tasks=len(cfg.distill.task_order()),
        )
        for b in range(batch_size)
    ]
    batch = left_pad_plans(plans, prompt)
    size = cfg.convnext.image_size if cfg.use_convnext_tower else cfg.vision.image_size
    batch["images"] = rng.normal(size=(batch_size, size, size, 3)).astype(np.float32)
    return batch


def measure(gen, batch: Dict[str, Any], new: int, warm: bool = True) -> Dict[str, Any]:
    """The script's record for Generator `gen` on `batch`: one generate to
    warm every path (warm=False: the caller has run one), then the prefill
    alone, `new // decode_chunk` decode chunks alone (after a warm chunk)
    and generate end to end."""
    device = gen.device
    B = gen.batch_size
    chunk = max(gen.gen_cfg.decode_chunk, 1)
    n_chunks = max(new // chunk, 1)
    if gen.prompt_len + (n_chunks + 1) * chunk > gen.max_len:
        raise ValueError(f"{n_chunks + 1} decode chunks of {chunk} past a {gen.prompt_len}-token "
                         f"prompt overrun the Generator's {gen.max_len}-slot cache")
    if warm:
        gen.generate(batch)                                         # warm both phases
    dbatch = gen._to_device(batch)
    sync(device)
    t0 = time.perf_counter()
    logits, cache = gen.prefill(dbatch)
    sync(device)
    prefill_s = time.perf_counter() - t0

    token = logits.argmax(-1)
    offsets = dbatch["pad_offsets"].long()
    rng = torch.Generator(device=device).manual_seed(0)
    toks = gen._decode_chunk(cache, token, 0, offsets, rng)         # warm
    sync(device)
    t0 = time.perf_counter()
    step = chunk
    for _ in range(n_chunks):
        toks = gen._decode_chunk(cache, token, step, offsets, rng)
        step += chunk
    sync(device)
    decode_s = time.perf_counter() - t0
    decode_tok_s = B * n_chunks * chunk / decode_s
    del toks, cache, logits                                         # free before the e2e pass

    t0 = time.perf_counter()
    out = gen.generate(batch)
    sync(device)
    dt = time.perf_counter() - t0
    n_tok = sum(len(o) for o in out)
    return {
        "metric": "greedy_decode_tokens_per_sec",
        "value": round(decode_tok_s, 2),
        "unit": "tokens/s",
        "batch": B,
        "tokens_per_sec_per_seq": round(decode_tok_s / B, 2),
        "decode_step_ms": round(1000 * decode_s / (n_chunks * chunk), 2),
        "prefill_s": round(prefill_s, 3),
        "e2e_tokens_per_sec": round(n_tok / dt, 2),
        "device": device_name(device),
    }


def build_argparser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults, plus --device."""
    p = argparse.ArgumentParser(prog="python -m visper_lm_tpu_torch.tools.bench_decode")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt", type=int, default=768)
    p.add_argument("--new", type=int, default=64)
    p.add_argument("--smoke", action="store_true", help="the tiny config (B2, prompt 64, 8 new)")
    p.add_argument("--kv-quant", action="store_true", help="int8 KV cache")
    p.add_argument("--weight-quant", action="store_true", help="w8a16 decoder weights")
    p.add_argument("--weight-quant4", action="store_true",
                   help="w4a16 group-wise int4 decoder weights")
    p.add_argument("--tower", default="clip", choices=["clip", "convnext"],
                   help="convnext = config #3's ConvNeXt-XXL trunk @768px (prefill-side "
                        "cost; the decode loop is tower-independent)")
    p.add_argument("--device", default="cuda", help="where the model runs")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    from visper_lm_tpu_torch.config import phi3_clip_vlm, tiny_test_vlm, with_convnext_tower
    from visper_lm_tpu_torch.device import resolve_device
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = tiny_test_vlm(distill=True) if args.smoke else phi3_clip_vlm(distill=True)
    if args.tower == "convnext" and not args.smoke:
        cfg = with_convnext_tower(cfg)
    B = 2 if args.smoke else args.batch
    prompt = 64 if args.smoke else args.prompt
    new = 8 if args.smoke else args.new
    model = init_vlm(cfg, device=device, seed=0)
    batch = decode_batch(cfg, B, prompt)
    wq = "int4" if args.weight_quant4 else args.weight_quant
    gen = Generator(model, cfg, GenerationConfig(max_new_tokens=new, kv_quant=args.kv_quant,
                                                 weight_quant=wq), B, prompt, device=device)
    record = measure(gen, batch, new)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
