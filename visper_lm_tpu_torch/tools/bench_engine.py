"""Continuous-batching engine vs batch-loop serving (counterpart of the root
bench_engine.py).

    python -m visper_lm_tpu_torch.tools.bench_engine [--slots 8] [--requests 32]
        [--max-len 1536] [--quantum Q] [--smoke] [--device cuda|cpu]

On the flagship decode config (Phi3-mini + CLIP-L; on the card int8 KV +
w8a16, the decoder quantized once and shared, as the JAX script does on a
TPU; bf16 elsewhere), four measurements:

  1. the steady-state engine step (all slots busy, per-slot positions and
     scatter cache writes) against the Generator's uniform-position step;
  2. a mixed-length workload (`request_mix`) served end to end, after a warm
     pass: the engine (slots refill the moment a request retires) against the
     batch loop (every batch waits for its longest member);
  3. prefix caching: a turn over a cached 512-token history against
     prefilling history and delta again;
  4. slot-wise speculative decoding over the same workload.

Prints one JSON line with the JAX script's fields; the record also names the
device (`"device"`). The Generator of measurement 1 has a cache long enough
for the 32 chunks it times (the JAX script's, sized for 64 new tokens, has XLA
clamp the later chunks' writes).
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from visper_lm_tpu_torch.tools import device_name, sync


def make_plan(cfg, rng: np.random.Generator, prompt_tokens: int, max_len: int):
    """A multimodal prompt: the system ids, one image and `prompt_tokens`
    random text ids from rng."""
    from visper_lm_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from visper_lm_tpu_torch.data.collate import build_splice_plan

    vocab = cfg.decoder.vocab_size
    return build_splice_plan(
        list(rng.integers(3, vocab - 10, size=cfg.num_sys_tokens)) + [IMAGE_TOKEN_INDEX]
        + list(rng.integers(3, vocab - 10, size=prompt_tokens)),
        None, max_len, num_image_tokens=cfg.num_image_tokens,
        num_task_tokens=cfg.distill.num_task_tokens, num_tasks=len(cfg.distill.task_order()),
    )


def make_text_plan(cfg, rng: np.random.Generator, n: int, max_len: int):
    """A chat turn's delta: `n` random text ids (the image lives in the cached
    history prefix)."""
    from visper_lm_tpu_torch.data.collate import build_splice_plan

    return build_splice_plan(
        list(rng.integers(3, cfg.decoder.vocab_size - 10, size=n)), None, max_len,
        num_image_tokens=cfg.num_image_tokens, num_task_tokens=cfg.distill.num_task_tokens,
        num_tasks=len(cfg.distill.task_order()),
    )


def request_mix(cfg, rng: np.random.Generator, n: int, max_len: int, lo: int = 8,
                hi: int = 128) -> List[Tuple[Any, np.ndarray, int]]:
    """The mixed workload, short/medium/long answers like a real eval queue:
    per request (plan, image (1, H, W, 3), max_new_tokens) with 16-63 text
    tokens and lo..hi-1 new tokens, drawn from rng in the JAX script's order
    (np.random.default_rng(0) there)."""
    size = cfg.vision.image_size
    return [(make_plan(cfg, rng, int(rng.integers(16, 64)), max_len),
             rng.normal(size=(1, size, size, 3)).astype(np.float32),
             int(rng.integers(lo, hi)))
            for _ in range(n)]


def shared_int8(model):
    """A view of `model` sharing its tower, projector and task tokens with a
    decoder quantized once to w8a16 (the bf16 decoder is not kept by the
    view): engines and Generators built on it take weight_quant=False."""
    from visper_lm_tpu_torch.models.decoder import quantize_decoder

    view = copy.copy(model)
    view._modules = dict(model._modules)
    view.decoder = quantize_decoder(model.decoder, "int8")
    return view


def measure(model, cfg, *, slots: int, n_req: int, max_len: int, quantum: Optional[int],
            smoke: bool, kvq: bool, wq: bool) -> Dict[str, Any]:
    """The four measurements on `model` (whose decoder is already quantized
    when the run serves w8a16: `shared_int8`); the record."""
    from visper_lm_tpu_torch.serve.engine import Engine, EngineConfig, Request
    from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator, left_pad_plans

    device = next(model.parameters()).device
    B = slots
    qkw = {} if quantum is None else {"decode_quantum": quantum}
    rng = np.random.default_rng(0)
    lo, hi = (4, 12) if smoke else (8, 128)
    reqs_spec = request_mix(cfg, rng, n_req, max_len, lo, hi)

    def engine(**kw):
        return Engine(model, cfg, EngineConfig(num_slots=kw.pop("num_slots", B), max_len=max_len,
                                               kv_quant=kvq, **kw), device=device)

    def fresh_reqs():
        return [Request(plan=pl, images=im, max_new_tokens=mn, uid=i)
                for i, (pl, im, mn) in enumerate(reqs_spec)]

    # ---- 1. steady-state step-time comparison ------------------------------
    eng = engine(**qkw)
    for i in range(B):
        plan, im, _ = reqs_spec[i % n_req]
        eng.submit(Request(plan=plan, images=im, max_new_tokens=10 ** 9, uid=i))
    eng.step()                                    # admits them
    n_time = 4 if smoke else 32
    q = eng.ecfg.decode_quantum
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n_time):
        eng.step()
    sync(device)
    eng_step_ms = 1000 * (time.perf_counter() - t0) / n_time
    eng_tok_ms = eng_step_ms / max(q, 1)          # per decoded token per slot-row
    del eng                                       # its slot cache, before the Generator's

    longest = max(r[0].seq_length for r in reqs_spec)
    prompt_pad = -(-longest // 128) * 128
    gbatch = left_pad_plans([r[0] for r in reqs_spec[:B]], prompt_pad)
    gbatch["images"] = np.concatenate([r[1] for r in reqs_spec[:B]])
    # a cache that holds every timed chunk (the JAX script's 64 new tokens let XLA
    # clamp the later chunks' writes at the cache's end; here they would overrun it)
    gen = Generator(model, cfg, GenerationConfig(max_new_tokens=8 * (n_time + 1), decode_chunk=8,
                                                 kv_quant=kvq), B, prompt_pad, device=device)
    jb = gen._to_device(gbatch)
    offsets = jb["pad_offsets"].long()
    key = torch.Generator(device=device).manual_seed(0)
    logits, cache = gen.prefill(jb)
    token = logits.argmax(-1)
    toks = gen._decode_chunk(cache, token, 0, offsets, key)          # warm
    sync(device)
    t0 = time.perf_counter()
    for i in range(n_time):
        toks = gen._decode_chunk(cache, token, 8 * (i + 1), offsets, key)
    sync(device)
    gen_step_ms = 1000 * (time.perf_counter() - t0) / (n_time * 8)
    del toks, cache, logits, gen, jb

    # ---- 2. end-to-end mixed workload --------------------------------------
    # a serving engine is a long-lived process: the warm pass runs every
    # path once, the second pass is measured; the batch loop gets the same
    eng2 = engine(**qkw)
    eng2.run(fresh_reqs())                        # warm pass
    eng2.stats = {k: 0 for k in eng2.stats}
    sync(device)
    t0 = time.perf_counter()
    finished = eng2.run(fresh_reqs())
    sync(device)
    eng_e2e_s = time.perf_counter() - t0
    n_tok = sum(len(r.output_ids) for r in finished)
    occupancy = eng2.stats["slot_steps"] / max(
        eng2.stats["steps"] * B * eng2.ecfg.decode_quantum, 1)
    admit_dispatch = eng2.stats["admit_dispatches"]
    group_adm = eng2.stats["group_admissions"]
    del eng2

    # the batch loop: fixed batches of B, each decoding to its longest
    # member, one Generator for every batch
    g = Generator(model, cfg, GenerationConfig(max_new_tokens=hi, decode_chunk=8, kv_quant=kvq),
                  B, prompt_pad, device=device)

    def run_batch_loop():
        t0 = time.perf_counter()
        tok_count = 0
        for i in range(0, n_req, B):
            chunk = reqs_spec[i:i + B]
            while len(chunk) < B:
                chunk.append(chunk[-1])
            batch = left_pad_plans([c[0] for c in chunk], prompt_pad)
            batch["images"] = np.concatenate([c[1] for c in chunk])
            jb = g._to_device(batch)
            logits, cache = g.prefill(jb)
            token = logits.argmax(-1)
            batch_max = max(c[2] for c in reqs_spec[i:i + B])
            for ci in range(-(-(batch_max - 1) // 8)):
                token = g._decode_chunk(cache, token, 8 * ci, jb["pad_offsets"].long(), key)[-1]
            token.cpu()                           # the batch's host sync
            tok_count += sum(c[2] for c in reqs_spec[i:i + B])
            del cache
        return tok_count, time.perf_counter() - t0

    run_batch_loop()                              # warm pass
    loop_tok, loop_e2e_s = run_batch_loop()
    del g

    # ---- 3. prefix caching: turn latency over a long chat history ----------
    hist_tok = 24 if smoke else 512
    delta_tok = 8 if smoke else 32
    eng3 = engine(num_slots=1)
    hist_plan = make_plan(cfg, rng, hist_tok, max_len)
    img = reqs_spec[0][1]
    full_plan = make_plan(cfg, rng, hist_tok + delta_tok, max_len)
    delta_plan = make_text_plan(cfg, rng, delta_tok, max_len)
    handle = eng3.prefill_prefix(hist_plan, images=img)

    def time_turn(req):
        t0 = time.perf_counter()
        r = eng3.run([req])[0]
        if not r.output_ids:
            raise RuntimeError("a prefix-caching turn produced no token")
        return time.perf_counter() - t0

    mn = 8 if smoke else 16
    time_turn(Request(plan=full_plan, images=img, max_new_tokens=mn))     # warm both paths
    time_turn(Request(plan=delta_plan, prefix=handle, max_new_tokens=mn))
    full_s = min(time_turn(Request(plan=full_plan, images=img, max_new_tokens=mn))
                 for _ in range(3))
    cached_s = min(time_turn(Request(plan=delta_plan, prefix=handle, max_new_tokens=mn))
                   for _ in range(3))

    # ---- 4. slot-wise speculative decoding over the same workload ----------
    # greedy-exact: the same tokens, fewer target weight reads; random-weight
    # greedy decode repeats tokens, so the acceptance rate is the context
    del eng3, handle                              # the handle pins a slot-length KV chain
    gc.collect()
    eng4 = engine(spec_k=4, spec_ngram=3, spec_quantum=0 if smoke else 4)
    eng4.run(fresh_reqs())                        # warm pass
    eng4.stats = {k: 0 for k in eng4.stats}
    sync(device)
    t0 = time.perf_counter()
    fin4 = eng4.run(fresh_reqs())
    sync(device)
    spec_e2e_s = time.perf_counter() - t0
    spec_tok = sum(len(r.output_ids) for r in fin4)
    spec_acc = eng4.stats["spec_accepted"] / max(eng4.stats["spec_proposed"], 1)

    return {
        "metric": "engine_decode_tokens_per_sec",
        "value": round(n_tok / eng_e2e_s, 2),
        "unit": "tokens/s",
        "spec_tokens_per_sec": round(spec_tok / spec_e2e_s, 2),
        "spec_acceptance_rate": round(spec_acc, 3),
        "spec_tokens_per_step": round(spec_tok / max(eng4.stats["steps"], 1), 2),
        "spec_speedup": round(eng_e2e_s / spec_e2e_s, 2),
        "engine_step_ms": round(eng_step_ms, 2),
        "engine_tok_ms": round(eng_tok_ms, 2),
        "decode_quantum": q,
        "generator_step_ms": round(gen_step_ms, 2),
        "scatter_overhead_pct": round(100 * (eng_tok_ms - gen_step_ms) / max(gen_step_ms, 1e-9), 1),
        "slots": B,
        "requests": n_req,
        "engine_e2e_s": round(eng_e2e_s, 2),
        "batch_loop_e2e_s": round(loop_e2e_s, 2),
        "batch_loop_tokens_per_sec": round(loop_tok / loop_e2e_s, 2),
        "speedup_vs_batch_loop": round(loop_e2e_s / eng_e2e_s, 2),
        "slot_occupancy": round(occupancy, 3),
        "admit_dispatches": admit_dispatch,
        "group_admissions": group_adm,
        "prefix_turn_full_ms": round(1000 * full_s, 1),
        "prefix_turn_cached_ms": round(1000 * cached_s, 1),
        "prefix_cache_turn_speedup": round(full_s / cached_s, 2),
        "kv_quant": kvq, "weight_quant": wq,
        "device": device_name(device),
    }


def build_argparser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults, plus --device."""
    p = argparse.ArgumentParser(prog="python -m visper_lm_tpu_torch.tools.bench_engine")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--max-len", type=int, default=1536)
    p.add_argument("--quantum", type=int, default=None,
                   help="decode_quantum override (default: EngineConfig's 8)")
    p.add_argument("--smoke", action="store_true", help="the tiny config (2 slots, 6 requests)")
    p.add_argument("--device", default="cuda", help="where the model runs")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    from visper_lm_tpu_torch.config import phi3_clip_vlm, tiny_test_vlm
    from visper_lm_tpu_torch.device import resolve_device
    from visper_lm_tpu_torch.models.vlm import init_vlm

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = tiny_test_vlm(distill=True) if args.smoke else phi3_clip_vlm(distill=True)
    # int8 KV + w8a16 on the card, where the JAX script quantizes on a TPU
    on_card = device.type == "cuda"
    model = init_vlm(cfg, device=device, seed=0)
    if on_card:
        model = shared_int8(model)
    record = measure(model, cfg, slots=2 if args.smoke else args.slots,
                     n_req=6 if args.smoke else args.requests,
                     max_len=256 if args.smoke else args.max_len, quantum=args.quantum,
                     smoke=args.smoke, kvq=on_card, wq=on_card)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
