#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (visper_lm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:
  1. environment: torch, CUDA, Triton, nvcc, the card's name and power limit;
  2. build: nvcc compiles every kernel from visper_lm_tpu_torch/csrc, one
     process per source, all started together;
  3. kernels: each kernel vs its plain PyTorch version on the card, with the
     kernel's, the plain version's and one library call's time (the library
     call is a yardstick only; the port never calls it) beside the least time
     the card could take. Tolerances against the plain version computed in f32:
       B1 flash forward: bf16 max abs error <= 2e-2 (f32 1e-4) on rows with a
          valid key, lse <= 1e-3. At the serving and the training shape the
          mma.sync kernel it replaced is held to the same bounds and timed in
          the same call (`mma_sync_ms`; in turns: old, new, new, old);
       B2/B3 flash backward (dq, dk/dv) against the plain backward fed the
          plain forward's f32 out and lse: relative Frobenius error <= 1e-2
          and, per element, |err| <= 2e-2 + 1e-2 x |ref| (the bf16 rounding
          of the largest gradients, which sum over up to 1024 rows), at the
          training and the GQA shape, timed eager and as CUDA graphs beside
          SDPA's backward; the same launch 20 times must give identical bytes;
       B4 Swin window attention at the eight Swin-L launch shapes (stages 1-4,
          unshifted and shifted; micro-batch 2): bf16 max abs error <= 2e-2;
          the same launch 20 times the same bytes. The kernel and SDPA
          (bf16 bias + mask) timed as CUDA graphs in turns, and their sums
          weighted by a train step's 48 launches beside the bound's;
       B5 w4a16 matmul (Phi3-mini's four (din, dout) pairs at M = 8 and, but
          for lm_head, M = 6144; one AWQ case) against its plain version in
          f32: relative Frobenius error <= 1e-2 and max abs error <= 2e-2 x
          max|ref| (the bf16 output's rounding). Each case also times the
          mma.sync kernel it replaced (`mma_sync_ms`; in turns: old, new, new,
          old). An M = 8 case is host-bound in an eager loop, so beside `ms`
          (eager, as before) it is timed as a CUDA graph of launches: warm
          (`device_ms`: one weight, resident in L2) and cold (`cold_ms`: in
          turn over enough copies of the weight to exceed the 50 MB L2, as
          the decode path finds it), the library call the same way; the
          byte bound is a device-memory bound and goes with `cold_ms`. The
          same M = 8 launch 20 times must give identical bytes;
       B6 decode attention (standalone, as in the JAX package: no path calls
          it, and its launch count over phases 4-9 must stay 0) at the decode
          shape in bf16 and int8, and GQA 32/8 H128 with a fully masked row:
          on rows with a valid key relative Frobenius error <= 1e-2 and max
          abs error <= 5e-3 (max |out| is about 0.3), the masked row exactly 0,
          20 repeated launches the same bytes; the serial kernel it replaced
          is held to the same bounds. A call is host-bound in an eager loop
          (`eager_ms`), so the split kernel, the serial kernel and the library
          call are each timed as a CUDA graph of launches, in turns: warm
          (`device_ms`: one cache; the int8 one fits the L2) and cold
          (`cold_ms`, which is the record's `ms`: in turn over enough copies
          of the cache to exceed the 50 MB L2);
  4. serving path: Phi3-mini-4k + CLIP-ViT-L/14-336 (distill task tokens) at
     full width with seeded random weights serves 8 left-padded multimodal
     prompts (768 tokens) through `Generator.generate`, greedy, 32 new tokens.
     The flash kernel must launch exactly once per decoder layer (32), and the
     prefill logits must match a prefill with plain attention within
     0.05 x max|logits| (bf16 through 32 layers). The decode chunk keeps its
     step and slot on the device: the same prefill and cache decoded with a
     Python-int q_offset must give the same tokens and cache, bit for bit
     (the same arithmetic), and generate() the same tokens;
  5. serving profile: device time by kernel for one prefill and one decode chunk;
  6. quantized serving on the same model and batch: AWQ activation RMS over
     the batch's spliced embeddings (`decoder_act_rms`), then int8 KV +
     calibrated w4a16 weights through `Generator.generate`: 8 x 32 tokens, B5
     launched 225 times per decoder forward (7 linears x 32 layers + lm_head;
     prefill and every decode step), the prefill logits with the kernels
     within 0.05 x max|logits| of the plain versions' on the same quantized
     weights; the int4-vs-bf16 drift is printed (a quality trade-off, not a
     check). Then int8 KV + w8a16 generates 8 x 32 tokens. Both are timed as
     in phase 4; one int4 prefill and one int4 decode chunk are profiled,
     with B5's share of the device time;
  7. training path: config #1's PT distillation step (the same VLM plus the
     frozen DINOv2-L, CLIP-H and Swin-L teachers computing their targets in
     the step, bf16, B4 x T1024) through `make_train_step`: one warm-up step,
     then 3 timed steps. Each step must launch B1, B2 and B3 once per decoder
     layer (32 each) and B4 once per Swin block and teacher micro-batch (48);
     the loss must be finite and change from step 2 on (update 1 has lr 0); a
     frozen decoder weight must not change; at B1 the step's loss and
     trainable gradients with the kernels must match the same step with plain
     attention (decoder and window): loss within 1e-3 (relative), cosine
     >= 0.999 for every trainable with a nonzero gradient. Then one step is
     profiled: B2/B3's and B4's device time, and B4's 48 launches all of the
     streamed kernel. This phase's step runs without remat;
  8. trainer path, the main path (same model, teachers and batch): one
     warm-up and two timed steps with no remat and under each of the seven
     remat policies (bench.py's default is "save_gate"), each printing step
     ms, peak GiB and its B1-B4 launches (B1 once per layer, twice where the
     recompute runs the flash forward again: every policy that does not
     keep "flash_out"; B2/B3 once per layer; B4 48), save_gate's peak below
     no remat's, each exact policy's (all but save_mlp_q8, which changes the
     forward and cuts the gradient at its int8 cast, as in JAX) loss within
     1e-3 and gradient cosine >= 0.999 of no remat's at B1, and one
     save_gate step profiled. Then `trainer.train` (save_gate,
     grad_accum_steps 2, 4 steps, a checkpoint every 2) with its launches
     per step checked, restarted from its step-2 checkpoint to step 4: the
     resumed steps' losses within 1e-5 (relative) of the uninterrupted
     run's; examples/s and MFU (`train_step_flops` + `teacher_flops` against
     989 TFLOP/s; `mfu_pt` without the frozen decoder's weight gradients,
     which JAX's count includes). One step at B8 (the chunked
     cross-entropy): loss within 1e-3 and gradient cosine >= 0.999 of the
     full f32 logits'. Two updates
     at B1 with f32 master weights: every trainable equals its master
     rounded to its dtype;
  9. engine path: the continuous-batching `Engine` at bench_engine.py's
     defaults (8 slots, max_len 1536, decode quantum 8, admission groups of
     8 with a deferral of 4, prompt bucket 128; int8 KV + w8a16; phase 4's
     decoder, which phases 7-8 leave frozen) serves bench_engine.py's 32
     requests (13 system ids, one image, 16-63 text tokens, 8-127 new tokens
     from np.random.default_rng(0)) after a warm-up, twice, in turns with
     the batch loop (bench_engine.py measurement 2: a Generator per batch of
     8, each batch decoding to its longest request): engine, loop, loop,
     engine. Each engine run: every request gets exactly its max_new_tokens
     (no EOS is set), no slot stays occupied, one host sync per quantum (the
     engine's count, and torch's sync-debug warnings raised inside the
     engine, counted by call stack),
     B1 32 times per prefill dispatch; requests/s, tokens/s, time to the
     first token (its arrival on the host), ms per engine step. One engine
     step with every slot busy and one decode chunk of the loop profiled.
     The engine's prefill logits with the kernels within 0.05 x max|logits|
     of use_kernel=False. On a one-slot bf16 engine: a prefix
     handle + a 40-token suffix, and a prefill in chunks of 256, each
     against the full prompt's prefill within 0.05 x max|logits|. The
     speculative engine (spec_k 4, spec_quantum 4) on 8 requests, its token
     agreement with the plain engine printed (bf16 GEMMs of other shapes
     round otherwise: not bounded); `SpeculativeDecoder` (Phi3's decoder as
     target, its first 4 blocks with the same embedding, norm and head as
     draft) and `BeamSearchDecoder` (4 beams) on one 128-token prompt, 32
     tokens; an int4 engine run (phase 6's AWQ calibration) on 8 requests
     with B5 at 225 launches per decoder forward. B6 must stay at 0 over
     phases 4-10;
 10. user API path (visper_lm_tpu_torch/api.py) at Llama-3-8B + CLIP-ViT-L/14-336
     (llama3_clip_vlm with distillation heads, bf16, full width and depth,
     seeded random weights made on the card; phases 4-9's model released
     first) with a whitespace tokenizer defined here (the card has no
     `transformers`): B1 and B5 at Llama-3's shapes against their plain
     versions (B1: B8 at the chat batch's padded length, GQA 32/8 H128, its
     left pads, SDPA with enable_gqa as the yardstick; B5: gate/up 4096 ->
     14336 and down 14336 -> 4096 at M = 8 and M = 8 x the padded length),
     as in phase 3; `export_vlm` -> `import_vlm` in memory, every tensor
     bit-equal; `VisperModel.chat` of 8 questions over 8 seeded uint8 images
     of mixed sizes (LLaVA-1.5's "pad" aspect; "square" once in bf16), 32
     new tokens, in bf16, at the default quantization (bf16 too: JAX
     quantizes by itself only on a TPU; its answers must equal the bf16
     row's), at int8 KV + w8a16 and at int8 KV + int4 (explicit flags): B1
     32 per prefill, B5 225 per forward at int4 and 0 otherwise, first-token
     logits with the kernels within 0.05 x max|logits| of the plain path
     (the share printed), prefill ms, decode ms/token, tokens/s and peak
     GiB, the bf16 prefill and decode chunk profiled; `serve` of the same
     questions at int8 KV + w8a16 (its B1 launches a multiple of 32; each
     request's engine prefill logits within 0.05 x max|logits| of chat's
     Generator row); a `ChatSession` (int8 KV + w8a16) of three turns whose
     turns 2-3 prefill only their own tokens (the engine's `prefill_tokens`);
     `save_hf_checkpoint` -> `from_hf_checkpoint` at full width and 2 layers
     through the repo's tmp/ (removed after), tensors bit-equal, and a
     LLaVA-style config.json without "visper_config" giving the same config
     through `config_from_hf_json`; Vicuna-7B at full width and 4 layers:
     one chat of 2 questions under the vicuna_v1 template.
 11. vision path at Llama-3-8B, reusing phase 10's decoder (the tower
     swapped, not the model made again): the ConvNeXt-XXL trunk at 768 px
     (`with_convnext_tower(llama3_clip_vlm(distill=True))`, 843 M params in
     bf16, every block's gamma from N(0, 0.1^2)) on the chat's 8 images:
     output (8, 576, 3072), finite, relative Frobenius error against an f32
     copy of the same weights <= 2e-2, its time; `chat` through it (bf16,
     32 new tokens; B1 32, first-token logits within 0.05 x max|logits| of
     the plain path); an anyres chat (CLIP-L, spatial_unpad, JAX's
     grid_pinpoints) of 4 images whose sizes select four grids (3, 3, 5
     and 4 tiles: the tiles padded to 5, the newline indices moved), the
     same checks; B1 at both chats' prefill shapes against its plain
     version as in phase 3; one S2 call (`clip_tower_features_s2`, CLIP-L,
     batch 2, scales 336 and 1008): (2, 576, 2048), finite; then, with the
     Llama-3 model released, one PT step of bench.py's --tower convnext
     cell (Phi3-mini, config #1, B4 x T1024, the teachers, save_gate): B1
     64, B2/B3 32, B4 48, loss and every trainable gradient finite, the
     frozen trunk without a gradient and unchanged. Every record carries the
     card's name and power limit.
 12. training from the recipes (phases 10-11's Llama-3-8B released first):
     a seeded dataset in the repo's tmp/ (removed after): 16
     LLaVA-Pretrain-style records (<image> + a question, a 20-60-word
     answer) and 16 IFT-style multi-turn ones (a quarter text-only) over 16
     PNG images of phase 10's sizes written with the port's PNG writer; the
     host pipeline timed per PT batch (decode, tower pixels, teacher_batch
     through the native library, whose g++ build is timed). (a) PT at
     Llama-3-8B + CLIP-L from recipes/pretrain.args through `cli.main`
     (fake-whitespace tokenizer, B4, 3 steps, a checkpoint at step 2, the
     teachers seeded with the CLI's WARNING): B1 64 (full remat), B2/B3 32,
     B4 48 per step; finite losses, 3 metrics rows; every frozen weight
     bit-equal to a fresh seed-0 init and the trainables moved; one step
     profiled; a second `cli.main` resumed from the step-2 checkpoint gives
     step 3's loss within 1e-5. (b) IFT at Phi3-mini from
     recipes/finetune.args with --init-from a seeded Phi3-mini + CLIP-L
     checkpoint written by `save_hf_checkpoint` (save_gate, B4, 3 steps;
     the run's final 38 GB checkpoint of weights and f32 moments is
     recorded, not written): the whole decoder trains, the tower stays the
     checkpoint's bit for bit, B1 64 and B2/B3 32 per step, peak GiB; layer
     16's seven weight gradients with the kernels against use_kernel=False
     (cosine >= 0.999, relative Frobenius printed) and both against the
     plain path on an f32 copy of the weights: the kernels' relative
     Frobenius distance from f32 at most 1e-2 above the plain bf16 path's
     (itself 1-2.4 % at full depth). (c) bench.py's --stage
     lora (r 64, alpha 16, all seven targets) and --stage vision_tower
     configurations on (b)'s model: 3 `trainer.train` steps each at B4 on
     the IFT data: LoRA's B zero at the start (the first loss equals the
     base model's bit for bit), the base decoder bit-unchanged by both, the
     adapters, projector and tower moved where their stage trains them.

The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Needs no network; builds into
visper_lm_tpu_torch/_build/.
"""

from __future__ import annotations

import collections
import copy
import ctypes
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 SIMT
L2_BYTES = 50e6                # H100: a rotation of weights must exceed it to find them cold

BATCH, PROMPT_LEN, NEW_TOKENS = 8, 768, 32
TEXT_LENS = (155, 140, 121, 96, 77, 50, 31, 12)   # 13 sys + 600 image/task + text <= 768
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 3    # bench.py's config #1 cell
# None: no remat, then every JAX policy (save_gate: bench.py's default)
REMAT_RUNS = (None, "none", "save_gate", "save_gate_flash", "save_flash", "save_mlp",
              "save_qkv_mlp", "save_mlp_q8")
REMAT_EXACT = REMAT_RUNS[1:-1]             # save_mlp_q8 changes the forward and its gradient
REMAT_STEPS = 2                            # timed steps per policy, after one warm-up
TRAINER_STEPS, TRAINER_ACCUM = 4, 2
SWIN_STAGES = ((512, 6), (128, 12), (32, 24), (8, 48))  # Swin-L at 768 px, micro-batch 2: (W, heads)
# bench_engine.py's defaults (int8 KV + w8a16 on top of these)
ENGINE = dict(num_slots=8, max_len=1536, decode_quantum=8, admit_group=8, admit_defer=4,
              prompt_bucket=128)
ENGINE_REQUESTS = 32
ENGINE_CHUNK = 256             # the chunked-prefill check's prefill_chunk
# phase 10: Llama-3-8B + CLIP-L through the user API
LLAMA3_KEYS = ("shape", "kernel", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
CHAT_IMAGES = ((480, 640), (336, 336), (768, 1024), (900, 200), (200, 900), (640, 480),
               (1024, 1024), (337, 509))                       # (H, W), uint8, seeded
CHAT_WORDS = (60, 44, 31, 75, 20, 52, 9, 68)                   # question lengths
LLAMA3_SPECIALS = {"<|begin_of_text|>": 128000, "<|start_header_id|>": 128006,
                   "<|end_header_id|>": 128007, "<|eot_id|>": 128009, "\n": 198}
VICUNA_SPECIALS = {"<s>": 1, "</s>": 2, "\n": 13}
FILE_LAYERS = 2                # the safetensors file round trip's depth (full width)
VICUNA_LAYERS = 4              # Vicuna-7B at full width, cut in depth
# phase 11: anyres images (H, W) that select the grids 672x336, 336x672,
# 672x672 and 336x1008 of JAX's grid_pinpoints: base + 2, 2, 4, 3 tiles
ANYRES_IMAGES = ((500, 1000), (1000, 500), (900, 900), (1200, 400))
ANYRES_TILES = (3, 3, 5, 4)
# phase 12: training from the recipes
RECIPE_RECORDS, RECIPE_BATCH, RECIPE_STEPS = 16, 4, 3
RECIPE_GRAD_LAYER = 16          # the IFT layer whose weight gradients are held to the plain path


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters launches (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, reps: int) -> float:
    """Mean device time per call of the calls in fns, captured `reps` times
    over into one CUDA graph and replayed: no host time between launches."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        for fn in fns:
            fn()                                # warm-up on the capture stream
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def environment(build) -> str:
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    if importlib.util.find_spec("triton") is not None:
        import triton

        print(f"triton {triton.__version__}")
    else:
        print("triton not installed")
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    print("nvcc " + [ln for ln in nvcc.splitlines() if "release" in ln][0].strip())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    return smi


def main_path_batch(cfg):
    from visper_lm_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from visper_lm_tpu_torch.data.collate import build_splice_plan
    from visper_lm_tpu_torch.serve.generate import left_pad_plans

    rng = np.random.default_rng(0)
    vocab = cfg.decoder.vocab_size
    sys_ids = rng.integers(3, vocab, size=cfg.num_sys_tokens).tolist()
    plans = []
    for n in TEXT_LENS:
        ids = sys_ids + [IMAGE_TOKEN_INDEX] + rng.integers(3, vocab, size=n).tolist()
        plans.append(build_splice_plan(
            ids, None, PROMPT_LEN, num_image_tokens=cfg.num_image_tokens,
            num_task_tokens=cfg.distill.num_task_tokens,
            num_tasks=len(cfg.distill.task_order()),
        ))
    batch = left_pad_plans(plans, PROMPT_LEN)
    side = cfg.vision.image_size
    batch["images"] = rng.standard_normal((BATCH, side, side, 3)).astype(np.float32)
    return batch


def attention_pairs(b, t, causal, starts, lens) -> int:
    """Unmasked (query row, key) pairs per head this data needs: keys in
    [start, length) and, when causal, at or before the row."""
    rows = torch.arange(t)
    pairs = 0
    for i in range(b):
        hi = torch.clamp(rows + 1, max=lens[i]) if causal else torch.full((t,), lens[i])
        pairs += int(torch.clamp(hi - starts[i], min=0).sum())
    return pairs


def attention_flops(b, t, nq, h, causal, starts, lens) -> float:
    """Forward FLOPs this data needs: 4*H per unmasked pair and head (q.k, p.v)."""
    return 4.0 * h * nq * attention_pairs(b, t, causal, starts, lens)


def bound(nbytes: float, flops: float, dtype) -> dict:
    """The least time: bytes over the memory rate vs FLOPs over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def kernel_case(name, b, t, nq, nkv, h, dtype, causal, starts, lens, gen, fa, old=False):
    """Kernel vs plain version on one case; returns the measured record. With
    `old`, the mma.sync kernel is checked and timed beside the wgmma one."""
    dev = "cuda"
    q = torch.randn(b, t, nq, h, device=dev, generator=gen).to(dtype)
    k = torch.randn(b, t, nkv, h, device=dev, generator=gen).to(dtype)
    v = torch.randn(b, t, nkv, h, device=dev, generator=gen).to(dtype)
    st = torch.tensor(starts, device=dev)
    ln = torch.tensor(lens, device=dev)
    kw = dict(causal=causal, kv_starts=st, kv_lengths=ln)

    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref, lse_ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    err = lse_err = 0.0
    for i in range(b):
        if starts[i] >= lens[i]:
            continue
        lo = starts[i] if causal else 0  # rows with at least one valid key
        err = max(err, (out[i, lo:].float() - ref[i, lo:]).abs().max().item())
        lse_err = max(lse_err, (lse[i, :, lo:] - lse_ref[i, :, lo:]).abs().max().item())
        if causal and lo > 0:
            check(bool(torch.all(out[i, :lo] == 0)), f"{name}: pad rows not zero")
            check(bool(torch.all(lse[i, :, :lo] == fa.NEG_INF)), f"{name}: pad lse not NEG_INF")
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    check(err <= tol, f"{name}: kernel vs plain max abs err {err} > {tol}")
    check(lse_err <= 1e-3, f"{name}: lse max abs err {lse_err} > 1e-3")

    def new_fn():
        return fa.flash_attention_fwd(q, k, v, **kw)

    def old_fn():
        return fa.flash_attention_fwd(q, k, v, kernel="mma_sync", **kw)

    extra = {}
    if old:
        out_o, lse_o = old_fn()
        torch.cuda.synchronize()
        err_o = max((out_o[i, (starts[i] if causal else 0):].float()
                     - ref[i, (starts[i] if causal else 0):]).abs().max().item()
                    for i in range(b) if starts[i] < lens[i])
        check(err_o <= tol, f"{name}: mma.sync kernel vs plain max abs err {err_o} > {tol}")
        old_a = cuda_ms(old_fn, 20)             # in turns: old, new, new, old
        ms = 0.5 * (cuda_ms(new_fn, 20) + cuda_ms(new_fn, 20))
        extra = dict(mma_sync_ms=0.5 * (old_a + cuda_ms(old_fn, 20)), mma_sync_max_abs_err=err_o)
    else:
        ms = cuda_ms(new_fn, 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, **kw), 3)
    cols = torch.arange(t, device=dev)
    mask = (cols[None, :] >= st[:, None]) & (cols[None, :] < ln[:, None])
    mask = mask[:, None, None, :]
    if causal:
        mask = mask & (cols[:, None] >= cols[None, :])[None, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=nq != nkv),
        20,
    )
    # least time: q, k, v read once, out and lse written once, vs this data's FLOPs
    flops = attention_flops(b, t, nq, h, causal, starts, lens)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + lse.numel() * 4
    rec = dict(
        case=name, shape=f"B{b} T{t} {nq}/{nkv} H{h} {str(dtype)[6:]} "
        f"{'causal' if causal else 'noncausal'}",
        kernel=fa.flash_fwd_kernel_for(dtype, h, t, causal), **extra,
        max_abs_err=err, lse_max_abs_err=lse_err, tol=tol, ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, **bound(nbytes, flops, dtype),
        tflops=flops / ms * 1e-9, gbytes_s=nbytes / ms * 1e-6,
    )
    print("kernel_case " + json.dumps(rec))
    return rec


def bwd_case(name, b, t, nq, nkv, h, causal, starts, lens, gen, fa):
    """B2 (dq) and B3 (dk/dv) vs the plain backward in f32 on one bf16 case;
    returns the two measured records."""
    dev, dtype = "cuda", torch.bfloat16
    q, k, v = (torch.randn(b, t, n, h, device=dev, generator=gen).to(dtype) for n in (nq, nkv, nkv))
    dout = torch.randn(b, t, nq, h, device=dev, generator=gen).to(dtype)
    kw = dict(causal=causal, kv_starts=torch.tensor(starts, device=dev),
              kv_lengths=torch.tensor(lens, device=dev))
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    # the reference shares nothing with the kernels: its out and lse come
    # from the plain forward in f32
    qf, kf, vf = q.float(), k.float(), v.float()
    out_ref, lse_ref = fa.flash_attention_reference(qf, kf, vf, **kw)
    ref = fa.flash_attention_bwd_reference(qf, kf, vf, out_ref, lse_ref, dout.float(), **kw)
    del qf, kf, vf, out_ref, lse_ref
    err, mag, fro = {}, {}, {}
    dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    torch.cuda.synchronize()
    for gname, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        e = (got.float() - r).abs()
        err[gname] = e.max().item()
        mag[gname] = r.abs().max().item()
        fro[gname] = (e.norm() / r.norm()).item()
        excess = (e - (2e-2 + 1e-2 * r.abs())).max().item()
        print(f"bwd_case {name} {gname}: max abs err {err[gname]:.4g}, max |ref| "
              f"{mag[gname]:.4g}, relative Frobenius err {fro[gname]:.4g}")
        check(fro[gname] <= 1e-2, f"{name}: {gname} relative Frobenius err {fro[gname]} > 1e-2")
        check(excess <= 0, f"{name}: {gname} exceeds 2e-2 + 1e-2 x |ref| by {excess}")
    # every element is written once by one CTA: the same launch gives the same bytes
    for _ in range(20):
        check(torch.equal(fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw), dq),
              f"{name}: a repeated dq launch gave other bytes")
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
        check(torch.equal(dk2, dk) and torch.equal(dv2, dv),
              f"{name}: a repeated dk/dv launch gave other bytes")
    del dq, dk, dv, ref

    def dq_fn():
        return fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)

    def dkv_fn():
        return fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)

    ms_dq, ms_dkv = cuda_ms(dq_fn, 10), cuda_ms(dkv_fn, 10)
    # the same launches as CUDA graphs: device time without the host between them
    device = {kname: graph_ms([fn], 10) for kname, fn in (("dq", dq_fn), ("dkv", dkv_fn))}
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, dout, **kw), 2)
    # yardstick: SDPA's backward with a boolean mask (dq, dk and dv in one call)
    cols = torch.arange(t, device=dev)
    mask = (cols[None, :] >= kw["kv_starts"][:, None]) & (cols[None, :] < kw["kv_lengths"][:, None])
    mask = mask[:, None, None, :]
    if causal:
        mask = mask & (cols[:, None] >= cols[None, :])[None, None]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=nq != nkv)
    go = dout.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), go, retain_graph=True), 10)
    del o
    # least time: inputs read once (q, k, v, dout, lse, delta), outputs written once,
    # vs 2*H FLOPs per product and unmasked pair: dq 3 products, dk/dv 4
    pairs = attention_pairs(b, t, causal, starts, lens) * nq
    e = q.element_size()
    in_bytes = (q.numel() + k.numel() + v.numel() + dout.numel()) * e + 2 * lse.numel() * 4
    shape = f"B{b} T{t} {nq}/{nkv} H{h} bf16 {'causal' if causal else 'noncausal'}"
    recs = []
    for kname, ms, nbytes, flops, errs in (
        ("dq", ms_dq, in_bytes + q.numel() * e, 6.0 * h * pairs, ("dq",)),
        ("dkv", ms_dkv, in_bytes + (k.numel() + v.numel()) * e, 8.0 * h * pairs, ("dk", "dv")),
    ):
        rec = dict(
            case=f"{name}_{kname}", shape=shape,
            kernel=fa.flash_bwd_kernel_for(dtype, h, t, t), max_abs_err=max(err[x] for x in errs),
            max_abs_ref=max(mag[x] for x in errs), rel_fro_err=max(fro[x] for x in errs),
            tol="rel Frobenius 1e-2, |err| <= 2e-2 + 1e-2 x |ref|", ms=ms,
            device_ms=device[kname], plain_ms=plain_ms, library_ms=library_ms,
            **bound(nbytes, flops, dtype), tflops=flops / ms * 1e-9,
        )
        print("kernel_case " + json.dumps(rec))
        recs.append(rec)
    return recs


def window_case(stage, w, heads, shifted, gen, wa, swin):
    """B4 vs its plain version at one Swin-L stage shape (N 144, D 32, bf16),
    q/k/v as the strided views of a packed projection the Swin block passes:
    within 2e-2 of the plain version, the same launch 20 times the same
    bytes. The kernel and SDPA are timed as CUDA graphs (a stage-3 or
    stage-4 launch is shorter than its host time), in turns: new, SDPA,
    SDPA, new."""
    dev, n, d, ws = "cuda", 144, 32, 12
    nw = w // 2                                  # windows per image (micro-batch 2)
    qkv = torch.randn(w, n, 3, heads, d, device=dev, generator=gen).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bias = torch.randn(heads, n, n, device=dev, generator=gen)
    mask = None
    if shifted:
        side = int(round(nw ** 0.5)) * ws
        mask = torch.as_tensor(swin._shift_attn_mask(side, side, ws, ws // 2), device=dev)
    scale = d ** -0.5
    name = f"window_stage{stage + 1}{'_shifted' if shifted else ''}"
    kernel = wa.window_attn_kernel_for(n, d)

    def new_fn():
        return wa.window_attention_kernel(q, k, v, bias, mask, scale)

    out = new_fn()
    ref = wa.window_attention_plain(q.float(), k.float(), v.float(), bias, mask, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    check(err <= 2e-2, f"{name}: max abs err {err} > 2e-2")
    # every output element is written once by one CTA: the same launch gives the same bytes
    for _ in range(20):
        check(torch.equal(new_fn(), out), f"{name}: a repeated launch gave other bytes")
    del out, ref
    # yardstick: SDPA with the float bias (+ shift mask tiled over the windows)
    attn = bias[None].expand(w, heads, n, n)
    if mask is not None:
        attn = attn + mask.repeat(w // nw, 1, 1)[:, None]
    attn = attn.to(torch.bfloat16).contiguous()

    def lib_fn():
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=attn, scale=scale)

    t_new, t_lib = graph_ms([new_fn], 20), graph_ms([lib_fn], 20)
    t_lib2, t_new2 = graph_ms([lib_fn], 20), graph_ms([new_fn], 20)
    ms = 0.5 * (t_new + t_new2)
    eager_ms = cuda_ms(new_fn, 20)
    plain_ms = cuda_ms(lambda: wa.window_attention_plain(q, k, v, bias, mask, scale), 3)
    nbytes = 4 * q.numel() * 2 + bias.numel() * 4 + (0 if mask is None else mask.numel() * 4)
    flops = 4.0 * n * n * d * w * heads
    plan = wa.window_attn_plan(w, heads, n, d, nw if shifted else 0,
                               torch.cuda.get_device_properties(0).multi_processor_count)
    rec = dict(
        case=name, shape=f"W{w} heads{heads} N{n} D{d} bf16", kernel=kernel,
        plan=plan._asdict(), max_abs_err=err, tol=2e-2, ms=ms, eager_ms=eager_ms,
        plain_ms=plain_ms, library_ms=0.5 * (t_lib + t_lib2),
        library="SDPA, bf16 bias (+ mask) per window", timing="ms, library_ms: CUDA graphs",
        **bound(nbytes, flops, torch.bfloat16), gbytes_s=nbytes / ms * 1e-6,
    )
    print("kernel_case " + json.dumps(rec))
    return rec


def w4_case(name, m, din, dout, gen, qm, param, awq=False, group=128):
    """B5 vs its plain version at one linear's shape: weights drawn as the
    decoder's init (U(+-1/sqrt(din)), bf16) and quantized by the port's int4
    quantizer; with awq, the rows are AWQ-scaled and x takes q4_in_scale first,
    as the linear does."""
    dev = "cuda"
    bound_w = din ** -0.5
    w = ((torch.rand(din, dout, device=dev, generator=gen) * 2 - 1) * bound_w).to(torch.bfloat16)
    rms = torch.rand(din, device=dev, generator=gen) * 4 + 0.05 if awq else None
    qd = param.quantize_linear_int4(w, group, rms)
    pk, sc = qd["weight_q4p"], qd["q4_scale"]
    del w
    x = torch.randn(m, din, device=dev, generator=gen).to(torch.bfloat16)
    if awq:
        x = x * qd["q4_in_scale"].to(x.dtype)
    out = qm.w4_matmul(x, pk, sc, group)
    ref = qm.w4_matmul_reference(x.float(), pk, sc, group)
    torch.cuda.synchronize()
    e = (out.float() - ref).abs()
    err, mag, fro = e.max().item(), ref.abs().max().item(), (e.norm() / ref.norm()).item()
    del ref, e
    check(fro <= 1e-2, f"{name}: relative Frobenius err {fro} > 1e-2")
    check(err <= 2e-2 * mag, f"{name}: max abs err {err} > 2e-2 x {mag}")
    iters = 50 if m <= 16 else 10
    def new_fn():
        return qm.w4_matmul(x, pk, sc, group)

    def old_fn():
        return qm.w4_matmul(x, pk, sc, group, kernel="mma_sync")

    old_a = cuda_ms(old_fn, iters)              # in turns: old, new, new, old
    ms = 0.5 * (cuda_ms(new_fn, iters) + cuda_ms(new_fn, iters))
    mma_sync_ms = 0.5 * (old_a + cuda_ms(old_fn, iters))
    plain_ms = cuda_ms(lambda: qm.w4_matmul_reference(x, pk, sc, group), 2)
    # yardstick: one torch.matmul with the same weight already dequantized to
    # bf16 (four times the weight bytes)
    w_deq = (qm.unpack_int4(pk).to(torch.bfloat16).reshape(-1, group, dout)
             * sc[:, None, :].to(torch.bfloat16)).reshape(din, dout)
    library_ms = cuda_ms(lambda: torch.matmul(x, w_deq), iters)
    small = {}
    if m <= 16:
        # device times without the host between launches, warm and cold in L2
        copies = max(8, -(-3 * int(L2_BYTES) // pk.numel()))
        pks = [pk.clone() for _ in range(copies)]
        scs = [sc.clone() for _ in range(copies)]

        def cold(kern):
            return graph_ms([lambda a=a, b=b: qm.w4_matmul(x, a, b, group, kernel=kern)
                             for a, b in zip(pks, scs)], 2)

        small = dict(device_ms=graph_ms([new_fn], 20), cold_ms=cold(None),
                     mma_sync_device_ms=graph_ms([old_fn], 20), mma_sync_cold_ms=cold("mma_sync"),
                     library_device_ms=graph_ms([lambda: torch.matmul(x, w_deq)], 20))
        del pks, scs
        lib_copies = max(8, -(-3 * int(L2_BYTES) // (2 * w_deq.numel())))
        w_deqs = [w_deq.clone() for _ in range(lib_copies)]
        small["library_cold_ms"] = graph_ms([lambda w=w: torch.matmul(x, w) for w in w_deqs], 2)
        small["cold_copies"] = copies
        del w_deqs
        # the split-K sum runs in a fixed order: the same launch gives the same bytes
        first = new_fn()
        for _ in range(20):
            check(torch.equal(new_fn(), first), f"{name}: a repeated launch gave other bytes")
    del w_deq
    # least time: x, packed, scales read once, out written once, vs 2 M din dout
    nbytes = x.numel() * 2 + pk.numel() + sc.numel() * 4 + m * dout * 2
    flops = 2.0 * m * din * dout
    rec = dict(
        case=name, shape=f"M{m} din{din} dout{dout} group{group}{' awq' if awq else ''}",
        kernel=qm.w4_kernel_for(m, din, dout, group),
        max_abs_err=err, max_abs_ref=mag, rel_fro_err=fro,
        tol="rel Frobenius 1e-2, max abs 2e-2 x max|ref|", ms=ms, mma_sync_ms=mma_sync_ms,
        plain_ms=plain_ms, library_ms=library_ms,
        library="torch.matmul on the bf16-dequantized weight", **small,
        **bound(nbytes, flops, torch.bfloat16), tflops=flops / ms * 1e-9,
        gbytes_s=nbytes / small.get("cold_ms", ms) * 1e-6,
    )
    print("kernel_case " + json.dumps(rec))
    return rec


def decode_case(name, b, nq, nkv, h, s, quant, starts, lens, gen, da, quantize_head_vectors):
    """B6 vs its plain version on one single-token case: q (B, 1, Nq, H) bf16,
    a head-major (B, Nkv, S, H) cache in bf16 or int8 + per-vector scales."""
    dev = "cuda"
    q = torch.randn(b, 1, nq, h, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(b, nkv, s, h, device=dev, generator=gen)
    v = torch.randn(b, nkv, s, h, device=dev, generator=gen)
    if quant:
        (k, ks), (v, vs) = quantize_head_vectors(k), quantize_head_vectors(v)
        ks, vs = ks[..., 0], vs[..., 0]
        kd, vd = (k.float() * ks[..., None]).to(q.dtype), (v.float() * vs[..., None]).to(q.dtype)
    else:
        k, v, ks, vs = k.to(q.dtype), v.to(q.dtype), None, None
        kd, vd = k, v
    st = torch.tensor(starts, device=dev)
    ln = torch.tensor(lens, device=dev)
    kw = dict(kv_lengths=ln, kv_starts=st)
    ref = da.decode_attention_reference(q.float(), k, v, ks, vs, **kw)
    live = [i for i in range(b) if starts[i] < lens[i]]
    errs = {}
    for kern in ("split", "serial"):
        out = da.decode_attention(q, k, v, ks, vs, kernel=kern, **kw)
        torch.cuda.synchronize()
        e = out[live].float() - ref[live]
        errs[kern] = (e.abs().max().item(), (e.norm() / ref[live].norm()).item())
        check(errs[kern][1] <= 1e-2, f"{name}: {kern} relative Frobenius err {errs[kern][1]} > 1e-2")
        check(errs[kern][0] <= 5e-3, f"{name}: {kern} max abs err {errs[kern][0]} > 5e-3")
        for i in set(range(b)) - set(live):
            check(bool(torch.all(out[i] == 0)), f"{name}: {kern}: fully masked row {i} is not 0")
    err, fro = errs["split"]

    def new_fn():
        return da.decode_attention(q, k, v, ks, vs, **kw)

    # the splits merge in split order: the same launch gives the same bytes
    first = new_fn()
    for _ in range(20):
        check(torch.equal(new_fn(), first), f"{name}: a repeated launch gave other bytes")
    eager_ms = cuda_ms(new_fn, 100)
    plain_ms = cuda_ms(lambda: da.decode_attention_reference(q, k, v, ks, vs, **kw), 5)
    # yardstick: SDPA with a boolean mask over the bf16 (or dequantized) cache
    cols = torch.arange(s, device=dev)
    mask = ((cols[None, :] >= st[:, None]) & (cols[None, :] < ln[:, None]))[:, None, None, :]
    qt = q.transpose(1, 2)

    def sdpa(kc, vc):
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kc, vc, attn_mask=mask, enable_gqa=nq != nkv)

    # device times without the host between launches: warm (one cache) and
    # cold (in turn over copies that together exceed the L2), in turns:
    # serial, split, library, library, split, serial
    cache_bytes = 2 * k.numel() * k.element_size() + (2 * ks.numel() * 4 if quant else 0)
    copies = max(2, -(-3 * int(L2_BYTES) // cache_bytes))
    caches = [tuple(None if x is None else x.clone() for x in (k, v, ks, vs)) for _ in range(copies)]
    lib_copies = max(2, -(-3 * int(L2_BYTES) // (2 * kd.numel() * 2)))
    libs = [(kd.clone(), vd.clone()) for _ in range(lib_copies)]

    def timed(kern):
        warm = graph_ms([lambda: da.decode_attention(q, k, v, ks, vs, kernel=kern, **kw)], 20)
        cold = graph_ms([lambda c=c: da.decode_attention(q, *c, kernel=kern, **kw) for c in caches], 4)
        return warm, cold

    def timed_lib():
        return (graph_ms([lambda: sdpa(kd, vd)], 20),
                graph_ms([lambda c=c: sdpa(*c) for c in libs], 4))

    t_old, t_new, t_lib = timed("serial"), timed("split"), timed_lib()
    t_lib2, t_new2, t_old2 = timed_lib(), timed("split"), timed("serial")
    del caches, libs
    device_ms, cold_ms = 0.5 * (t_new[0] + t_new2[0]), 0.5 * (t_new[1] + t_new2[1])
    # least time: q read, out written, and the cache rows (and scales) of the
    # valid positions read once, which is all this data needs; 4H FLOPs per
    # query head and valid position
    valid = sum(max(min(lens[i], s) - max(starts[i], 0), 0) for i in range(b))
    nbytes = 2 * q.numel() * 2 + valid * nkv * h * k.element_size() * 2
    nbytes += valid * nkv * 8 if quant else 0
    flops = 4.0 * h * nq * valid
    span, splits, rnd = da.decode_split_plan(b, nkv, s, h, k.element_size())
    rec = dict(
        case=name, shape=f"B{b} {nq}/{nkv} H{h} S{s} {'int8' if quant else 'bf16'} cache",
        plan=dict(span=span, splits=splits, round=rnd, ctas=b * nkv * splits,
                  dynamic_smem_bytes=da.decode_split_smem_bytes(rnd, h, k.element_size(), nq // nkv)),
        max_abs_err=err, max_abs_ref=ref[live].abs().max().item(), rel_fro_err=fro,
        serial_max_abs_err=errs["serial"][0],
        tol="rel Frobenius 1e-2, max abs 5e-3", ms=cold_ms, cold_ms=cold_ms, device_ms=device_ms,
        eager_ms=eager_ms, serial_cold_ms=0.5 * (t_old[1] + t_old2[1]),
        serial_device_ms=0.5 * (t_old[0] + t_old2[0]), plain_ms=plain_ms,
        library_ms=0.5 * (t_lib[1] + t_lib2[1]), library_device_ms=0.5 * (t_lib[0] + t_lib2[0]),
        library="SDPA, boolean mask, bf16 (dequantized) cache", cold_copies=copies,
        **bound(nbytes, flops, torch.bfloat16), gbytes_s=nbytes / cold_ms * 1e-6,
    )
    print("kernel_case " + json.dumps(rec))
    return rec


def timed_generate(generator, batch, gen_cfg, batch_size: int = BATCH):
    """Prefill and generate timed warm (host clock around work that ends in a
    synchronise), as phase 4 does."""
    t0 = time.perf_counter()
    generator.prefill(batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    generator.generate(batch)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    steps = -(-NEW_TOKENS // gen_cfg.decode_chunk) * gen_cfg.decode_chunk
    return dict(
        prefill_ms=prefill_s * 1e3, decode_ms_per_token=(gen_s - prefill_s) / steps * 1e3,
        generate_s=gen_s, tokens_per_s=batch_size * NEW_TOKENS / gen_s, decode_steps=steps,
    )


def train_batch(cfg, batch_size: int, seq_len: int, seed: int = 0):
    """bench.py's PT batch (`build_batch` + `add_teacher_inputs`), in numpy
    from the same seeds (seed 0; another seed gives another batch of the
    same kind): right-padded splice plans, images, per-task masks, and the
    three teachers' pixel tensors."""
    from visper_lm_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from visper_lm_tpu_torch.data.collate import build_splice_plan, collate_plans

    rng = np.random.default_rng(seed)
    vocab, ns = cfg.decoder.vocab_size, cfg.num_sys_tokens
    plans = []
    for _ in range(batch_size):
        text_len = int(rng.integers(24, 48))
        ids = (list(rng.integers(3, vocab - 10, size=ns)) + [IMAGE_TOKEN_INDEX]
               + list(rng.integers(3, vocab - 10, size=text_len)))
        labels = [IGNORE_INDEX] * (ns + 1) + ids[ns + 1:]
        plans.append(build_splice_plan(
            ids, labels, seq_len, num_image_tokens=cfg.num_image_tokens,
            num_task_tokens=cfg.distill.num_task_tokens,
            num_tasks=len(cfg.distill.task_order()),
        ))
    side = cfg.convnext.image_size if cfg.use_convnext_tower else cfg.vision.image_size
    img = rng.normal(size=(batch_size, side, side, 3))
    batch = collate_plans(plans, images=img.astype(np.float32))
    for tcfg in cfg.distill.tasks:
        batch[f"{tcfg.task}_mask"] = np.ones((batch_size,), np.float32)
    rng = np.random.default_rng(seed + 1)
    for key, size in (("depth_images", 336), ("gen_images", 224), ("seg_images", 768)):
        batch[key] = rng.normal(size=(batch_size, size, size, 3)).astype(np.float32)
    return batch


def profile_window(name: str, fn, top: int = 10, match=()) -> dict:
    """Device time of one call of fn by kernel (torch.profiler), and the
    device's idle share of the same call's wall time timed without the
    profiler (the profiler slows the host). For each string in `match`, also
    the device time and launches of the kernels whose name contains it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profile {name}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / wall_us:.3f}, {sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"profile {name}:   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:100]}")
    out = dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3, idle_share=1 - busy_us / wall_us,
               kernels=sum(e.count for e in kernels))
    for key in match:
        hit = [e for e in kernels if key in e.key]
        out[key] = dict(ms=sum(e.self_device_time_total for e in hit) / 1e3,
                        launches=sum(e.count for e in hit))
        print(f"profile {name}: kernels matching '{key}': {out[key]['ms']:.3f} ms "
              f"in {out[key]['launches']} launches")
    return out


def loss_and_grads(loss_fn, model, batch, teachers, params):
    """One forward and backward without an update: (loss, grads of params)."""
    total, _ = loss_fn(model, batch, teachers)
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return float(total.detach()), grads


def grad_agreement(names, grads_a, grads_b):
    """(min cosine, its tensor, tensors compared) over the gradients that are
    not zero on both sides."""
    min_cos, min_name, n_cmp = 1.0, None, 0
    for n, ga, gb in zip(names, grads_a, grads_b):
        if ga is None or gb is None:
            continue
        ga, gb = ga.float().flatten(), gb.float().flatten()
        if gb.norm() == 0 and ga.norm() == 0:
            continue
        cos = float(ga @ gb / (ga.norm() * gb.norm()).clamp(min=1e-30))
        n_cmp += 1
        if cos < min_cos:
            min_cos, min_name = cos, n
    return min_cos, min_name, n_cmp


def trainer_phase(cfg, model, teachers, tbatch, reset_counts, counts):
    """Phase 8: remat policies at B4 x T1024, trainer.train with accumulation,
    a checkpoint and a resume, the chunked cross-entropy at B8, master
    weights at B1. Returns the record printed as `trainer_path`."""
    import dataclasses
    import os
    import shutil

    from visper_lm_tpu_torch.models.decoder import REMAT_POLICIES
    from visper_lm_tpu_torch.models.teachers import make_teacher_fn
    from visper_lm_tpu_torch.train.optimizer import OptimizerConfig
    from visper_lm_tpu_torch.train import train_step as train_step_mod
    from visper_lm_tpu_torch.train.train_step import make_loss_fn, make_train_step, uses_chunked_ce
    from visper_lm_tpu_torch.train.trainer import TrainerConfig, train
    from visper_lm_tpu_torch.utils.diagnostics import decoder_params, teacher_flops, train_step_flops

    d = cfg.decoder
    tfn = make_teacher_fn(cfg)
    opt_cfg = OptimizerConfig(learning_rate=1e-3, total_steps=1000, stage="pretrain")
    n_swin = sum(teachers["swin"].cfg.depths)
    out = {}

    def expected(policy, micro_batches=1, batch=TRAIN_BATCH):
        # a launch per decoder layer, and the recompute runs the flash forward
        # again unless the policy keeps its output; B4 once per Swin block and
        # teacher micro-batch of 2
        fwd = 1 if policy is None or "flash_out" in REMAT_POLICIES[policy] else 2
        per = dict(flash_fwd=fwd * d.num_layers, flash_bwd_dq=d.num_layers,
                   flash_bwd_dkv=d.num_layers, window_attn=n_swin * batch // 2)
        return {k: v * micro_batches for k, v in per.items()}

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    # remat: no remat (phase 7's step), full remat, save_gate; at B4 x T1024
    remat = {}
    for policy in REMAT_RUNS:
        name = policy or "no_remat"
        step = make_train_step(cfg, opt_cfg, model, teacher_fn=tfn, teacher_params=teachers,
                               remat=policy is not None, remat_policy=policy)
        step(tbatch)                            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for i in range(REMAT_STEPS):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(tbatch)              # ends in a host read of the metrics
            ms.append((time.perf_counter() - t0) * 1e3)
            c = counts()
            check(c == expected(policy), f"remat {name} step {i + 2}: launches {c}, expected "
                  f"{expected(policy)}")
            check(math.isfinite(metrics["loss"]), f"remat {name}: loss {metrics['loss']}")
        remat[name] = dict(step_ms=ms, mean_step_ms=sum(ms) / len(ms),
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=c,
                           loss=metrics["loss"])
        print(f"remat {name}: {json.dumps(remat[name])}")
        if policy == "save_gate":               # a profile costs seconds: bench.py's default only
            prof = profile_window("train_step_save_gate", lambda: step(tbatch), top=15,
                                  match=("flash_fwd", "flash_bwd", "window_attn_stream"))
            remat[name].update(busy_ms=prof["busy_ms"], idle_share=prof["idle_share"])
        del step
        release()
    check(remat["save_gate"]["peak_gib"] < remat["no_remat"]["peak_gib"],
          f"save_gate's peak {remat['save_gate']['peak_gib']:.2f} GiB is not below no remat's "
          f"{remat['no_remat']['peak_gib']:.2f}")
    out["remat"] = remat

    # each exact policy's loss and gradients against the no-remat step's, at B1
    b1 = {k: torch.as_tensor(v[:1]).cuda() for k, v in tbatch.items()}
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    params = [p for p in model.parameters() if p.requires_grad]
    ref_loss, ref_grads = loss_and_grads(make_loss_fn(cfg, teacher_fn=tfn, remat=False),
                                         model, b1, teachers, params)
    out["remat_parity"] = {}
    for policy in REMAT_EXACT:
        loss, grads = loss_and_grads(make_loss_fn(cfg, teacher_fn=tfn, remat=True, remat_policy=policy),
                                     model, b1, teachers, params)
        rel = abs(loss - ref_loss) / abs(ref_loss)
        min_cos, min_name, n_cmp = grad_agreement(names, grads, ref_grads)
        out["remat_parity"][policy] = dict(loss=loss, no_remat_loss=ref_loss, rel=rel,
                                           min_grad_cosine=min_cos, tensors=n_cmp)
        print(f"remat {policy} vs no remat at B1: loss {loss:.6f} vs {ref_loss:.6f} (rel "
              f"{rel:.3g}), min grad cosine {min_cos:.6f} ({min_name}) over {n_cmp} tensors")
        check(rel <= 1e-3, f"remat {policy}: loss differs by {rel:.3g} > 1e-3")
        check(min_cos >= 0.999, f"remat {policy}: grad cosine {min_cos} < 0.999 for {min_name}")
        del grads
    del ref_grads
    release()

    # trainer.train: save_gate, accumulation 2, a checkpoint at step 2, then a
    # resume from it to step 4
    root = Path(__file__).resolve().parent / "tmp" / "chip_smoke_trainer"
    shutil.rmtree(root, ignore_errors=True)
    requested = []

    def data_iter(epoch, skip_batches=0):
        requested.append((epoch, skip_batches))
        for i in range(skip_batches, TRAINER_STEPS * TRAINER_ACCUM):
            yield train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=100 + 2 * i)

    def records(run):
        with open(root / run / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    per_step = expected("save_gate", TRAINER_ACCUM)
    tcfg = TrainerConfig(output_dir=str(root / "full"), max_steps=TRAINER_STEPS, save_steps=2,
                         grad_accum_steps=TRAINER_ACCUM, remat_policy="save_gate", resume=False)
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train(cfg, opt_cfg, tcfg, model, data_iter, teacher_fn=tfn, teacher_params=teachers)
        full_s = time.perf_counter() - t0
        launches = counts()
        want = {k: v * TRAINER_STEPS for k, v in per_step.items()}
        check(state.step == TRAINER_STEPS, f"trainer ran {state.step} steps")
        check(launches == want, f"trainer launches {launches}, expected {want}")
        full = records("full")
        check([r["step"] for r in full] == list(range(1, TRAINER_STEPS + 1)), f"logged {full}")
        del state
        release()
        resume_dir = root / "resume" / "checkpoints"
        resume_dir.mkdir(parents=True)
        shutil.copytree(root / "full" / "checkpoints" / "2", resume_dir / "2", copy_function=os.link)
        requested.clear()
        reset_counts()
        t0 = time.perf_counter()
        state = train(cfg, opt_cfg, dataclasses.replace(tcfg, output_dir=str(root / "resume"),
                                                        resume=True),
                      model, data_iter, teacher_fn=tfn, teacher_params=teachers)
        resume_s = time.perf_counter() - t0
        resumed_launches = counts()
        want = {k: v * (TRAINER_STEPS - 2) for k, v in per_step.items()}
        check(resumed_launches == want, f"resumed launches {resumed_launches}, expected {want}")
        check(requested == [(0, 2 * TRAINER_ACCUM)], f"the resume asked the stream for {requested}")
        resumed = records("resume")
        check([r["step"] for r in resumed] == [3, 4], f"the resume logged {resumed}")
        diffs = {}
        for r in resumed:
            ref = full[r["step"] - 1]["loss"]
            diffs[r["step"]] = abs(r["loss"] - ref) / abs(ref)
            print(f"trainer step {r['step']}: resumed loss {r['loss']:.7f}, uninterrupted "
                  f"{ref:.7f}, relative difference {diffs[r['step']]:.3g}")
            check(diffs[r["step"]] <= 1e-5, f"resumed step {r['step']} loss differs by "
                  f"{diffs[r['step']]:.3g} > 1e-5")
        del state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    release()
    # steps 2 and 4: no checkpoint is written inside their logged intervals
    sps = [full[i]["steps_per_sec"] for i in (1, 3)]
    examples = TRAIN_BATCH * TRAINER_ACCUM
    flops = train_step_flops(cfg, examples, TRAIN_SEQ) + teacher_flops(examples)
    # train_step_flops is JAX's nominal count: 6 P per token for the decoder.
    # In PT the decoder is frozen, so its weight gradients (2 P) never run.
    pt_flops = flops - 2.0 * decoder_params(cfg) * examples * TRAIN_SEQ
    mean_sps = sum(sps) / len(sps)
    out["trainer"] = dict(
        remat_policy="save_gate", grad_accum_steps=TRAINER_ACCUM, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=TRAINER_STEPS, run_s=full_s, resume_run_s=resume_s, losses=[r["loss"] for r in full],
        resumed_losses=[r["loss"] for r in resumed], resumed_rel_diff=diffs,
        step_ms=[1e3 / x for x in sps], examples_per_s=examples * mean_sps,
        mfu=flops * mean_sps / PEAK_FLOPS[torch.bfloat16], flops_per_step=flops,
        mfu_pt=pt_flops * mean_sps / PEAK_FLOPS[torch.bfloat16], pt_flops_per_step=pt_flops,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
        launches_per_step=per_step, resumed_launches=resumed_launches,
    )
    print("trainer " + json.dumps(out["trainer"]))

    # the chunked cross-entropy: one step at B8 x T1024
    b8 = {k: torch.as_tensor(v).cuda() for k, v in train_batch(cfg, 8, TRAIN_SEQ, seed=50).items()}
    check(uses_chunked_ce(cfg, 8, TRAIN_SEQ), "B8 x T1024 does not take the chunked cross-entropy")
    step = make_train_step(cfg, opt_cfg, model, teacher_fn=tfn, teacher_params=teachers,
                           remat_policy="save_gate")
    loss_c, grads_c = loss_and_grads(step.loss_fn, model, b8, teachers, params)
    # the reference: the same loss on the full f32 logits (JAX's switch turned off)
    switch = train_step_mod.uses_chunked_ce
    train_step_mod.uses_chunked_ce = lambda *a: False
    try:
        loss_f, grads_f = loss_and_grads(
            make_loss_fn(cfg, teacher_fn=tfn, remat_policy="save_gate"), model, b8, teachers, params)
    finally:
        train_step_mod.uses_chunked_ce = switch
    rel = abs(loss_c - loss_f) / abs(loss_f)
    min_cos, min_name, n_cmp = grad_agreement(names, grads_c, grads_f)
    del grads_c, grads_f
    release()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    metrics = step(b8)
    b8_ms = (time.perf_counter() - t0) * 1e3
    b8_launches = counts()
    check(b8_launches == expected("save_gate", batch=8),
          f"B8 step launches {b8_launches}, expected {expected('save_gate', batch=8)}")
    out["chunked_ce"] = dict(loss=loss_c, full_logits_loss=loss_f, rel=rel, min_grad_cosine=min_cos,
                             tensors=n_cmp, step_ms=b8_ms, step_loss=metrics["loss"],
                             launches=b8_launches,
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print("chunked_ce " + json.dumps(out["chunked_ce"]))
    check(rel <= 1e-3, f"chunked CE loss differs from the full logits' by {rel:.3g} > 1e-3")
    check(min_cos >= 0.999, f"chunked CE grad cosine {min_cos} < 0.999 for {min_name}")
    check(math.isfinite(metrics["loss"]), f"B8 step loss {metrics['loss']}")
    del step, b8
    release()

    # f32 master weights at B1: after two updates (update 1 has lr 0) every
    # bf16 trainable is its master copy rounded
    opt_m = dataclasses.replace(opt_cfg, warmup_ratio=0.0, master_weights=True)
    step = make_train_step(cfg, opt_m, model, teacher_fn=tfn, teacher_params=teachers,
                           remat_policy="save_gate")
    before = {n: p.detach().clone() for n, p in step.trainable.items()}
    for _ in range(2):
        step(b1)
    master = step.optimizer.master
    off = sum(int((p != master[n].to(p.dtype)).sum()) for n, p in step.trainable.items())
    moved = sum(int((p != before[n]).sum()) for n, p in step.trainable.items())
    total = sum(p.numel() for p in step.trainable.values())
    out["master_weights"] = dict(params=total, moved=moved, off_rounded_master=off,
                                 dtypes=sorted({str(p.dtype) for p in step.trainable.values()}))
    print("master_weights " + json.dumps(out["master_weights"]))
    check(off == 0, f"{off} trainable values are not their master copy rounded")
    check(moved > 0, "no trainable moved in two updates")
    del step, before, master
    release()
    return out


def engine_workload(cfg, n: int, max_len: int):
    """bench_engine.py's mixed workload (`reqs_spec`), from
    np.random.default_rng(0) in its order: per request 13 system ids, one
    image and 16-63 text tokens, and 8-127 new tokens."""
    from visper_lm_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from visper_lm_tpu_torch.data.collate import build_splice_plan

    rng = np.random.default_rng(0)
    vocab = cfg.decoder.vocab_size

    def make_plan(prompt_tokens):
        return build_splice_plan(
            list(rng.integers(3, vocab - 10, size=cfg.num_sys_tokens)) + [IMAGE_TOKEN_INDEX]
            + list(rng.integers(3, vocab - 10, size=prompt_tokens)),
            None, max_len, num_image_tokens=cfg.num_image_tokens,
            num_task_tokens=cfg.distill.num_task_tokens,
            num_tasks=len(cfg.distill.task_order()),
        )

    size = cfg.vision.image_size
    return [(make_plan(int(rng.integers(16, 64))),
             rng.normal(size=(1, size, size, 3)).astype(np.float32),
             int(rng.integers(8, 128)))
            for _ in range(n)]


def logits_close(name, got, ref):
    """Logits with the kernels vs the plain path: within 0.05 x max|ref|
    (bf16 through every layer); returns the measured difference and share."""
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"{name}: max abs diff {diff:.4g}, max |logit| {scale:.4g} (share {diff / scale:.4g}), "
          f"argmax agree {bool(got.argmax(-1).eq(ref.argmax(-1)).all())}")
    check(bool(torch.isfinite(got).all()), f"{name}: logits not finite")
    check(diff <= 0.05 * scale, f"{name}: logits differ by {diff} > 0.05 x {scale}")
    return dict(max_abs_diff=diff, max_abs_logit=scale, share=diff / scale)


def int_offset_decode(generator, cache, token, offsets, n: int) -> torch.Tensor:
    """Greedy decode of n tokens with a Python-int q_offset, as the decode
    chunk ran before its slot lived on the device: the reference the
    device-slot chunk must equal bit for bit."""
    dec = generator.decoder
    toks = []
    with torch.no_grad():
        for i in range(n):
            slot = generator.prompt_len + i
            out = dec(dec.embed_tokens(token[:, None]), positions=(slot - offsets)[:, None],
                      kv_starts=offsets, cache=cache, q_offset=slot)
            token = out["logits"][:, 0].argmax(-1)
            toks.append(token)
    return torch.stack(toks)


def engine_phase(cfg, model, act_rms, fa, qm) -> dict:
    """Phase 9: the continuous-batching Engine at bench_engine.py's defaults
    (int8 KV + w8a16), the batch loop beside it, prefix caching, chunked
    prefill, the speculative engine, SpeculativeDecoder, BeamSearchDecoder
    and an int4 engine run. Returns the record printed as `engine_path`."""
    import dataclasses
    import warnings

    from visper_lm_tpu_torch.models.decoder import Decoder
    from visper_lm_tpu_torch.serve.beam import BeamSearchDecoder
    from visper_lm_tpu_torch.serve.engine import Engine, EngineConfig, Request
    from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator, left_pad_plans
    from visper_lm_tpu_torch.serve.speculative import SpeculativeDecoder

    d = cfg.decoder
    ecfg = EngineConfig(**ENGINE, kv_quant=True, weight_quant=True)
    work = engine_workload(cfg, ENGINE_REQUESTS, ecfg.max_len)
    per_forward = 7 * d.num_layers + 1
    out = {}

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def requests(spec, arrivals=None):
        reqs = []
        for i, (plan, im, mn) in enumerate(spec):
            r = Request(plan=plan, images=im, max_new_tokens=mn, uid=i)
            if arrivals is not None:
                r.stream_callback = (lambda uid: lambda tok: arrivals.setdefault(
                    uid, time.perf_counter()))(i)
            reqs.append(r)
        return reqs

    # the main path: bench_engine.py's 32 requests through the engine, and
    # through the batch loop (bench_engine.py measurement 2: a Generator per
    # batch of 8, each batch decoding to its longest request), in turns:
    # engine, loop, loop, engine (both host-bound: one call, one card)
    t0 = time.perf_counter()
    eng = Engine(model, cfg, ecfg, device="cuda")
    longest = max(p.seq_length for p, _, _ in work)
    prompt_pad = -(-longest // 128) * 128
    g_cfg = GenerationConfig(max_new_tokens=127, decode_chunk=8, kv_quant=True, weight_quant=True)
    gen = Generator(model, cfg, g_cfg, ecfg.num_slots, prompt_pad, device="cuda")
    torch.cuda.synchronize()
    print(f"engine and batch-loop init (w8a16 copies of the decoder, {ecfg.num_slots} x "
          f"{ecfg.max_len} int8 cache) {time.perf_counter() - t0:.2f} s")
    out["prefill_logits"] = logits_close(
        "engine prefill logits kernels vs plain",
        eng.prefill_logits(requests(work[:1])[0]),
        eng.prefill_logits(requests(work[:1])[0], use_kernel=False))

    def engine_pass(spec_list):
        """One run of the engine over spec_list, checked; its record. torch's
        sync-debug warnings are counted by the call stack that raised them."""
        eng.stats = {k: 0 for k in eng.stats}
        fa.launches = 0
        arrivals = {}
        sites = collections.Counter()

        def on_warning(message, category, filename, lineno, file=None, line=None):
            if "synchronizing" in str(message):
                stack = traceback.extract_stack()[:-1]
                where = "engine" if any(Path(f.filename).name == "engine.py" for f in stack) else "other"
                sites[where + ": " + " < ".join(f"{Path(f.filename).name}:{f.lineno}"
                                                for f in reversed(stack[-3:]))] += 1

        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = on_warning
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            done = eng.run(requests(spec_list, arrivals))
            run_s = time.perf_counter() - t0
            torch.cuda.set_sync_debug_mode("default")
        st = dict(eng.stats)
        n = len(spec_list)
        check(len(done) == n, f"engine finished {len(done)} of {n}")
        by_uid = {r.uid: r for r in done}
        check(all(len(by_uid[i].output_ids) == spec_list[i][2] for i in range(n)),
              "an engine request did not get exactly its max_new_tokens")
        check(all(0 <= t < d.vocab_size for r in done for t in r.output_ids),
              "engine token out of vocab")
        check(all(r is None for r in eng.slot_req) and not eng.queue, "a slot stayed occupied")
        engine_syncs = sum(c for k, c in sites.items() if k.startswith("engine:"))
        check(st["host_syncs"] == st["steps"] == engine_syncs,
              f"engine synced {st['host_syncs']} times by its count and {engine_syncs} by "
              f"torch's over {st['steps']} quanta: {dict(sites)}")
        check(fa.launches == d.num_layers * st["admit_dispatches"],
              f"flash kernel launched {fa.launches} times over {st['admit_dispatches']} "
              "prefill dispatches")
        ttft = sorted((arrivals[r.uid] - r.submit_t) * 1e3 for r in done)
        n_tok = sum(len(r.output_ids) for r in done)
        return dict(
            seconds=run_s, requests_per_s=n / run_s, tokens=n_tok, tokens_per_s=n_tok / run_s,
            ttft_mean_ms=sum(ttft) / n, ttft_p90_ms=ttft[int(0.9 * (n - 1))],
            ms_per_step=run_s / st["steps"] * 1e3,
            occupancy=st["slot_steps"] / (st["steps"] * ecfg.num_slots * ecfg.decode_quantum),
            flash_launches=fa.launches, engine_sync_warnings=engine_syncs,
            sync_sites=dict(sites), stats=st,
        ), {r.uid: r.output_ids for r in done}

    def loop_pass(spec_list):
        """The batch loop over spec_list: (tokens, seconds)."""
        t0 = time.perf_counter()
        tokens = 0
        for i in range(0, len(spec_list), ecfg.num_slots):
            chunk = spec_list[i:i + ecfg.num_slots]
            tokens += sum(c[2] for c in chunk)
            chunk = chunk + chunk[-1:] * (ecfg.num_slots - len(chunk))
            batch = left_pad_plans([c[0] for c in chunk], prompt_pad)
            batch["images"] = np.concatenate([c[1] for c in chunk])
            logits, cache = gen.prefill(batch)
            token = logits.argmax(-1)
            offs = torch.as_tensor(batch["pad_offsets"], device="cuda").long()
            rng = torch.Generator(device="cuda")
            step = torch.zeros((), dtype=torch.long, device="cuda")
            for _ in range(-(-(max(c[2] for c in chunk) - 1) // 8)):
                token = gen._decode_chunk(cache, token, step, offs, rng)[-1]
                step = step + 8
            token.cpu()
        return tokens, time.perf_counter() - t0

    warm = [(p, im, 8) for p, im, _ in work[: ecfg.num_slots]]
    eng.run(requests(warm))                                         # warm-ups
    loop_pass(warm)
    torch.cuda.reset_peak_memory_stats()
    runs = {"engine": [], "batch_loop": []}
    for turn in ("engine", "batch_loop", "batch_loop", "engine"):
        if turn == "engine":
            rec, plain_tokens = engine_pass(work)
            print("engine_main " + json.dumps(rec))
        else:
            tok, sec = loop_pass(work)
            rec = dict(seconds=sec, tokens=tok, tokens_per_s=tok / sec,
                       requests_per_s=ENGINE_REQUESTS / sec)
            print("batch_loop " + json.dumps(rec))
        runs[turn].append(rec)
    out["engine"] = dict(runs["engine"][0], requests=ENGINE_REQUESTS,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    out["turns"] = {k: [dict((m, r[m]) for m in ("seconds", "tokens_per_s", "requests_per_s"))
                        for r in v] for k, v in runs.items()}
    for rec in runs["engine"]:
        rec.pop("stats")
    out["engine_second"] = runs["engine"][1]
    out["batch_loop"] = dict(prompt_pad=prompt_pad, requests=ENGINE_REQUESTS)
    for k in ("tokens_per_s", "requests_per_s"):
        out["engine"][f"mean_{k}"] = sum(r[k] for r in runs["engine"]) / 2
        out["batch_loop"][f"mean_{k}"] = sum(r[k] for r in runs["batch_loop"]) / 2
    print("engine_vs_batch_loop " + json.dumps(out["turns"]))

    # where the time goes: an engine step with every slot busy (one quantum)
    # beside a decode chunk of the batch loop (8 tokens)
    for i, (p, im, _) in enumerate(work[: ecfg.num_slots]):
        eng.submit(Request(plan=p, images=im, max_new_tokens=10 ** 6, uid=("busy", i)))
    eng.step()                                  # admits them
    out["step_profile"] = profile_window("engine_step", eng.step)
    batch = left_pad_plans([c[0] for c in work[: ecfg.num_slots]], prompt_pad)
    batch["images"] = np.concatenate([c[1] for c in work[: ecfg.num_slots]])
    logits, cache = gen.prefill(batch)
    offs = torch.as_tensor(batch["pad_offsets"], device="cuda").long()
    out["loop_chunk_profile"] = profile_window("batch_loop_chunk", lambda: gen._decode_chunk(
        cache, logits.argmax(-1), torch.zeros((), dtype=torch.long, device="cuda"), offs,
        torch.Generator(device="cuda")))
    del gen, cache, logits
    release()

    # prefix caching and chunked prefill, on a one-slot bf16-cache engine
    side = Engine(model, cfg, EngineConfig(num_slots=1, max_len=ecfg.max_len,
                                           prompt_bucket=ecfg.prompt_bucket,
                                           prefill_chunk=ENGINE_CHUNK), device="cuda")
    plan, im, _ = work[0]
    head = eng._chunk_plan(plan, 0, plan.seq_length - 40)
    tail = eng._chunk_plan(plan, plan.seq_length - 40, plan.seq_length)
    full = side.prefill_logits(Request(plan=plan, images=im))
    fa.launches = 0
    handle = side.prefill_prefix(head, images=im)
    check(fa.launches == d.num_layers, f"prefill_prefix launched the flash kernel {fa.launches} times")
    suffix_logits, _, _ = side._run_suffix(handle, tail, None, None)
    out["prefix"] = logits_close("prefix handle + suffix vs full prefill", suffix_logits, full)
    req = Request(plan=plan, images=im)
    n_chunks = 0
    while side._needs_chunk(req):
        side._advance_chunk(req)
        n_chunks += 1
    check(n_chunks >= 1, f"a {plan.seq_length}-token prompt took no chunk of {ENGINE_CHUNK}")
    chunk_logits, _, _ = side._run_suffix(req.prefix, req.plan, None, req.image_features)
    out["chunked"] = dict(logits_close(f"chunked prefill ({n_chunks} chunks of {ENGINE_CHUNK}) vs "
                                       "single shot",
                                       chunk_logits, full), chunks=n_chunks)
    del side, handle, req, eng
    release()

    # the speculative engine against the plain engine's tokens
    sub = work[: ecfg.num_slots]
    spec = Engine(model, cfg, dataclasses.replace(ecfg, spec_k=4, spec_quantum=4), device="cuda")
    t0 = time.perf_counter()
    spec_done = spec.run(requests(sub))
    spec_s = time.perf_counter() - t0
    agree = sum(r.output_ids == plain_tokens[r.uid] for r in spec_done)
    same = sum(a == b for r in spec_done for a, b in zip(r.output_ids, plain_tokens[r.uid]))
    out["spec_engine"] = dict(
        requests=len(sub), seconds=spec_s, identical_requests=agree,
        token_agreement=same / sum(len(r.output_ids) for r in spec_done),
        proposed=spec.stats["spec_proposed"], accepted=spec.stats["spec_accepted"],
        steps=spec.stats["steps"], host_syncs=spec.stats["host_syncs"])
    print("engine_spec " + json.dumps(out["spec_engine"]))
    check(all(len(r.output_ids) == r.max_new_tokens for r in spec_done), "spec engine token counts")
    del spec
    release()

    # SpeculativeDecoder: Phi3's decoder as the target, its first 4 blocks with
    # the same embedding, norm and head as the draft; BeamSearchDecoder
    target = model.decoder
    with torch.device("meta"):
        draft = Decoder(dataclasses.replace(d, num_layers=4))
    draft.embed_tokens, draft.final_norm, draft.lm_head = (
        target.embed_tokens, target.final_norm, target.lm_head)
    draft.blocks = torch.nn.ModuleList(target.blocks[:4])
    prompt = np.random.default_rng(1).integers(3, d.vocab_size - 10, size=128).tolist()
    t0 = time.perf_counter()
    s_out, s_stats = SpeculativeDecoder(target, draft.eval(), k=4, max_len=512).generate(
        prompt, max_new_tokens=32)
    out["speculative"] = dict(seconds=time.perf_counter() - t0, tokens=len(s_out),
                              acceptance_rate=s_stats.acceptance_rate,
                              tokens_per_target_pass=s_stats.tokens_per_target_pass,
                              iterations=s_stats.iterations)
    check(len(s_out) == 32, f"SpeculativeDecoder gave {len(s_out)} tokens")
    t0 = time.perf_counter()
    b_out, b_score = BeamSearchDecoder(target, num_beams=4, max_len=512).generate(
        prompt, max_new_tokens=32)
    out["beam"] = dict(seconds=time.perf_counter() - t0, tokens=len(b_out), score=b_score)
    check(len(b_out) == 32 and math.isfinite(b_score), f"beam search: {len(b_out)} tokens, {b_score}")
    print("engine_decoders " + json.dumps(dict(speculative=out["speculative"], beam=out["beam"])))
    del draft
    release()

    # one engine run at int4 (AWQ calibration of phase 6): B5 in every linear
    q4 = Engine(model, cfg, dataclasses.replace(ecfg, weight_quant="int4", calibration=act_rms),
                device="cuda")
    qm.launches = 0
    t0 = time.perf_counter()
    q4_done = q4.run(requests(sub))
    q4_s = time.perf_counter() - t0
    st4 = q4.stats
    forwards = st4["admit_dispatches"] + st4["steps"] * ecfg.decode_quantum
    check(qm.launches == per_forward * forwards,
          f"w4 kernel launched {qm.launches} times in the int4 engine run, expected "
          f"{per_forward} x {forwards} forwards")
    check(all(len(r.output_ids) == r.max_new_tokens for r in q4_done), "int4 engine token counts")
    out["int4_engine"] = dict(requests=len(sub), seconds=q4_s, w4_launches=qm.launches,
                              forwards=forwards,
                              tokens_per_s=sum(len(r.output_ids) for r in q4_done) / q4_s)
    print("engine_int4 " + json.dumps(out["int4_engine"]))
    del q4
    release()
    return out


class WordTokenizer:
    """A whitespace tokenizer with the HF surface the api uses (the card has
    no `transformers`). Special strings and newlines are tokens of their own;
    a word "w<k>" is id k, which is how decode writes every other id, and any
    other word is a crc32 hash above the special range: decode then encode
    gives the ids back, so a chat session finds its cached history."""

    def __init__(self, vocab_size: int, specials: dict, bos: int, eos: int, first_word: int):
        import re

        self.vocab_size, self.first_word = vocab_size, first_word
        self.specials = dict(specials)
        self.bos_token_id, self.eos_token_id = bos, eos
        self._split = re.compile("(" + "|".join(map(re.escape, self.specials)) + ")")

    def __call__(self, text):
        import types
        import zlib

        ids = [self.bos_token_id]
        top = min([v for v in self.specials.values() if v >= self.first_word] + [self.vocab_size])
        for part in self._split.split(text):
            if part in self.specials:
                ids.append(self.specials[part])
                continue
            for w in part.split():
                if w[0] == "w" and w[1:].isdigit() and int(w[1:]) < self.vocab_size:
                    ids.append(int(w[1:]))
                else:
                    ids.append(self.first_word + zlib.crc32(w.encode()) % (top - self.first_word))
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, ids, skip_special_tokens=False):
        names = {v: k for k, v in self.specials.items()}
        return " ".join(
            ("" if skip_special_tokens and names[i] != "\n" else names[i]) if i in names
            else f"w{i}" for i in ids)


def api_phase(fa, qm, da, param, gen):
    """Phase 10: Llama-3-8B + CLIP-ViT-L/14-336 through the user API
    (visper_lm_tpu_torch/api.py) at full width and depth: the export/import
    round trip in memory, chat() four ways, serve(), a ChatSession, the
    safetensors file round trip at 2 layers, Vicuna-7B at 4 layers. Returns
    the record printed as `api_path` (with the B1 and B5 cases at Llama-3's
    shapes), and what phase 11 reuses: the model, its config, the tokenizer,
    the questions and the images."""
    import dataclasses
    import shutil

    from visper_lm_tpu_torch.api import VisperModel, config_from_hf_json
    from visper_lm_tpu_torch.checkpoint.hf_export import export_vlm, save_hf_checkpoint
    from visper_lm_tpu_torch.checkpoint.hf_import import import_vlm
    from visper_lm_tpu_torch.config import config_to_json, llama3_clip_vlm, vicuna_clip_vlm
    from visper_lm_tpu_torch.data.mm_utils import tokenizer_image_token
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.serve.engine import EngineConfig
    from visper_lm_tpu_torch.serve.generate import GenerationConfig

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def bit_equal(a, b, what):
        check(sorted(a) == sorted(b), f"{what}: the tensor names differ")
        bad = [k for k in a if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
               or not torch.equal(a[k], b[k])]
        check(not bad, f"{what}: {len(bad)} tensors differ, e.g. {bad[:3]}")

    out = {}
    cfg = llama3_clip_vlm(distill=True, image_aspect_ratio="pad")   # LLaVA-1.5's padding
    d = cfg.decoder
    per_forward = 7 * d.num_layers + 1
    tok = WordTokenizer(d.vocab_size, LLAMA3_SPECIALS, bos=128000, eos=128009, first_word=256)
    rng = np.random.default_rng(10)
    questions = [" ".join(f"w{i}" for i in rng.integers(256, 128000, size=n)) for n in CHAT_WORDS]
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in CHAT_IMAGES]

    # the chat batch (host only: templates, tokenizer, image preprocessing)
    t0 = time.perf_counter()
    batch = VisperModel(cfg=cfg, model=None, tokenizer=tok).chat_batch(questions, images)
    out["chat_batch_s"] = time.perf_counter() - t0
    pad_to = batch["text_ids"].shape[1]
    offsets = batch["pad_offsets"].tolist()
    print(f"llama3 chat batch: {len(questions)} prompts padded to {pad_to}, offsets {offsets}, "
          f"{len(images)} images {CHAT_IMAGES} preprocessed in {out['chat_batch_s']:.2f} s")

    # B1 and B5 at the shapes Llama-3-8B gives them here
    out["b1"] = kernel_case("llama3_prefill", len(questions), pad_to, d.num_heads, d.num_kv_heads,
                            d.head_dim, torch.bfloat16, True, offsets, [pad_to] * len(questions),
                            gen, fa)
    out["b5"] = {f"{lname}_M{m}": w4_case(f"llama3_{lname}_M{m}", m, din, dout, gen, qm, param)
                 for lname, din, dout in (("gate_up", d.hidden_size, d.mlp_dim),
                                          ("down", d.mlp_dim, d.hidden_size))
                 for m in (len(questions), len(questions) * pad_to)}
    release()

    t0 = time.perf_counter()
    model = init_vlm(cfg, device="cuda", seed=10)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"llama3 init_vlm {time.perf_counter() - t0:.1f} s, {n_params / 1e9:.3f} B params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # 1. export_vlm -> import_vlm in memory: a renaming (CLIP's qkv split and
    # joined again): every tensor comes back bit-equal
    t0 = time.perf_counter()
    own = model.state_dict()
    bit_equal(import_vlm(export_vlm(model, cfg), cfg), own, "in-memory export -> import")
    out["memory_round_trip"] = dict(tensors=len(own), values=n_params,
                                    seconds=time.perf_counter() - t0)
    print(f"export_vlm -> import_vlm in memory: {len(own)} tensors bit-equal "
          f"({out['memory_round_trip']['seconds']:.2f} s)")
    del own
    release()

    # 2. chat(): bf16, the default (bf16 by JAX's rule: it quantizes by
    # itself only on a TPU), int8 KV + w8a16, int8 KV + int4
    chats, answers_by_mode = {}, {}
    for mode, kvq, wq in (("bf16", False, False), ("bf16_default", None, None),
                          ("int8", True, True), ("int4", True, "int4")):
        vm = VisperModel(cfg=cfg, model=model, tokenizer=tok)
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = qm.launches = 0
        t0 = time.perf_counter()
        answers = vm.chat(questions, images, max_new_tokens=NEW_TOKENS, kv_quant=kvq,
                          weight_quant=wq)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        b1, b5 = fa.launches, qm.launches
        generator = list(vm._gen_cache.values())[-1]
        forwards = b5 // per_forward
        check(b1 == d.num_layers, f"chat {mode}: B1 launched {b1} times, expected {d.num_layers}")
        if mode == "int4":
            check(b5 == per_forward * forwards and (forwards - 1) % generator.gen_cfg.decode_chunk == 0,
                  f"chat int4: B5 launched {b5} times, not {per_forward} per forward")
        else:
            check(b5 == 0, f"chat {mode}: B5 launched {b5} times")
        check(len(answers) == len(questions) and all(isinstance(a, str) for a in answers),
              f"chat {mode}: answers {answers}")
        answers_by_mode[mode] = answers
        if mode == "bf16_default":
            check(not generator.gen_cfg.kv_quant and answers == answers_by_mode["bf16"],
                  "chat with the default quantization is not the bf16 chat")
        timing = timed_generate(generator, batch, generator.gen_cfg)
        logits_k = generator.prefill(batch)[0]
        logits_p = generator.prefill(batch, use_kernel=False)[0]
        close = logits_close(f"llama3 chat {mode} first-token logits kernels vs plain",
                             logits_k, logits_p)
        del logits_k, logits_p
        chats[mode] = dict(first_call_s=first_s, **timing, peak_gib=peak / 2**30,
                           resident_before_gib=resident / 2**30, b1_launches=b1,
                           b5_launches=b5, kernel_vs_plain=close, sample=answers[0][:80])
        if mode == "bf16":
            logits, cache = generator.prefill(batch)
            offs = torch.as_tensor(batch["pad_offsets"], device="cuda").long()
            chats[mode]["profile"] = dict(
                prefill=profile_window("llama3_prefill", lambda: generator.prefill(batch)),
                decode_chunk=profile_window("llama3_decode_chunk", lambda: generator._decode_chunk(
                    cache, logits.argmax(-1), 0, offs, torch.Generator(device="cuda"))))
            del logits, cache
            square = VisperModel(cfg=dataclasses.replace(cfg, image_aspect_ratio="square"),
                                 model=model, tokenizer=tok)
            fa.launches = 0
            t0 = time.perf_counter()
            sq = square.chat(questions, images, max_new_tokens=NEW_TOKENS, kv_quant=False,
                             weight_quant=False)
            chats[mode]["square_s"] = time.perf_counter() - t0
            check(len(sq) == len(questions) and fa.launches == d.num_layers,
                  f"chat square: {len(sq)} answers, {fa.launches} B1 launches")
            del square
        print(f"chat_{mode} " + json.dumps(chats[mode]))
        del vm, generator
        release()
    out["chat"] = chats

    # 3. serve(): the same prompts through the engine (int8 KV + w8a16);
    # its prefill logits held against chat()'s Generator, row by row
    vm = VisperModel(cfg=cfg, model=model, tokenizer=tok)
    fa.launches = 0
    t0 = time.perf_counter()
    served = vm.serve(questions, images, max_new_tokens=NEW_TOKENS, kv_quant=True,
                      weight_quant=True)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    check(len(served) == len(questions) and fa.launches > 0 and fa.launches % d.num_layers == 0,
          f"serve: {len(served)} answers, {fa.launches} B1 launches")
    serve_rec = dict(seconds=serve_s, b1_launches=fa.launches,
                     prefill_dispatches=fa.launches // d.num_layers)
    chat_gen = vm._generator(GenerationConfig(kv_quant=True, weight_quant=True),
                             len(questions), pad_to)
    chat_logits = chat_gen.prefill(batch)[0]
    engine = vm.engine(EngineConfig(num_slots=1, max_len=pad_to, kv_quant=True), weight_quant=True)
    worst = None
    for i, req in enumerate(vm.requests(questions, images)):
        rec = logits_close(f"serve request {i} prefill logits vs chat's row", engine.prefill_logits(
            req)[0], chat_logits[i])
        worst = rec if worst is None or rec["share"] > worst["share"] else worst
    serve_rec["logits_vs_chat_worst"] = worst
    print("serve " + json.dumps(serve_rec))
    out["serve"] = serve_rec
    del engine, chat_gen, chat_logits
    release()

    # 4. ChatSession (int8 KV + w8a16): three turns on one image; turns 2
    # and 3 prefill only their own tokens (the engine's count)
    session = vm.chat_session(images[0], kv_quant=True, weight_quant=True)
    turns = []
    for i, q in enumerate((questions[1], "w17 w23 w99 w5", "w4242 w77")):
        conv = session.conv.copy()
        conv.append_message(conv.roles[0], q if i else "<image>\n" + q)
        conv.append_message(conv.roles[1], None)
        full = len(tokenizer_image_token(conv.get_prompt(), tok))
        before, cached = session.engine.stats["prefill_tokens"], len(session._ids)
        t0 = time.perf_counter()
        answer = session.ask(q, max_new_tokens=16)
        turn_s = time.perf_counter() - t0
        prefilled = session.engine.stats["prefill_tokens"] - before
        turns.append(dict(seconds=turn_s, prompt_tokens=full, prefilled=prefilled,
                          cached_before=cached, answer=answer[:60]))
        if i:
            check(prefilled == full - cached and prefilled < full,
                  f"session turn {i + 1} prefilled {prefilled} of {full} tokens "
                  f"({cached} cached)")
    print("chat_session " + json.dumps(turns))
    out["session"] = turns
    del session, vm
    release()

    # 5. the safetensors file round trip at full width and 2 layers, into
    # the repo's tmp/ (gitignored), removed after
    cfg2 = dataclasses.replace(cfg, decoder=dataclasses.replace(d, num_layers=FILE_LAYERS))
    model2 = init_vlm(cfg2, device="cuda", seed=11)
    ckpt = Path(__file__).resolve().parent / "tmp" / "llama3_2layer"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        save_hf_checkpoint(str(ckpt), model2, cfg2)
        write_s = time.perf_counter() - t0
        size = (ckpt / "model.safetensors").stat().st_size
        t0 = time.perf_counter()
        loaded = VisperModel.from_hf_checkpoint(str(ckpt), tokenizer=tok, dtype=None,
                                                 device="cuda")
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        check(config_to_json(loaded.cfg) == config_to_json(cfg2), "file round trip: config differs")
        bit_equal(loaded.model.state_dict(), model2.state_dict(), "file round trip")
        del loaded
        # a LLaVA-style config.json: the HF fields, no visper_config
        hand = dict(architectures=["LlavaLlamaForCausalLM"], model_type="llava_llama",
                    vocab_size=d.vocab_size, hidden_size=d.hidden_size,
                    intermediate_size=d.mlp_dim, num_hidden_layers=FILE_LAYERS,
                    num_attention_heads=d.num_heads, num_key_value_heads=d.num_kv_heads,
                    rope_theta=d.rope_theta, rms_norm_eps=d.norm_eps,
                    max_position_embeddings=8192, max_sequence_length=4096,
                    mm_vision_tower="openai/clip-vit-large-patch14-336", mm_hidden_size=1024,
                    mm_projector_type="mlp2x_gelu", image_aspect_ratio="pad",
                    mm_patch_merge_type="flat", mm_use_im_patch_token=False,
                    mm_use_im_start_end=False, torch_dtype="bfloat16")
        (ckpt / "config.json").write_text(json.dumps(hand, indent=1))
        plain = dataclasses.replace(cfg2, distill=None)
        check(config_to_json(config_from_hf_json(hand)) == config_to_json(plain),
              "config_from_hf_json of the LLaVA-style config.json differs")
        llava = VisperModel.from_hf_checkpoint(str(ckpt), tokenizer=tok, dtype=None,
                                                 device="cuda")
        ref = model2.state_dict()
        bit_equal(llava.model.state_dict(), {k: ref[k] for k in llava.model.state_dict()},
                  "LLaVA-style load")
        del llava, ref
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out["file_round_trip"] = dict(layers=FILE_LAYERS, bytes=size, write_s=write_s, read_s=read_s,
                                  write_gb_s=size / write_s / 1e9, read_gb_s=size / read_s / 1e9)
    print("file_round_trip " + json.dumps(out["file_round_trip"]))
    del model2
    release()

    # 6. Vicuna-7B at full width, 4 layers: the vicuna_v1 template
    vcfg = vicuna_clip_vlm(image_aspect_ratio="pad")
    vcfg = dataclasses.replace(vcfg, decoder=dataclasses.replace(vcfg.decoder,
                                                                 num_layers=VICUNA_LAYERS))
    vtok = WordTokenizer(vcfg.decoder.vocab_size, VICUNA_SPECIALS, bos=1, eos=2, first_word=259)
    vvm = VisperModel(cfg=vcfg, model=init_vlm(vcfg, device="cuda", seed=12), tokenizer=vtok)
    prompt = vvm.build_prompt(questions[0])
    check(prompt.startswith("A chat between a curious user") and prompt.endswith(" ASSISTANT:")
          and vvm.stop_strings() == ["</s>"], f"vicuna prompt {prompt[:80]!r}")
    fa.launches = 0
    t0 = time.perf_counter()
    vans = vvm.chat(questions[:2], images[:2], max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    check(len(vans) == 2 and fa.launches == VICUNA_LAYERS,
          f"vicuna chat: {len(vans)} answers, {fa.launches} B1 launches")
    out["vicuna"] = dict(layers=VICUNA_LAYERS, seconds=time.perf_counter() - t0,
                         b1_launches=fa.launches, eos_ids=vvm._eos_ids(), sample=vans[0][:60])
    print("vicuna " + json.dumps(out["vicuna"]))
    del vvm
    release()
    return out, dict(model=model, cfg=cfg, tok=tok, questions=questions, images=images)


def swap_vision(model, cfg, seed: int):
    """A VLM of `cfg` on the card sharing `model`'s decoder, task tokens, heads
    and logit scales (the Llama-3-8B weights are made once): a ConvNeXt
    config gets a seeded trunk (every block's gamma from N(0, 0.1^2), so each
    block's branch counts in bf16) and projector; otherwise the CLIP tower
    and projector are shared too. image_newline, where the config has one,
    is drawn from N(0, 0.02^2)."""
    from visper_lm_tpu_torch.models.convnext import init_convnext_
    from visper_lm_tpu_torch.models.vlm import VLM
    from visper_lm_tpu_torch.utils.param import init_weights_

    with torch.device("meta"):
        view = VLM(cfg)
    for name in ("decoder", "special_tokens", "heads", "logit_scales"):
        setattr(view, name, getattr(model, name))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.use_convnext_tower:
        view.vision_tower = init_convnext_(view.vision_tower.to_empty(device="cuda"), gen)
        view.mm_projector = view.mm_projector.to_empty(device="cuda")
        init_weights_(view.mm_projector, gen)
        with torch.no_grad():
            for stage in view.vision_tower.stages:
                for block in stage.blocks:
                    block.gamma.normal_(0.0, 0.1, generator=gen)
    else:
        view.vision_tower, view.mm_projector = model.vision_tower, model.mm_projector
    if view.image_newline is not None:
        drawn = torch.randn(cfg.decoder.hidden_size, device="cuda", generator=gen)
        view.image_newline = torch.nn.Parameter(
            (0.02 * drawn).to(model.decoder.embed_tokens.weight.dtype))
    return view.eval()


def vision_phase(api_state, fa, qm, wa, gen, smi: str) -> dict:
    """Phase 11: the vision side at Llama-3-8B through the user API (phase
    10's decoder, tokenizer, questions and images): the ConvNeXt-XXL tower at
    768 px (tower output shape, bf16 against f32 on the same weights), a
    ConvNeXt chat and an anyres chat (tiles padded to the batch's most,
    spatial_unpad, JAX's grid_pinpoints), B1 at both chats' prefill shapes
    against its plain version, one S2 tower call at CLIP-L; then, with the
    Llama-3 model released, one PT step of bench.py's --tower convnext cell
    (Phi3-mini, config #1, B4 x T1024, teachers, save_gate). Returns the
    record printed as `vision_path`."""
    import dataclasses

    from visper_lm_tpu_torch.api import VisperModel
    from visper_lm_tpu_torch.config import llama3_clip_vlm, phi3_clip_vlm, with_convnext_tower
    from visper_lm_tpu_torch.models.convnext import convnext_tower_features
    from visper_lm_tpu_torch.models.teachers import init_teachers, make_teacher_fn
    from visper_lm_tpu_torch.models.vit import clip_tower_features_s2
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.train.optimizer import OptimizerConfig
    from visper_lm_tpu_torch.train.train_step import make_train_step
    from visper_lm_tpu_torch.utils.diagnostics import convnext_flops

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    model, tok = api_state["model"], api_state["tok"]
    questions, images = api_state["questions"], api_state["images"]
    d = model.cfg.decoder
    out = dict(card=smi)

    def chat_run(name, vm, qs, ims):
        """One chat in bf16 with B1's launches counted, timed warm after, and
        its first-token logits with the kernels against the plain path."""
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = qm.launches = 0
        t0 = time.perf_counter()
        answers = vm.chat(qs, ims, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        b1, b5 = fa.launches, qm.launches
        peak = torch.cuda.max_memory_allocated()
        check(b1 == d.num_layers and b5 == 0, f"{name}: B1 {b1} launches (want {d.num_layers}), "
              f"B5 {b5}")
        check(len(answers) == len(qs) and all(isinstance(a, str) for a in answers),
              f"{name}: answers {answers}")
        generator = list(vm._gen_cache.values())[-1]
        check(not generator.gen_cfg.kv_quant and not generator.gen_cfg.weight_quant,
              f"{name}: the default chat is not bf16")
        batch = vm.chat_batch(qs, ims)
        timing = timed_generate(generator, batch, generator.gen_cfg, batch_size=len(qs))
        logits_k = generator.prefill(batch)[0]
        logits_p = generator.prefill(batch, use_kernel=False)[0]
        close = logits_close(f"{name} first-token logits kernels vs plain", logits_k, logits_p)
        del logits_k, logits_p, generator
        vm._gen_cache.clear()
        rec = dict(first_call_s=first_s, **timing, peak_gib=peak / 2**30,
                   resident_before_gib=resident / 2**30, b1_launches=b1,
                   prompt_len=int(batch["text_ids"].shape[1]), kernel_vs_plain=close,
                   sample=answers[0][:80], card=smi)
        return rec, batch

    # 1. ConvNeXt-XXL at 768 px with the Llama-3-8B decoder
    t_phase = time.perf_counter()
    cx_cfg = with_convnext_tower(llama3_clip_vlm(distill=True))
    t0 = time.perf_counter()
    cx = swap_vision(model, cx_cfg, seed=21)
    torch.cuda.synchronize()
    tower_params = sum(p.numel() for p in cx.vision_tower.parameters())
    print(f"convnext tower on the card {time.perf_counter() - t0:.1f} s, "
          f"{tower_params / 1e6:.1f} M params (bf16) [{smi}]")
    check(abs(tower_params - 843.4e6) < 1e6, f"ConvNeXt-XXL has {tower_params} params")
    vm = VisperModel(cfg=cx_cfg, model=cx, tokenizer=tok)
    t0 = time.perf_counter()
    pixels = torch.from_numpy(vm.chat_batch(questions, images)["images"]).cuda()
    prep_s = time.perf_counter() - t0
    check(tuple(pixels.shape) == (len(images), 768, 768, 3), f"convnext pixels {pixels.shape}")
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        feats = convnext_tower_features(cx.vision_tower, pixels)
        tower_peak = torch.cuda.max_memory_allocated() - resident
        tower_ms = cuda_ms(lambda: convnext_tower_features(cx.vision_tower, pixels), 3)
        tower32 = copy.deepcopy(cx.vision_tower).float()
        feats32 = convnext_tower_features(tower32, pixels)
    check(tuple(feats.shape) == (len(images), 576, 3072) and feats.dtype == torch.bfloat16,
          f"convnext tower output {tuple(feats.shape)} {feats.dtype}")
    check(bool(torch.isfinite(feats).all()), "convnext tower output not finite")
    rel = float((feats.float() - feats32).norm() / feats32.norm())
    del tower32, feats32
    flops = convnext_flops(cx_cfg.convnext) * len(images)
    # where the trunk's time goes: depthwise convs, GEMMs, the elementwise rest
    with torch.no_grad():
        prof = profile_window("convnext_tower", lambda: convnext_tower_features(
            cx.vision_tower, pixels), top=12, match=("conv", "nvjet", "gemm", "elementwise"))
    out["convnext_tower"] = dict(
        params=tower_params, shape=list(feats.shape), bf16_vs_f32_rel_frobenius=rel,
        ms=tower_ms, tflops=flops / tower_ms * 1e-9, transient_gib=tower_peak / 2**30,
        preprocess_s=prep_s, profile=prof, card=smi)
    print("convnext_tower " + json.dumps(out["convnext_tower"]))
    check(rel <= 2e-2, f"convnext tower bf16 vs f32: relative Frobenius {rel} > 2e-2")
    del feats, pixels
    release()
    out["convnext_chat"], cx_batch = chat_run("convnext chat", vm, questions, images)
    print("convnext_chat " + json.dumps(out["convnext_chat"]))
    cx_offsets = cx_batch["pad_offsets"].tolist()
    t = int(cx_batch["text_ids"].shape[1])
    out["b1_convnext"] = kernel_case("llama3_convnext_prefill", len(questions), t, d.num_heads,
                                     d.num_kv_heads, d.head_dim, torch.bfloat16, True, cx_offsets,
                                     [t] * len(questions), gen, fa)
    del vm, cx, cx_batch
    release()
    out["convnext_s"] = time.perf_counter() - t_phase

    # 2. anyres chat: CLIP-L tiles, spatial_unpad, JAX's grid_pinpoints; four
    # images that select four grids, so tile counts differ and pad + remap run
    t_phase = time.perf_counter()
    ar_cfg = dataclasses.replace(model.cfg, image_aspect_ratio="anyres",
                                 mm_patch_merge_type="spatial_unpad")
    ar = swap_vision(model, ar_cfg, seed=22)
    vm = VisperModel(cfg=ar_cfg, model=ar, tokenizer=tok)
    rng = np.random.default_rng(11)
    ar_images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ANYRES_IMAGES]
    ar_questions = questions[: len(ar_images)]
    tiles, own = vm.anyres_inputs(ar_images)
    n_tiles = [int(x.shape[0]) for x in tiles]
    n_tokens = [int(len(i)) for i in own]
    check(n_tiles == list(ANYRES_TILES), f"anyres tiles {n_tiles}, want {ANYRES_TILES}")
    print(f"anyres images (H, W) {ANYRES_IMAGES}: tiles {n_tiles}, image tokens {n_tokens} [{smi}]")
    out["anyres_chat"], ar_batch = chat_run("anyres chat", vm, ar_questions, ar_images)
    out["anyres_chat"].update(tiles=n_tiles, image_tokens=n_tokens)
    check(ar_batch["images"].shape[:2] == (len(ar_images), max(n_tiles)),
          f"anyres pixels {ar_batch['images'].shape}")
    print("anyres_chat " + json.dumps(out["anyres_chat"]))
    t = int(ar_batch["text_ids"].shape[1])
    out["b1_anyres"] = kernel_case("llama3_anyres_prefill", len(ar_images), t, d.num_heads,
                                   d.num_kv_heads, d.head_dim, torch.bfloat16, True,
                                   ar_batch["pad_offsets"].tolist(), [t] * len(ar_images), gen, fa)
    del vm, ar, ar_batch, tiles
    release()
    out["anyres_s"] = time.perf_counter() - t_phase

    # 3. one S2 call at CLIP-L full width: batch 2, scales (336, 1008)
    t_phase = time.perf_counter()
    s2_in = torch.randn(2, 1008, 1008, 3, device="cuda", generator=gen)
    with torch.no_grad():
        s2 = clip_tower_features_s2(model.vision_tower, s2_in, (336, 1008))
        s2_ms = cuda_ms(lambda: clip_tower_features_s2(model.vision_tower, s2_in, (336, 1008)), 2)
    check(tuple(s2.shape) == (2, 576, 2048) and bool(torch.isfinite(s2).all()),
          f"S2 features {tuple(s2.shape)}, finite {bool(torch.isfinite(s2).all())}")
    out["s2"] = dict(shape=list(s2.shape), ms=s2_ms, card=smi,
                     seconds=time.perf_counter() - t_phase)
    print("s2 " + json.dumps(out["s2"]))
    del s2, s2_in
    api_state.clear()
    del model
    release()

    # 4. one PT step of bench.py's --tower convnext cell: Phi3-mini, config
    # #1, B4 x T1024, the three teachers, save_gate (bench.py's default)
    t_phase = time.perf_counter()
    pt_cfg = with_convnext_tower(phi3_clip_vlm(distill=True))
    pt = init_vlm(pt_cfg, device="cuda", seed=23)
    teachers = init_teachers(pt_cfg, device="cuda", seed=7)
    step = make_train_step(pt_cfg, OptimizerConfig(learning_rate=1e-3, total_steps=1000,
                                                   stage="pretrain"),
                           pt, teacher_fn=make_teacher_fn(pt_cfg), teacher_params=teachers,
                           remat_policy="save_gate")
    tbatch = train_batch(pt_cfg, TRAIN_BATCH, TRAIN_SEQ)
    check(tbatch["images"].shape[1:] == (768, 768, 3), f"PT images {tbatch['images'].shape}")
    tower = dict(pt.vision_tower.named_parameters())
    check(not any(n.startswith("vision_tower.") for n in step.trainable)
          and not any(p.requires_grad for p in tower.values()), "the ConvNeXt tower trains")
    watch = {n: tower[n].detach().clone() for n in ("stem_conv.weight",
                                                    "stages.2.blocks.29.fc1.weight")}
    metrics = step(tbatch)                      # warm-up: update 1, lr 0
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = wa.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(tbatch)
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(flash_fwd=fa.launches, flash_bwd_dq=fa.dq_launches,
                    flash_bwd_dkv=fa.dkv_launches, window_attn=wa.launches)
    peak = torch.cuda.max_memory_allocated()
    n_layers = pt_cfg.decoder.num_layers
    check(launches == dict(flash_fwd=2 * n_layers, flash_bwd_dq=n_layers, flash_bwd_dkv=n_layers,
                           window_attn=sum(teachers["swin"].cfg.depths) * TRAIN_BATCH // 2),
          f"convnext PT step launches {launches}")
    check(math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"]),
          f"convnext PT step metrics {metrics}")
    _, grads = step.loss_and_grads(tbatch)
    bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())]
    check(not bad, f"convnext PT step: non-finite gradients in {bad[:3]}")
    check(all(p.grad is None for p in tower.values()), "the ConvNeXt tower got a gradient")
    check(all(torch.equal(tower[n], w) for n, w in watch.items()), "the ConvNeXt tower changed")
    out["convnext_pt_step"] = dict(
        step_ms=step_ms, peak_gib=peak / 2**30, resident_before_gib=resident / 2**30,
        launches=launches, loss=metrics["loss"],
        grad_norm=metrics["grad_norm"], trainable=len(grads), batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        card=smi, seconds=time.perf_counter() - t_phase)
    print("convnext_pt_step " + json.dumps(out["convnext_pt_step"]))
    del step, pt, teachers, grads, tower, watch
    release()
    return out


def recipe_dataset(root: Path) -> dict:
    """Phase 12's data under `root`: 16 PNG images of phase 10's sizes
    (seeded uint8, the port's PNG writer), 16 LLaVA-Pretrain-style records
    (<image> + a question, a 20-60-word answer) and 16 IFT-style multi-turn
    ones, a quarter of them text-only."""
    from visper_lm_tpu_torch.data.image_io import write_png

    rng = np.random.default_rng(12)
    images = root / "images"
    images.mkdir(parents=True)

    def words(lo, hi):
        n = int(rng.integers(lo, hi + 1))
        return " ".join(f"w{int(x)}" for x in rng.integers(0, 5000, size=n))

    for i in range(RECIPE_RECORDS):
        h, w = CHAT_IMAGES[i % len(CHAT_IMAGES)]
        write_png(str(images / f"{i:04d}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    pt = [{"id": f"pt{i}", "image": f"{i:04d}.png", "conversations": [
        {"from": "human", "value": "<image>\n" + words(5, 15)},
        {"from": "gpt", "value": words(20, 60)}]} for i in range(RECIPE_RECORDS)]
    ift = []
    for i in range(RECIPE_RECORDS):
        # half the image records multi-turn: under the Phi3 (and Vicuna)
        # templates the whitespace tokenizer's round lengths miss the
        # template's arithmetic, and the reference then masks the whole record
        # (JAX's preprocess alike); the single-turn ones carry the supervision
        multi = i % 2 == 0 and i % 4 != 3
        turns = []
        for _ in range(int(rng.integers(2, 4)) if multi else 1):
            turns += [{"from": "human", "value": words(5, 10)},
                      {"from": "gpt", "value": words(5, 15) if multi else words(30, 60)}]
        rec = {"id": f"ift{i}", "conversations": turns}
        if i % 4 != 3:
            rec["image"] = f"{i:04d}.png"
            turns[0]["value"] = "<image>\n" + turns[0]["value"]
        ift.append(rec)
    (root / "pt.json").write_text(json.dumps(pt))
    (root / "ift.json").write_text(json.dumps(ift))
    return dict(images=str(images), pt=str(root / "pt.json"), ift=str(root / "ift.json"))


def recipe_phase(fa, wa, smi: str) -> dict:
    """Phase 12: training from the recipes through the port's CLI (see the
    module docstring). Returns the record printed as `recipe_path`."""
    import dataclasses
    import os
    import shutil
    from unittest import mock

    from visper_lm_tpu_torch import native
    from visper_lm_tpu_torch.checkpoint.hf_export import save_hf_checkpoint
    from visper_lm_tpu_torch.config import LoraConfig
    from visper_lm_tpu_torch.constants import IGNORE_INDEX
    from visper_lm_tpu_torch.data.dataset import RAW_IMAGES, BatchIterator, DataConfig, SupervisedDataset
    from visper_lm_tpu_torch.data.image_io import load_image
    from visper_lm_tpu_torch.data.mm_utils import process_images
    from visper_lm_tpu_torch.models.lora import init_lora
    from visper_lm_tpu_torch.models.teachers import teacher_batch
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.train import cli
    from visper_lm_tpu_torch.train.checkpoint import CheckpointManager
    from visper_lm_tpu_torch.train.optimizer import OptimizerConfig
    from visper_lm_tpu_torch.train.train_step import make_loss_fn
    from visper_lm_tpu_torch.train.trainer import TrainerConfig, train

    repo = Path(__file__).resolve().parent
    root = repo / "tmp" / "chip_smoke_recipes"
    shutil.rmtree(root, ignore_errors=True)
    out = dict(card=smi)

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def reset_counts():
        fa.launches = fa.dq_launches = fa.dkv_launches = wa.launches = 0

    def counts():
        return dict(flash_fwd=fa.launches, flash_bwd_dq=fa.dq_launches,
                    flash_bwd_dkv=fa.dkv_launches, window_attn=wa.launches)

    def per_step(fwd, window, steps=RECIPE_STEPS):
        return dict(flash_fwd=fwd * steps, flash_bwd_dq=32 * steps, flash_bwd_dkv=32 * steps,
                    window_attn=window * steps)

    def rows(run_dir):
        with open(Path(run_dir) / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    def step_record(recs, batch=RECIPE_BATCH):
        # each row's steps_per_sec spans its own step; step 1 carries the warm-up
        ms = [1e3 / r["steps_per_sec"] for r in recs]
        warm = ms[1:] or ms
        mean = sum(warm) / len(warm)
        return dict(step_ms=ms, mean_step_ms_after_first=mean,
                    examples_per_s=batch / (mean / 1e3), losses=[r["loss"] for r in recs])

    def args(recipe, data_path, run, *extra):
        return [f"@{repo / 'recipes' / recipe}", "--data-path", data_path,
                "--image-folder", data["images"], "--tokenizer", "fake-whitespace",
                "--output-dir", str(root / run), "--per-device-batch-size", str(RECIPE_BATCH),
                "--max-steps", str(RECIPE_STEPS), *extra]

    try:
        t_phase = time.perf_counter()
        data = recipe_dataset(root)
        print(f"recipe dataset written in {time.perf_counter() - t_phase:.1f} s [{smi}]")
        t0 = time.perf_counter()
        native.load()
        out["native_build_s"] = native.build_seconds
        out["native_load_s"] = time.perf_counter() - t0
        out["native_flags"] = " ".join(native.flags())
        print(f"native preprocessing library: g++ {native.build_seconds} s ({out['native_flags']}), "
              f"load {out['native_load_s']:.2f} s")

        # the host pipeline per PT batch, inline, in the CLI's order
        pt_args = cli.build_argparser().parse_args(args("pretrain.args", data["pt"], "pt"))
        pt_cfg = cli.build_vlm_config(pt_args)
        tok = cli.load_tokenizer("fake-whitespace")
        ds = SupervisedDataset(DataConfig(data["pt"], data["images"], pt_args.image_aspect_ratio,
                                          pt_cfg.vision.image_size), tok, pt_cfg)
        order = BatchIterator(ds, RECIPE_BATCH, seed=0).order()
        host = collections.defaultdict(list)
        for b in range(len(order) // RECIPE_BATCH):
            recs = [ds.records[i] for i in order[b * RECIPE_BATCH:(b + 1) * RECIPE_BATCH]]
            t0 = time.perf_counter()
            arrays = [load_image(os.path.join(data["images"], r["image"])) for r in recs]
            t1 = time.perf_counter()
            process_images(arrays, image_aspect_ratio="square", image_size=pt_cfg.vision.image_size)
            t2 = time.perf_counter()
            teacher_batch(pt_cfg, arrays, workers=pt_args.dataloader_num_workers)
            t3 = time.perf_counter()
            host["decode_ms"].append((t1 - t0) * 1e3)
            host["tower_pixels_ms"].append((t2 - t1) * 1e3)
            host["teacher_batch_ms"].append((t3 - t2) * 1e3)
            t0 = time.perf_counter()
            next(iter(BatchIterator(ds, RECIPE_BATCH, seed=0, skip_batches=b,
                                    num_workers=pt_args.dataloader_num_workers)))
            host["batch_iterator_4_workers_ms"].append((time.perf_counter() - t0) * 1e3)
        out["host_per_pt_batch"] = {k: dict(ms=v, mean_ms=sum(v) / len(v)) for k, v in host.items()}
        print("recipe host ms per PT batch " + json.dumps(
            {k: round(v["mean_ms"], 1) for k, v in out["host_per_pt_batch"].items()}))

        # (a) PT at Llama-3-8B + CLIP-L from recipes/pretrain.args
        t_a = time.perf_counter()
        argv = args("pretrain.args", data["pt"], "pt", "--save-steps", "2")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_a
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        n_swin = 0 if state.teacher_params is None else sum(state.teacher_params["swin"].cfg.depths)
        want = per_step(64, n_swin * RECIPE_BATCH // 2)
        check(launches == want, f"recipe PT launches {launches}, expected {want}")
        recs = rows(root / "pt")
        check([r["step"] for r in recs] == [1, 2, 3] and all(math.isfinite(r["loss"]) for r in recs),
              f"recipe PT metrics {recs}")
        check((root / "pt" / "checkpoints" / "2" / "state.pt").exists(), "no step-2 checkpoint")
        fresh = dict(init_vlm(state.model.cfg, device="cuda", seed=0).named_parameters())
        moved, frozen_changed = [], []
        for n, p in state.model.named_parameters():
            same = torch.equal(p.detach(), fresh[n].detach())
            if n in state.trainable:
                moved += [] if same else [n]
            elif not same:
                frozen_changed.append(n)
        check(not frozen_changed, f"recipe PT: frozen weights changed: {frozen_changed[:3]}")
        check(any(n.startswith("mm_projector.") for n in moved)
              and any(n.startswith("heads.") for n in moved)
              and any(n.startswith("special_tokens.") for n in moved),
              f"recipe PT: trainables that moved {moved[:5]}")
        del fresh
        release()
        batch = next(iter(cli_batches(pt_cfg, pt_args, ds, teacher_batch)))
        prof = profile_window("recipe_pt_step", lambda: state(batch), top=12,
                              match=("flash_fwd", "flash_bwd", "window_attn_stream"))
        # the logged interval of step 3 holds the step-2 checkpoint's write: the
        # profiled step's wall time is the step's
        out["pt"] = dict(step_record(recs), step_wall_ms=prof["wall_ms"],
                         examples_per_s_wall=RECIPE_BATCH / (prof["wall_ms"] / 1e3),
                         run_s=run_s, peak_gib=peak / 2**30, launches=launches,
                         launches_per_step={k: v // RECIPE_STEPS for k, v in launches.items()},
                         trainable=len(state.trainable), trainables_moved=len(moved),
                         busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
                         idle_share=prof["idle_share"], card=smi)
        del state, batch
        release()
        # resume onto the same data order from the step-2 checkpoint
        res = root / "pt_resume" / "checkpoints"
        res.mkdir(parents=True)
        shutil.copytree(root / "pt" / "checkpoints" / "2", res / "2", copy_function=os.link)
        t0 = time.perf_counter()
        state = cli.main(args("pretrain.args", data["pt"], "pt_resume", "--save-steps", "2"))
        resumed = rows(root / "pt_resume")
        check([r["step"] for r in resumed] == [3], f"the resume logged {resumed}")
        rel = abs(resumed[0]["loss"] - recs[2]["loss"]) / abs(recs[2]["loss"])
        print(f"recipe PT resume: step 3 loss {resumed[0]['loss']:.7f}, uninterrupted "
              f"{recs[2]['loss']:.7f}, relative difference {rel:.3g}")
        check(rel <= 1e-5, f"recipe PT resume: step 3 loss differs by {rel:.3g} > 1e-5")
        out["pt"].update(resume_rel_diff=rel, resume_s=time.perf_counter() - t0,
                         seconds=time.perf_counter() - t_a)
        print("recipe_pt " + json.dumps(out["pt"]))
        del state
        release()

        # (b) IFT at Phi3-mini from recipes/finetune.args with --init-from
        t_b = time.perf_counter()
        ckpt = root / "phi3_init"
        ift_extra = ["--model", "phi3", "--version", "llava_phi_3", "--init-from", str(ckpt),
                     "--remat-policy", "save_gate"]
        ift_argv = args("finetune.args", data["ift"], "ift", *ift_extra)
        ift_args = cli.build_argparser().parse_args(ift_argv)
        ift_cfg = cli.build_vlm_config(ift_args)
        src = init_vlm(ift_cfg, device="cuda", seed=31)
        t0 = time.perf_counter()
        save_hf_checkpoint(str(ckpt), src, ift_cfg)
        save_s = time.perf_counter() - t0
        tower_src = {n: p.detach().clone() for n, p in src.vision_tower.named_parameters()}
        del src
        release()
        saves = []
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with mock.patch.object(CheckpointManager, "save",
                               lambda self, step, *a, **k: saves.append(step)):
            state = cli.main(ift_argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        want = per_step(64, 0)
        check(launches == want, f"recipe IFT launches {launches}, expected {want}")
        recs = rows(root / "ift")
        check([r["step"] for r in recs] == [1, 2, 3]
              and all(math.isfinite(r["loss"]) and r["loss"] > 0 for r in recs),
              f"recipe IFT metrics {recs}")
        check(saves == [RECIPE_STEPS], f"recipe IFT saves {saves}")
        model = state.model
        n_dec = sum(1 for n in state.trainable if n.startswith("decoder."))
        check(n_dec == sum(1 for n, _ in model.decoder.named_parameters())
              and not any(n.startswith("vision_tower.") for n in state.trainable),
              "recipe IFT: the decoder is not wholly trainable, or the tower trains")
        for n, p in model.vision_tower.named_parameters():
            check(torch.equal(p.detach(), tower_src[n]), f"recipe IFT: tower {n} is not the checkpoint's")
        del tower_src
        trained = sum(p.numel() for p in state.trainable.values())
        # one layer's weight gradients: the kernels (B1-B3) against the plain
        # path, both in bf16, and each against the plain path on an f32 copy
        # of the same weights. At full depth two bf16 paths differ by the bf16
        # rounding of 32 layers: the plain bf16 path is itself 1-2.4 % from the
        # f32 one on an H100 (PERF.md), so the kernels are held to add at most
        # 1e-2 to the plain path's own distance from f32, and to phase 7's
        # kernel-vs-plain gradient cosine (>= 0.999)
        ift_ds = SupervisedDataset(DataConfig(data["ift"], data["images"], ift_args.image_aspect_ratio,
                                              ift_cfg.vision.image_size,
                                              group_by_modality_length=True), tok, ift_cfg)
        # the batch with the most supervised tokens
        gbatch = max(BatchIterator(ift_ds, RECIPE_BATCH, seed=0, seq_buckets=(1024, 2048, 4096)),
                     key=lambda b: int((b["labels"] != IGNORE_INDEX).sum()))
        check(int((gbatch["labels"] != IGNORE_INDEX).sum()) > 0, "no IFT batch has a supervised token")
        gbatch = state.to_device({k: v for k, v in gbatch.items() if k != RAW_IMAGES})
        del state
        release()
        names = [f"decoder.blocks.{RECIPE_GRAD_LAYER}.{w}.weight" for w in (
            "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")]

        def layer_grads(m, use_kernel):
            batch_m = {k: v.float() if v.is_floating_point() else v for k, v in gbatch.items()}
            loss_fn = make_loss_fn(ift_cfg, remat=True, remat_policy="save_gate",
                                   use_kernel=use_kernel)
            params = dict(m.named_parameters())
            loss, g = loss_and_grads(loss_fn, m, batch_m, None, [params[n] for n in names])
            return loss, [x.float() for x in g]

        def rel(a, b):
            return float((a - b).norm() / b.norm())

        loss_k, g_k = layer_grads(model, None)
        loss_p, g_p = layer_grads(model, False)
        m32 = copy.deepcopy(model).float()
        loss_32, g_32 = layer_grads(m32, False)
        del m32
        release()
        short = [n.split(".")[-2] for n in names]
        rel_fro = {w: rel(a, b) for w, a, b in zip(short, g_k, g_p)}
        kernel_f32 = {w: rel(a, b) for w, a, b in zip(short, g_k, g_32)}
        plain_f32 = {w: rel(a, b) for w, a, b in zip(short, g_p, g_32)}
        min_cos, min_name, _ = grad_agreement(short, g_k, g_p)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        print(f"recipe IFT layer {RECIPE_GRAD_LAYER} weight gradients (relative Frobenius): "
              f"kernels vs plain {json.dumps({k: round(v, 5) for k, v in rel_fro.items()})}; "
              f"kernels vs f32 {json.dumps({k: round(v, 5) for k, v in kernel_f32.items()})}; "
              f"plain bf16 vs f32 {json.dumps({k: round(v, 5) for k, v in plain_f32.items()})}; "
              f"min cosine kernels vs plain {min_cos:.6f} ({min_name}); losses {loss_k:.6f} / "
              f"{loss_p:.6f} / {loss_32:.6f}")
        check(min_cos >= 0.999, f"recipe IFT gradient cosine {min_cos} < 0.999 for {min_name}")
        for w in short:
            check(kernel_f32[w] <= plain_f32[w] + 1e-2,
                  f"recipe IFT {w}: the kernels' gradient is {kernel_f32[w]:.4f} from f32, the "
                  f"plain path's {plain_f32[w]:.4f}")
        del g_k, g_p, g_32, gbatch
        out["ift"] = dict(step_record(recs), run_s=run_s, checkpoint_write_s=save_s,
                          peak_gib=peak / 2**30, launches=launches,
                          launches_per_step={k: v // RECIPE_STEPS for k, v in launches.items()},
                          trainable_params=trained, grad_rel_frobenius=rel_fro,
                          grad_kernel_vs_f32=kernel_f32, grad_plain_vs_f32=plain_f32,
                          grad_min_cosine=min_cos, grad_loss_rel=loss_rel, card=smi)
        shutil.rmtree(ckpt, ignore_errors=True)
        out["ift"]["seconds"] = time.perf_counter() - t_b
        print("recipe_ift " + json.dumps(out["ift"]))

        # (c) bench.py's --stage lora and --stage vision_tower on (b)'s model
        t_c = time.perf_counter()

        def ift_iter(epoch, skip_batches=0):
            return iter(BatchIterator(ift_ds, RECIPE_BATCH, seed=epoch, skip_batches=skip_batches,
                                      num_workers=4, seq_buckets=(1024, 2048, 4096)))

        dec_before = {n: p.detach().clone() for n, p in model.decoder.named_parameters()}
        lora_cfg = dataclasses.replace(ift_cfg, lora=LoraConfig())
        model.lora = init_lora(ift_cfg.decoder, lora_cfg.lora, device="cuda", seed=41)
        check(all(float(f.b.detach().abs().max()) == 0.0 for f in model.lora.values()),
              "LoRA's B is not 0")
        b0 = {k: torch.as_tensor(v).cuda() for k, v in next(ift_iter(0)).items() if k != RAW_IMAGES}
        with torch.no_grad():
            base_loss = make_loss_fn(ift_cfg, remat=False)(model, b0)[0]
            lora_loss = make_loss_fn(lora_cfg, remat=False)(model, b0)[0]
        check(torch.equal(base_loss, lora_loss), f"LoRA at B = 0: loss {float(lora_loss)} vs "
              f"the base model's {float(base_loss)}")
        del b0
        stages = {}
        for stage, cfg_s in (("lora", lora_cfg), ("vision_tower", ift_cfg)):
            if stage == "vision_tower":
                model.lora = None
            watch = {n: p.detach().clone() for n, p in model.named_parameters()
                     if not n.startswith("decoder.")}
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            st = train(cfg_s, OptimizerConfig(learning_rate=2e-5, total_steps=RECIPE_STEPS,
                                              stage=stage),
                       TrainerConfig(output_dir=str(root / stage), max_steps=RECIPE_STEPS,
                                     save_steps=1000, remat_policy="save_gate", device="cuda"),
                       model, ift_iter)
            torch.cuda.synchronize()
            launches = counts()
            check(launches == per_step(64, 0), f"{stage} launches {launches}")
            recs = rows(root / stage)
            check(all(math.isfinite(r["loss"]) for r in recs) and len(recs) == RECIPE_STEPS,
                  f"{stage} metrics {recs}")
            for n, p in model.decoder.named_parameters():
                check(torch.equal(p.detach(), dec_before[n]), f"{stage}: decoder {n} changed")
            moved = sorted({n.split(".")[0] for n, p in model.named_parameters()
                            if n in watch and not torch.equal(p.detach(), watch[n])})
            want_moved = ["lora", "mm_projector"] if stage == "lora" else ["mm_projector", "vision_tower"]
            check(moved == want_moved, f"{stage}: moved {moved}, expected {want_moved}")
            if stage == "lora":
                check(all(float(f.b.detach().abs().max()) > 0 for f in model.lora.values()),
                      "LoRA's B stayed 0")
            stages[stage] = dict(step_record(recs), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                                 launches=launches, trainable_params=sum(
                                     p.numel() for p in st.trainable.values()),
                                 moved=moved, seconds=time.perf_counter() - t0, card=smi)
            print(f"recipe_{stage} " + json.dumps(stages[stage]))
            del st, watch
            release()
        out.update(stages)
        out["stages_s"] = time.perf_counter() - t_c
        del model, dec_before
        release()
        out["seconds"] = time.perf_counter() - t_phase
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def cli_batches(cfg, args, ds, teacher_batch):
    """The CLI's PT batches (`cli.main`'s data_iter without the prefetch):
    splice plans and tower pixels, then the teachers' pixels of the raw
    images."""
    from visper_lm_tpu_torch.data.dataset import RAW_IMAGES, BatchIterator

    tasks = tuple(t.task for t in cfg.distill.tasks)
    for batch in BatchIterator(ds, args.per_device_batch_size, seed=0, distill_tasks=tasks,
                               seq_buckets=tuple(int(x) for x in args.seq_buckets.split(","))):
        batch.update(teacher_batch(cfg, batch.pop(RAW_IMAGES), workers=4))
        yield batch


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from visper_lm_tpu_torch.config import phi3_clip_vlm
    from visper_lm_tpu_torch.models.teachers import init_teachers, make_teacher_fn
    from visper_lm_tpu_torch.models.decoder import quantize_head_vectors
    from visper_lm_tpu_torch.models.teachers import swin
    from visper_lm_tpu_torch.models.vlm import encode_images, init_vlm, splice_embeddings
    from visper_lm_tpu_torch.ops import _build
    from visper_lm_tpu_torch.ops import decode_attention as da
    from visper_lm_tpu_torch.ops import flash_attention as fa
    from visper_lm_tpu_torch.ops import quant_matmul as qm
    from visper_lm_tpu_torch.ops import window_attention as wa
    from visper_lm_tpu_torch.serve.calibrate import decoder_act_rms
    from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator
    from visper_lm_tpu_torch.utils import param
    from visper_lm_tpu_torch.train.optimizer import OptimizerConfig
    from visper_lm_tpu_torch.train.train_step import make_loss_fn, make_train_step

    # reference settings: f32 matmuls in full f32, no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment
    smi = environment(_build)
    name = torch.cuda.get_device_name(0)

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    print("build seconds by library " + json.dumps(
        {lib: round(sec, 1) for lib, sec in _build.build_seconds.items()}))
    for lib, log in logs.items():
        for entry, res in _build.kernel_resources(log).items():
            print(f"ptxas[{lib}] {entry}: {json.dumps(res)}")
    # the redesigned kernels: registers, spills and shared memory
    smem, kv_tile, stages = (ctypes.c_int() for _ in range(3))
    for h in fa.SUPPORTED_HEAD_DIMS:
        check(_build.load("flash_fwd").visper_flash_fwd_wgmma_info(
            h, ctypes.byref(smem), ctypes.byref(kv_tile), ctypes.byref(stages)) == 0,
            f"no wgmma forward kernel at H{h}")
        print(f"flash_fwd wgmma H{h}: {smem.value} B dynamic shared memory, {kv_tile.value}-key "
              f"tiles, {stages.value} stages, 288 threads, 1 CTA per SM")
    dq_smem, dkv_smem, threads = (ctypes.c_int() for _ in range(3))
    for h in fa.SUPPORTED_HEAD_DIMS:
        check(_build.load("flash_bwd").visper_flash_bwd_wgmma_info(
            h, ctypes.byref(dq_smem), ctypes.byref(dkv_smem), ctypes.byref(stages),
            ctypes.byref(threads)) == 0, f"no wgmma backward kernels at H{h}")
        print(f"flash_bwd wgmma H{h}: dq {dq_smem.value} B, dk/dv {dkv_smem.value} B dynamic shared "
              f"memory, {stages.value} stages, {threads.value} threads (two warpgroups; warp 0 "
              f"refills the ring), 1 CTA per SM")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    win_threads, win_ctas = ctypes.c_int(), ctypes.c_int()
    for nw in (0, SWIN_STAGES[0][0] // 2):
        plan = wa.window_attn_plan(*SWIN_STAGES[0], 144, 32, nw, sms)
        check(_build.load("window_attn").visper_window_attn_info(
            144, 32, int(nw > 0), plan.stages,
            ctypes.byref(win_threads), ctypes.byref(smem), ctypes.byref(win_ctas)) == 0,
            "no streamed window kernel at N144 D32")
        check(smem.value == plan.smem_bytes,
              f"window_attn_plan counts {plan.smem_bytes} B of shared memory, the kernel {smem.value}")
        check(win_ctas.value >= 1, f"the streamed window kernel does not fit an SM: {plan}")
        print(f"window_attn streamed N144 D32 {'shifted' if nw else 'unshifted'} stage 1: "
              f"{smem.value} B dynamic shared memory, {win_threads.value} threads, "
              f"{win_ctas.value} CTA per SM; plan {json.dumps(plan._asdict())}")
    for lib, mark in (("flash_fwd", "wgmma_kernel"), ("flash_bwd", "wgmma_kernel"),
                      ("decode_attn", "split_kernel"), ("window_attn", "stream_kernel")):
        for entry, res in _build.kernel_resources(logs.get(lib, "")).items():
            if mark in entry:
                check(res["spill_bytes"] == 0, f"{entry} spills {res['spill_bytes']} bytes")
        # ptxas reports a wgmma it had to serialise only as an info line
        for ln in logs.get(lib, "").splitlines():
            if "C75" in ln:
                print(f"ptxas[{lib}] {ln.strip()}")

    cfg = phi3_clip_vlm(distill=True)
    batch = main_path_batch(cfg)
    offsets = batch["pad_offsets"].tolist()
    print(f"main-path pad offsets {offsets}")

    # 3. kernels vs plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = cfg.decoder
    slice_rec = kernel_case(
        "slice", BATCH, PROMPT_LEN, d.num_heads, d.num_kv_heads, d.head_dim,
        torch.bfloat16, True, offsets, [PROMPT_LEN] * BATCH, gen, fa, old=True,
    )
    kernel_case("gqa", 2, 1024, 32, 8, 128, torch.bfloat16, True, [0, 100], [1024, 1024], gen, fa)
    kernel_case("noncausal_kvlen", 2, 512, 16, 16, 64, torch.bfloat16, False, [0, 0], [512, 300], gen, fa)
    kernel_case("f32", 2, 256, 8, 8, 96, torch.float32, True, [0, 50], [256, 256], gen, fa)
    tbatch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ)
    train_lens = tbatch["seq_lengths"].tolist()
    print(f"training batch seq_lengths {train_lens}")
    train_fwd_rec = kernel_case(
        "train", TRAIN_BATCH, TRAIN_SEQ, d.num_heads, d.num_kv_heads, d.head_dim,
        torch.bfloat16, True, [0] * TRAIN_BATCH, train_lens, gen, fa, old=True,
    )
    dq_rec, dkv_rec = bwd_case(
        "train", TRAIN_BATCH, TRAIN_SEQ, d.num_heads, d.num_kv_heads, d.head_dim, True,
        [0] * TRAIN_BATCH, train_lens, gen, fa,
    )
    gqa_dq, gqa_dkv = bwd_case("gqa", 2, 1024, 32, 8, 128, True, [0, 100], [1024, 900], gen, fa)
    win_recs = [
        window_case(i, w, heads, shifted, gen, wa, swin)
        for i, (w, heads) in enumerate(SWIN_STAGES) for shifted in (False, True)
    ]
    win_rec = win_recs[1]                       # stage 1, shifted: the largest launch
    # B4 in a train step: every Swin-L block launches once per teacher
    # micro-batch of 2, the odd blocks of each stage shifted
    win_step = dict(ms=0.0, library_ms=0.0, bound_ms=0.0, launches=0)
    for rec, depth in zip(win_recs, [dd for dd in swin.SWIN_L.depths for _ in range(2)]):
        n_launch = depth // 2 * (TRAIN_BATCH // 2)
        win_step["launches"] += n_launch
        for key in ("ms", "library_ms", "bound_ms"):
            win_step[key] += n_launch * rec[key]
    print("window_attn per train step (launch-weighted; CUDA graphs) " + json.dumps(win_step))
    # B5 at the quantized serving path's linears: prefill (M = B8 x T768) and
    # decode (M = 8); lm_head runs at M = 8 only (prefill keeps the last row)
    h_, m_, v_ = d.hidden_size, d.mlp_dim, d.vocab_size
    w4_recs = {}
    for lname, din, dout in (("qkvo", h_, d.num_heads * d.head_dim), ("gate_up", h_, m_),
                             ("down", m_, h_)):
        for m in (BATCH, BATCH * PROMPT_LEN):
            key = f"{lname}_M{m}"
            w4_recs[key] = w4_case(key, m, din, dout, gen, qm, param)
    w4_recs["lm_head_M8"] = w4_case("lm_head_M8", BATCH, h_, v_, gen, qm, param)
    w4_recs["gate_up_M8_awq"] = w4_case("gate_up_M8_awq", BATCH, h_, m_, gen, qm, param, awq=True)
    w4_rec = w4_recs[f"gate_up_M{BATCH * PROMPT_LEN}"]
    # B6 at the decode shape (this Generator's max_len 896, the last decode
    # step's lengths 800 over the main path's left pads) in bf16 and int8, and
    # GQA 32/8 H128 with a fully masked row (batch row 2)
    serve_max_len = -(-(PROMPT_LEN + NEW_TOKENS + 1) // 128) * 128
    dec_lens = [PROMPT_LEN + NEW_TOKENS] * BATCH
    dec_bf16 = decode_case("decode_bf16", BATCH, d.num_heads, d.num_kv_heads, d.head_dim,
                           serve_max_len, False, offsets, dec_lens, gen, da, quantize_head_vectors)
    dec_rec = decode_case("decode_int8", BATCH, d.num_heads, d.num_kv_heads, d.head_dim,
                          serve_max_len, True, offsets, dec_lens, gen, da, quantize_head_vectors)
    for quant in (False, True):
        decode_case(f"decode_gqa_{'int8' if quant else 'bf16'}", 4, 32, 8, 128, 1024, quant,
                    [0, 100, 0, 0], [1024, 700, 0, 1024], gen, da, quantize_head_vectors)

    # 4. main path
    t0 = time.perf_counter()
    model = init_vlm(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"init_vlm {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params")
    gen_cfg = GenerationConfig(max_new_tokens=NEW_TOKENS)
    generator = Generator(model, cfg, gen_cfg, BATCH, PROMPT_LEN, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    da.launches = 0                             # B6: no path may call it (read after phase 9)
    t0 = time.perf_counter()
    outputs = generator.generate(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    check(launches == d.num_layers,
          f"flash kernel launched {launches} times in the main path, expected {d.num_layers}")
    check(len(outputs) == BATCH and all(len(o) == NEW_TOKENS for o in outputs),
          f"expected {BATCH}x{NEW_TOKENS} tokens, got {[len(o) for o in outputs]}")
    check(all(0 <= tok < d.vocab_size for o in outputs for tok in o), "token out of vocab")
    print(f"main path: {launches} flash launches, {BATCH}x{NEW_TOKENS} tokens, "
          f"first run {first_s:.3f} s, peak {peak / 2**30:.2f} GiB")
    print(f"sample tokens {outputs[0][:8]} ... {outputs[-1][:8]}")

    # prefill logits: kernel path vs plain attention
    # [0]: the logits only; a cache kept in `_` would hold 1.4 GB to the end
    logits_k = generator.prefill(batch)[0]
    logits_p = generator.prefill(batch, use_kernel=False)[0]
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits_k).all()), "prefill logits not finite")
    check(tuple(logits_k.shape) == (BATCH, d.vocab_size), f"logits shape {tuple(logits_k.shape)}")
    diff = (logits_k - logits_p).abs().max().item()
    scale = logits_p.abs().max().item()
    agree = int((logits_k.argmax(-1) == logits_p.argmax(-1)).sum())
    print(f"prefill logits kernel vs plain: max abs diff {diff:.4g}, max |logit| {scale:.4g}, "
          f"argmax agree {agree}/{BATCH}")
    check(diff <= 0.05 * scale, f"prefill logits differ by {diff} > 0.05 x {scale}")

    # the decode slot lives on the device: the same prefill and cache decoded
    # with a Python-int q_offset must give the same tokens, bit for bit
    logits_s, cache_s = generator.prefill(batch)
    first = logits_s.argmax(-1)
    cache_i = type(cache_s)(*(t.clone() for t in vars(cache_s).values()))
    offs = torch.as_tensor(batch["pad_offsets"], device="cuda").long()
    chunk = gen_cfg.decode_chunk
    step, tok, slot_toks = torch.zeros((), dtype=torch.long, device="cuda"), first, []
    for _ in range(-(-(NEW_TOKENS - 1) // chunk)):
        slot_toks.append(generator._decode_chunk(cache_s, tok, step, offs,
                                                 torch.Generator(device="cuda")))
        tok, step = slot_toks[-1][-1], step + chunk
    slot_toks = torch.cat(slot_toks)
    int_toks = int_offset_decode(generator, cache_i, first, offs, slot_toks.shape[0])
    check(torch.equal(slot_toks, int_toks),
          f"device-slot decode differs from the int-offset decode at "
          f"{int((slot_toks != int_toks).sum())} of {slot_toks.numel()} tokens")
    check(torch.equal(cache_s.k, cache_i.k) and torch.equal(cache_s.v, cache_i.v),
          "device-slot and int-offset decodes wrote different caches")
    gen_toks = torch.cat([first[None], slot_toks])[:NEW_TOKENS].T.tolist()
    check(gen_toks == outputs, "generate() differs from its own prefill + decode chunks")
    print(f"device-slot decode: {slot_toks.shape[0]} x {BATCH} tokens and the cache equal to "
          f"the int-offset decode's, bit for bit")
    del logits_s, cache_s, cache_i

    timing = dict(timed_generate(generator, batch, gen_cfg), peak_gib=peak / 2**30)
    print("main_path " + json.dumps(timing))

    # 5. where the time goes: device time by op for one prefill and one decode chunk
    logits, cache = generator.prefill(batch)
    token = logits.argmax(-1)
    offs = torch.as_tensor(batch["pad_offsets"], device="cuda").long()
    profile_window("prefill", lambda: generator.prefill(batch))
    profile_window("decode_chunk", lambda: generator._decode_chunk(
        cache, token, 0, offs, torch.Generator(device="cuda")))

    # 6. quantized serving: int8 KV + AWQ-calibrated w4a16 (B5), then int8 KV + w8a16
    t0 = time.perf_counter()
    with torch.no_grad():
        dev_batch = generator._to_device(batch)
        embeds = splice_embeddings(
            model, dev_batch["text_ids"].long(), dev_batch["token_type"],
            dev_batch["src_index"].long(), encode_images(model, dev_batch["images"]),
        )
    act_rms = decoder_act_rms(model.decoder, d, [embeds])
    torch.cuda.synchronize()
    del embeds
    print(f"calibration (decoder_act_rms, {BATCH}x{PROMPT_LEN} tokens) "
          f"{time.perf_counter() - t0:.2f} s")
    per_forward = 7 * d.num_layers + 1          # the block linears + lm_head
    quant_timing = {}
    for qname, wq in (("int4_awq", "int4"), ("w8a16", True)):
        q_cfg = GenerationConfig(max_new_tokens=NEW_TOKENS, kv_quant=True, weight_quant=wq,
                                 calibration=act_rms if wq == "int4" else None)
        t0 = time.perf_counter()
        q_gen = Generator(model, cfg, q_cfg, BATCH, PROMPT_LEN, device="cuda")
        torch.cuda.synchronize()
        print(f"quantize decoder ({qname}) {time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        qm.launches = 0
        t0 = time.perf_counter()
        q_out = q_gen.generate(batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        q_launches = qm.launches
        q_peak = torch.cuda.max_memory_allocated()
        check(len(q_out) == BATCH and all(len(o) == NEW_TOKENS for o in q_out),
              f"{qname}: expected {BATCH}x{NEW_TOKENS} tokens, got {[len(o) for o in q_out]}")
        check(all(0 <= tok < d.vocab_size for o in q_out for tok in o), f"{qname}: token out of vocab")
        forwards = 1 + -(-NEW_TOKENS // q_cfg.decode_chunk) * q_cfg.decode_chunk
        if wq == "int4":
            w4_launches = q_launches
            check(q_launches == per_forward * forwards,
                  f"w4 kernel launched {q_launches} times in the int4 generate, expected "
                  f"{per_forward} x {forwards} forwards")
            qm.launches = 0
            logits_q, cache_q = q_gen.prefill(batch)
            check(qm.launches == per_forward, f"w4 launches per prefill {qm.launches} != {per_forward}")
            offs = torch.as_tensor(batch["pad_offsets"], device="cuda").long()
            qm.launches = 0
            q_gen._decode_chunk(cache_q, logits_q.argmax(-1), 0, offs, torch.Generator(device="cuda"))
            torch.cuda.synchronize()
            check(qm.launches == per_forward * q_cfg.decode_chunk,
                  f"w4 launches per decode chunk {qm.launches} != {per_forward} x {q_cfg.decode_chunk}")
            logits_p = q_gen.prefill(batch, use_kernel=False)[0]
            torch.cuda.synchronize()
            check(bool(torch.isfinite(logits_q).all()), "int4 prefill logits not finite")
            diff = (logits_q - logits_p).abs().max().item()
            scale = logits_p.abs().max().item()
            agree = int((logits_q.argmax(-1) == logits_p.argmax(-1)).sum())
            print(f"int4 prefill logits kernels vs plain: max abs diff {diff:.4g}, max |logit| "
                  f"{scale:.4g}, argmax agree {agree}/{BATCH}")
            check(diff <= 0.05 * scale, f"int4 prefill logits differ by {diff} > 0.05 x {scale}")
            drift = ((logits_q - logits_k).square().mean().sqrt()
                     / logits_k.square().mean().sqrt()).item()
            agree_bf16 = int((logits_q.argmax(-1) == logits_k.argmax(-1)).sum())
            print(f"int4 vs bf16 prefill logits: relative RMS drift {drift:.4g}, argmax agree "
                  f"{agree_bf16}/{BATCH} (printed only: int4 is a quality trade-off)")
            prof = dict(
                prefill=profile_window("int4_prefill", lambda: q_gen.prefill(batch), match=("w4_",)),
                decode_chunk=profile_window("int4_decode_chunk", lambda: q_gen._decode_chunk(
                    cache_q, logits_q.argmax(-1), 0, offs, torch.Generator(device="cuda")),
                    match=("w4_",)))
            print("int4_profile " + json.dumps(prof))
            del logits_q, logits_p, cache_q
        print(f"{qname}: {BATCH}x{NEW_TOKENS} tokens, first run {first_s:.3f} s, "
              f"{q_launches} w4 launches, peak {q_peak / 2**30:.2f} GiB")
        print(f"{qname} sample tokens {q_out[0][:8]} ... {q_out[-1][:8]}")
        quant_timing[qname] = dict(timed_generate(q_gen, batch, q_cfg), peak_gib=q_peak / 2**30)
        print(f"quant_path_{qname} " + json.dumps(quant_timing[qname]))
        del q_gen
        gc.collect()
        torch.cuda.empty_cache()

    # 7. training path: config #1's PT step with the three teachers
    del generator, model, logits, cache
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = init_vlm(cfg, device="cuda", seed=0)
    teachers = init_teachers(cfg, device="cuda", seed=7)
    opt_cfg = OptimizerConfig(learning_rate=1e-3, total_steps=1000, stage="pretrain")
    step = make_train_step(cfg, opt_cfg, model, teacher_fn=make_teacher_fn(cfg),
                           teacher_params=teachers, remat=False)
    torch.cuda.synchronize()
    print(f"training init {time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B student params "
          f"({sum(p.numel() for p in step.trainable.values()) / 1e6:.1f} M trainable), "
          f"{sum(p.numel() for p in teachers.parameters()) / 1e9:.3f} B teacher params")
    frozen = model.decoder.blocks[0].q_proj.weight
    frozen_before = frozen.detach().clone()
    n_swin = sum(teachers["swin"].cfg.depths)
    expected = dict(flash_fwd=d.num_layers, flash_bwd_dq=d.num_layers,
                    flash_bwd_dkv=d.num_layers, window_attn=n_swin * TRAIN_BATCH // 2)

    def reset_counts():
        fa.launches = fa.dq_launches = fa.dkv_launches = wa.launches = 0

    def counts():
        return dict(flash_fwd=fa.launches, flash_bwd_dq=fa.dq_launches,
                    flash_bwd_dkv=fa.dkv_launches, window_attn=wa.launches)

    t0 = time.perf_counter()
    metrics = step(tbatch)                      # warm-up: update 1, lr 0
    print(f"train step 1 (warm-up) {(time.perf_counter() - t0) * 1e3:.1f} ms "
          + json.dumps(metrics))
    losses = [metrics["loss"]]
    torch.cuda.reset_peak_memory_stats()
    train_launches = {k: 0 for k in expected}
    step_ms = []
    for i in range(TRAIN_STEPS):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(tbatch)                  # ends in a host read of the metrics
        step_ms.append((time.perf_counter() - t0) * 1e3)
        c = counts()
        check(c == expected, f"train step {i + 2}: launches {c}, expected {expected}")
        for kname in c:
            train_launches[kname] += c[kname]
        losses.append(metrics["loss"])
        print(f"train step {i + 2}: {step_ms[-1]:.1f} ms, launches {c} " + json.dumps(metrics))
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(all(losses[i + 1] != losses[i] for i in range(1, len(losses) - 1)),
          f"loss did not change from step 2 on: {losses}")
    check(torch.equal(frozen, frozen_before), "a frozen decoder weight changed")
    mean_ms = sum(step_ms) / len(step_ms)
    train = dict(step_ms=step_ms, mean_step_ms=mean_ms,
                 examples_per_s=TRAIN_BATCH / (mean_ms / 1e3), peak_gib=peak / 2**30,
                 losses=losses, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    print("train_path " + json.dumps(train))

    # the kernel step vs the same step with plain attention, at B1
    b1 = step.to_device({k: v[:1] for k, v in tbatch.items()})
    names = list(step.trainable)

    def kernel_or_plain(use_kernel):
        loss_fn = make_loss_fn(cfg, teacher_fn=make_teacher_fn(cfg, use_kernel=use_kernel),
                               use_kernel=use_kernel, remat=False)
        return loss_and_grads(loss_fn, model, b1, teachers, [step.trainable[n] for n in names])

    loss_k, grads_k = kernel_or_plain(None)
    loss_p, grads_p = kernel_or_plain(False)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    min_cos, min_name, n_cmp = grad_agreement(names, grads_k, grads_p)
    del grads_k, grads_p
    print(f"train B1 kernel vs plain: loss {loss_k:.6f} vs {loss_p:.6f} (rel {rel:.3g}), "
          f"min grad cosine {min_cos:.6f} ({min_name}) over {n_cmp} tensors")
    check(rel <= 1e-3, f"B1 loss kernel vs plain differs by {rel:.3g} > 1e-3")
    check(min_cos >= 0.999, f"B1 grad cosine {min_cos} < 0.999 for {min_name}")

    # where the training step's time goes
    train_prof = profile_window("train_step", lambda: step(tbatch), top=15,
                                match=("flash_bwd", "window_attn_stream"))
    print("train_profile " + json.dumps(train_prof))
    check(train_prof["window_attn_stream"]["launches"] == expected["window_attn"],
          f"the profiled step ran {train_prof['window_attn_stream']['launches']} window "
          f"kernels, expected {expected['window_attn']}")
    # 8. trainer path: remat policies, trainer.train with accumulation,
    # checkpoint and resume, the chunked cross-entropy, master weights
    del step
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trainer = trainer_phase(cfg, model, teachers, tbatch, reset_counts, counts)
    print(f"trainer phase {time.perf_counter() - t0:.1f} s")
    print("trainer_path " + json.dumps(trainer))

    # 9. the continuous-batching engine at bench_engine.py's defaults, the
    # batch loop beside it, prefix caching, chunked prefill, speculative and
    # beam decoding, an int4 engine run. The decoder is frozen in phases 7-8:
    # it is phase 4's
    del teachers
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = engine_phase(cfg, model, act_rms, fa, qm)
    print(f"engine phase {time.perf_counter() - t0:.1f} s")
    print("engine_path " + json.dumps(engine))

    # 10. the user API at Llama-3-8B + CLIP-L: export/import, chat, serve,
    # ChatSession, the file round trip, Vicuna-7B. Phases 4-9's models go first
    del model, act_rms
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    api, api_state = api_phase(fa, qm, da, param, gen)
    print(f"api phase {time.perf_counter() - t0:.1f} s")
    print("api_path " + json.dumps({k: v for k, v in api.items() if k not in ("b1", "b5")}))

    # 11. the vision side at Llama-3-8B: the ConvNeXt-XXL tower and a chat
    # through it, an anyres chat, an S2 call; a PT step of the convnext cell
    t0 = time.perf_counter()
    vision = vision_phase(api_state, fa, qm, wa, gen, smi)
    print(f"vision phase {time.perf_counter() - t0:.1f} s")
    print("vision_path " + json.dumps(
        {k: v for k, v in vision.items() if k not in ("b1_convnext", "b1_anyres")}))

    # 12. training from the recipes through the CLI: PT at Llama-3-8B, IFT at
    # Phi3-mini with --init-from, the LoRA and vision-tower stages
    del api_state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recipe = recipe_phase(fa, wa, smi)
    print(f"recipe phase {time.perf_counter() - t0:.1f} s")
    print("recipe_path " + json.dumps(recipe))
    dec_launches = da.launches                  # over phases 4-12
    print(f"decode_attn launches over the serving, training, engine, api, vision and recipe "
          f"paths: {dec_launches}")
    check(dec_launches == 0, f"decode_attn launched {dec_launches} times; no path calls it")

    def entry(kname, source, replaces, rec, launches):
        return dict(
            name=kname, route="cuda", source=source, replaces=replaces, launches=launches,
            max_abs_err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=rec["library_ms"],
        )

    csrc = "visper_lm_tpu_torch/csrc/"
    w4_decode = w4_recs[f"gate_up_M{BATCH}"]
    main_launches = trainer["trainer"]["launches"]   # trainer.train, the main path
    kernels = [
        dict(entry("flash_fwd", csrc + "flash_fwd.cu", "visper_lm_tpu/ops/flash_attention.py:234",
                   slice_rec, main_launches["flash_fwd"]),
             launches_serving=launches, launches_phase7=train_launches["flash_fwd"],
             launches_engine=engine["engine"]["flash_launches"],
             shape=slice_rec["shape"], kernel=slice_rec["kernel"],
             mma_sync_ms=slice_rec["mma_sync_ms"],
             llama3=dict({k: api["b1"][k] for k in LLAMA3_KEYS},
                         launches=api["chat"]["bf16"]["b1_launches"],
                         library="SDPA, boolean mask, enable_gqa=True"),
             convnext_chat=dict({k: vision["b1_convnext"][k] for k in LLAMA3_KEYS},
                                launches=vision["convnext_chat"]["b1_launches"]),
             anyres_chat=dict({k: vision["b1_anyres"][k] for k in LLAMA3_KEYS},
                              launches=vision["anyres_chat"]["b1_launches"]),
             launches_convnext_pt_step=vision["convnext_pt_step"]["launches"]["flash_fwd"],
             launches_recipe_pt=recipe["pt"]["launches"]["flash_fwd"],
             launches_recipe_ift=recipe["ift"]["launches"]["flash_fwd"],
             train=dict(shape=train_fwd_rec["shape"], ms=train_fwd_rec["ms"],
                        mma_sync_ms=train_fwd_rec["mma_sync_ms"],
                        library_ms=train_fwd_rec["library_ms"],
                        bound_ms=train_fwd_rec["bound_ms"])),
        dict(entry("flash_bwd_dq", csrc + "flash_bwd.cu", "visper_lm_tpu/ops/flash_attention.py:497",
                   dq_rec, main_launches["flash_bwd_dq"]),
             launches_phase7=train_launches["flash_bwd_dq"], shape=dq_rec["shape"], kernel=dq_rec["kernel"], device_ms=dq_rec["device_ms"],
             launches_recipe_pt=recipe["pt"]["launches"]["flash_bwd_dq"],
             launches_recipe_ift=recipe["ift"]["launches"]["flash_bwd_dq"],
             library="SDPA backward (dq, dk and dv in one call)",
             gqa=dict(shape=gqa_dq["shape"], ms=gqa_dq["ms"], device_ms=gqa_dq["device_ms"],
                      library_ms=gqa_dq["library_ms"], bound_ms=gqa_dq["bound_ms"])),
        dict(entry("flash_bwd_dkv", csrc + "flash_bwd.cu", "visper_lm_tpu/ops/flash_attention.py:562",
                   dkv_rec, main_launches["flash_bwd_dkv"]),
             launches_phase7=train_launches["flash_bwd_dkv"], shape=dkv_rec["shape"], kernel=dkv_rec["kernel"], device_ms=dkv_rec["device_ms"],
             launches_recipe_pt=recipe["pt"]["launches"]["flash_bwd_dkv"],
             launches_recipe_ift=recipe["ift"]["launches"]["flash_bwd_dkv"],
             library="SDPA backward (dq, dk and dv in one call)",
             gqa=dict(shape=gqa_dkv["shape"], ms=gqa_dkv["ms"], device_ms=gqa_dkv["device_ms"],
                      library_ms=gqa_dkv["library_ms"], bound_ms=gqa_dkv["bound_ms"])),
        dict(entry("window_attn", csrc + "window_attn.cu", "visper_lm_tpu/ops/window_attention.py:112",
                   win_rec, main_launches["window_attn"]),
             launches_phase7=train_launches["window_attn"], shape=win_rec["shape"], kernel=win_rec["kernel"], timing=win_rec["timing"],
             launches_recipe_pt=recipe["pt"]["launches"]["window_attn"],
             eager_ms=win_rec["eager_ms"],
             stages={r["case"]: dict(ms=r["ms"],
                                     library_ms=r["library_ms"], bound_ms=r["bound_ms"],
                                     max_abs_err=r["max_abs_err"]) for r in win_recs},
             per_train_step=win_step, profile_ms_per_train_step=train_prof["window_attn_stream"]["ms"]),
        dict(entry("w4_matmul", csrc + "w4_matmul.cu", "visper_lm_tpu/ops/quant_matmul.py:125",
                   w4_rec, w4_launches),
             shape=w4_rec["shape"], launches_per_forward=per_forward,
             launches_engine=engine["int4_engine"]["w4_launches"],
             mma_sync_ms=w4_rec["mma_sync_ms"],
             llama3=dict({case: {k: rec[k] for k in LLAMA3_KEYS + ("cold_ms", "library_cold_ms")
                                 if k in rec}
                          for case, rec in api["b5"].items()},
                         launches=api["chat"]["int4"]["b5_launches"]),
             decode=dict(shape=w4_decode["shape"], ms=w4_decode["ms"],
                         device_ms=w4_decode["device_ms"], cold_ms=w4_decode["cold_ms"],
                         mma_sync_ms=w4_decode["mma_sync_ms"],
                         mma_sync_cold_ms=w4_decode["mma_sync_cold_ms"],
                         bound_ms=w4_decode["bound_ms"], library_ms=w4_decode["library_ms"],
                         library_cold_ms=w4_decode["library_cold_ms"])),
        dict(entry("decode_attn", csrc + "decode_attn.cu",
                   "visper_lm_tpu/ops/decode_attention.py:188", dec_rec, dec_launches),
             shape=dec_rec["shape"], timing="ms, library_ms: CUDA graphs over caches that exceed L2",
             device_ms=dec_rec["device_ms"], eager_ms=dec_rec["eager_ms"],
             serial_cold_ms=dec_rec["serial_cold_ms"],
             bf16=dict(shape=dec_bf16["shape"], ms=dec_bf16["ms"], device_ms=dec_bf16["device_ms"],
                       serial_cold_ms=dec_bf16["serial_cold_ms"], bound_ms=dec_bf16["bound_ms"],
                       library_ms=dec_bf16["library_ms"]),
             note="standalone op: no path calls it, as in the JAX package"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
