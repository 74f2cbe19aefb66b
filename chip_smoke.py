#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (visper_lm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:
  1. environment: torch, CUDA, Triton, nvcc, the card's name and power limit;
  2. build: nvcc compiles every kernel from visper_lm_tpu_torch/csrc;
  3. kernels: each kernel vs its plain PyTorch version on the card, on the rows
     that have at least one valid key (bf16 max abs error <= 2e-2 against the
     plain version computed in f32; f32 <= 1e-4), with the kernel's, the plain
     version's and one library call's time (the library call is a yardstick
     only; the port never calls it) beside the least time the card could take;
  4. main path: Phi3-mini-4k + CLIP-ViT-L/14-336 (distill task tokens) at full
     width with seeded random weights serves 8 left-padded multimodal prompts
     (768 tokens) through `Generator.generate`, greedy, 32 new tokens. The
     flash kernel must launch exactly once per decoder layer (32) in that run,
     and the prefill logits must match a prefill with plain attention within
     0.05 x max|logits| (bf16 through 32 layers).

The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Needs no network; builds into
visper_lm_tpu_torch/_build/.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 SIMT

BATCH, PROMPT_LEN, NEW_TOKENS = 8, 768, 32
TEXT_LENS = (155, 140, 121, 96, 77, 50, 31, 12)   # 13 sys + 600 image/task + text <= 768


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


def attention_flops(b, t, nq, h, causal, starts, lens) -> float:
    """FLOPs this data needs: 4*H per unmasked (query row, key) pair and head
    (q.k and p.v), counting only keys in [start, length) and, when causal,
    at or before the row."""
    rows = torch.arange(t)
    pairs = 0
    for i in range(b):
        hi = torch.clamp(rows + 1, max=lens[i]) if causal else torch.full((t,), lens[i])
        pairs += int(torch.clamp(hi - starts[i], min=0).sum())
    return 4.0 * h * nq * pairs


def kernel_case(name, b, t, nq, nkv, h, dtype, causal, starts, lens, gen, fa):
    """Kernel vs plain version on one case; returns the measured record."""
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

    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw), 20)
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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    rec = dict(
        case=name, shape=f"B{b} T{t} {nq}/{nkv} H{h} {str(dtype)[6:]} "
        f"{'causal' if causal else 'noncausal'}",
        max_abs_err=err, lse_max_abs_err=lse_err, tol=tol, ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        tflops=flops / ms * 1e-9, gbytes_s=nbytes / ms * 1e-6,
    )
    print("kernel_case " + json.dumps(rec))
    return rec


def profile_window(name: str, fn, top: int = 10) -> None:
    """Device time of one call of fn by kernel (torch.profiler), and the
    device's idle share of the same call's wall time timed without the
    profiler (the profiler slows the host)."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from visper_lm_tpu_torch.config import phi3_clip_vlm
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.ops import _build
    from visper_lm_tpu_torch.ops import flash_attention as fa
    from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator

    # reference settings: f32 matmuls in full f32, no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment
    environment(_build)
    name = torch.cuda.get_device_name(0)

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for lib, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
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
        torch.bfloat16, True, offsets, [PROMPT_LEN] * BATCH, gen, fa,
    )
    kernel_case("gqa", 2, 1024, 32, 8, 128, torch.bfloat16, True, [0, 100], [1024, 1024], gen, fa)
    kernel_case("noncausal_kvlen", 2, 512, 16, 16, 64, torch.bfloat16, False, [0, 0], [512, 300], gen, fa)
    kernel_case("f32", 2, 256, 8, 8, 96, torch.float32, True, [0, 50], [256, 256], gen, fa)

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
    logits_k, _ = generator.prefill(batch)
    logits_p, _ = generator.prefill(batch, use_kernel=False)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits_k).all()), "prefill logits not finite")
    check(tuple(logits_k.shape) == (BATCH, d.vocab_size), f"logits shape {tuple(logits_k.shape)}")
    diff = (logits_k - logits_p).abs().max().item()
    scale = logits_p.abs().max().item()
    agree = int((logits_k.argmax(-1) == logits_p.argmax(-1)).sum())
    print(f"prefill logits kernel vs plain: max abs diff {diff:.4g}, max |logit| {scale:.4g}, "
          f"argmax agree {agree}/{BATCH}")
    check(diff <= 0.05 * scale, f"prefill logits differ by {diff} > 0.05 x {scale}")

    # timings (warm)
    t0 = time.perf_counter()
    generator.prefill(batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    generator.generate(batch)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    steps = -(-NEW_TOKENS // gen_cfg.decode_chunk) * gen_cfg.decode_chunk
    decode_ms = (gen_s - prefill_s) / steps * 1e3
    timing = dict(
        prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_ms,
        generate_s=gen_s, tokens_per_s=BATCH * NEW_TOKENS / gen_s,
        peak_gib=peak / 2**30, decode_steps=steps,
    )
    print("main_path " + json.dumps(timing))

    # 5. where the time goes: device time by op for one prefill and one decode chunk
    logits, cache = generator.prefill(batch)
    token = logits.argmax(-1)
    offs = torch.as_tensor(batch["pad_offsets"], device="cuda").long()
    profile_window("prefill", lambda: generator.prefill(batch))
    profile_window("decode_chunk", lambda: generator._decode_chunk(
        cache, token, 0, offs, torch.Generator(device="cuda")))

    kernels = [dict(
        name="flash_fwd", route="cuda", source="visper_lm_tpu_torch/csrc/flash_fwd.cu",
        replaces="visper_lm_tpu/ops/flash_attention.py:234", launches=launches,
        max_abs_err=slice_rec["max_abs_err"], ms=slice_rec["ms"],
        plain_ms=slice_rec["plain_ms"], bound_ms=slice_rec["bound_ms"],
        bound_by=slice_rec["bound_by"], library_ms=slice_rec["library_ms"],
    )]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
