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
          it, and its launch count over phases 4-7 must stay 0) at the decode
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
     0.05 x max|logits| (bf16 through 32 layers);
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
     rounded to its dtype.

The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Needs no network; builds into
visper_lm_tpu_torch/_build/.
"""

from __future__ import annotations

import ctypes
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
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


def timed_generate(generator, batch, gen_cfg):
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
        generate_s=gen_s, tokens_per_s=BATCH * NEW_TOKENS / gen_s, decode_steps=steps,
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
    side = cfg.vision.image_size
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
    out = dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3, idle_share=1 - busy_us / wall_us)
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
    environment(_build)
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
    da.launches = 0                             # B6: no path may call it (read after phase 7)
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
            logits_p, _ = q_gen.prefill(batch, use_kernel=False)
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
    del generator, model, logits, cache, act_rms
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
    dec_launches = da.launches                  # over phases 4-8: bf16, int4, w8a16, training
    print(f"decode_attn launches over the serving and training paths: {dec_launches}")
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
             shape=slice_rec["shape"], kernel=slice_rec["kernel"],
             mma_sync_ms=slice_rec["mma_sync_ms"],
             train=dict(shape=train_fwd_rec["shape"], ms=train_fwd_rec["ms"],
                        mma_sync_ms=train_fwd_rec["mma_sync_ms"],
                        library_ms=train_fwd_rec["library_ms"],
                        bound_ms=train_fwd_rec["bound_ms"])),
        dict(entry("flash_bwd_dq", csrc + "flash_bwd.cu", "visper_lm_tpu/ops/flash_attention.py:497",
                   dq_rec, main_launches["flash_bwd_dq"]),
             launches_phase7=train_launches["flash_bwd_dq"], shape=dq_rec["shape"], kernel=dq_rec["kernel"], device_ms=dq_rec["device_ms"],
             library="SDPA backward (dq, dk and dv in one call)",
             gqa=dict(shape=gqa_dq["shape"], ms=gqa_dq["ms"], device_ms=gqa_dq["device_ms"],
                      library_ms=gqa_dq["library_ms"], bound_ms=gqa_dq["bound_ms"])),
        dict(entry("flash_bwd_dkv", csrc + "flash_bwd.cu", "visper_lm_tpu/ops/flash_attention.py:562",
                   dkv_rec, main_launches["flash_bwd_dkv"]),
             launches_phase7=train_launches["flash_bwd_dkv"], shape=dkv_rec["shape"], kernel=dkv_rec["kernel"], device_ms=dkv_rec["device_ms"],
             library="SDPA backward (dq, dk and dv in one call)",
             gqa=dict(shape=gqa_dkv["shape"], ms=gqa_dkv["ms"], device_ms=gqa_dkv["device_ms"],
                      library_ms=gqa_dkv["library_ms"], bound_ms=gqa_dkv["bound_ms"])),
        dict(entry("window_attn", csrc + "window_attn.cu", "visper_lm_tpu/ops/window_attention.py:112",
                   win_rec, main_launches["window_attn"]),
             launches_phase7=train_launches["window_attn"], shape=win_rec["shape"], kernel=win_rec["kernel"], timing=win_rec["timing"],
             eager_ms=win_rec["eager_ms"],
             stages={r["case"]: dict(ms=r["ms"],
                                     library_ms=r["library_ms"], bound_ms=r["bound_ms"],
                                     max_abs_err=r["max_abs_err"]) for r in win_recs},
             per_train_step=win_step, profile_ms_per_train_step=train_prof["window_attn_stream"]["ms"]),
        dict(entry("w4_matmul", csrc + "w4_matmul.cu", "visper_lm_tpu/ops/quant_matmul.py:125",
                   w4_rec, w4_launches),
             shape=w4_rec["shape"], launches_per_forward=per_forward,
             mma_sync_ms=w4_rec["mma_sync_ms"],
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
