"""The fit of one training step on one card (counterpart of
visper_lm_tpu/train/aot.py).

JAX proves a configuration fits by compiling it ahead of time and reading
XLA's memory analysis. PyTorch has no compile-time memory analysis, so the
port's evidence has two parts behind JAX's command line:

  * a static breakdown: the model (and the teachers) built on the `meta`
    device, nothing allocated, and the bytes of each group counted from the
    shapes and dtypes: the trainable parameters, the optimizer state (the
    first moment in `--mu-dtype`, the second in each parameter's dtype, f32
    master weights with `--master-weights`) split into what stays on the card
    and what `--offload-opt` puts in host memory (`plan_offload_layout`),
    the gradients (with `--stream-grads` the decoder blocks' go to the host),
    the frozen parameters, the teachers and the batch, under JAX's keys
    (`params_gib_per_chip`, `opt_state_gib_per_chip`, ...);
  * `--run`: on the card, the model made from a seed, one warm-up step and
    one measured step of that configuration on a batch of full-length
    sequences: what the allocator holds once the model and the optimizer
    are set up as `resident_hbm_gib` (the reading the static weights and
    on-card state are held to), `torch.cuda.max_memory_allocated` as
    `peak_hbm_gib`, the page-locked host GiB, the step's and the update's
    ms. The breakdown counts no activations: whether a configuration fits
    is what `--run` shows, or its torch.OutOfMemoryError.

    python -m visper_lm_tpu_torch.train.aot --model llama3 --stage finetune \\
        --batch 4 --seq 4096 --offload-opt --stream-grads 8 [--run]

With `--dp N --tp M` the breakdown is one rank's of the N x M processes,
as JAX's is one chip's of its mesh: the decoder's Megatron leaves
(parallel/tensor.py) are the rank's 1/M slices, and ZeRO's plan
(parallel/sharding.plan_zero, JAX's specs on JAX's stacked shapes) splits
each sharded leaf over the N ranks of a data group, so its bytes are
divided by N: the moments always (ZeRO-1/2), the trainables unless
`--no-zero3` (ZeRO-3, on by default as in JAX), the frozen parameters with
`--zero-frozen`; `--shard-teachers` divides the teachers' large leaves by M
(`teacher_placements`). The gradients stay whole on every rank (of its
tp-local tensors) until the step's reduce. `--run` measures one process
(dp 1, tp 1). `--topology` names a TPU slice (JAX compiles for it without
the chips); it has no counterpart on GPUs and raises a ValueError: the
device count is `--dp` x `--tp`. `--no-pallas` builds `--run`'s step with
the decoder's attention on the plain path (JAX lowers with its kernels
off; the teachers are built as JAX's are, unchanged by the flag);
`--unrolled-staging` is taken and does nothing, as in JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

GIB = 1024 ** 3


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def batch_bytes(cfg, batch_size: int, seq_len: int, *, with_teachers: bool) -> int:
    """The step's batch as JAX's `build_abstract_batch` describes it: four
    (B, T) int32 sequences, (B,) lengths, (B, H, W, 3) f32 images, and in a
    distillation stage the task masks and the teachers' pixels (or the
    targets)."""
    b, t, img = batch_size, seq_len, cfg.vision.image_size
    n = 4 * b * t * 4 + b * 4 + b * img * img * 3 * 4
    if cfg.distill is None:
        return n
    n += len(cfg.distill.tasks) * b * 4
    if with_teachers:
        n += sum(b * s * s * 3 * 4 for s in (336, 224, 768))
    else:
        n += sum(b * tc.target_tokens * tc.target_dim * 4 for tc in cfg.distill.tasks)
    return n


def static_breakdown(
    cfg, *, stage: str, batch_size: int, seq_len: int, with_teachers: bool = False,
    offload_opt_state: bool = False, stream_grads: int = 0, master_weights: bool = False,
    mu_dtype: str = "float32", block_bytes: int = 256 << 20, min_bytes: int = 1 << 20,
    dp: int = 1, zero_params: bool = False, zero_frozen: bool = False, tp: int = 1,
    shard_teachers: bool = False,
) -> Dict[str, int]:
    """Bytes by group (see the module docstring), from shapes alone; with
    dp x tp > 1 one rank's: the tp-local tensors, each ZeRO leaf's bytes
    divided by dp, the sharded teachers' by tp."""
    from visper_lm_tpu_torch.models.decoder import stream_chunk_ranges
    from visper_lm_tpu_torch.models.vlm import VLM
    from visper_lm_tpu_torch.parallel.sharding import ZeroPlan, plan_zero, teacher_placements
    from visper_lm_tpu_torch.parallel.tensor import TensorParallel, shard_model
    from visper_lm_tpu_torch.train.optimizer import trainable_mask
    from visper_lm_tpu_torch.train.staged_update import offload_shapes, plan_offload_layout
    from visper_lm_tpu_torch.utils.param import torch_dtype

    group = TensorParallel(None, 0, tp) if tp > 1 else None
    with torch.device("meta"):
        model = shard_model(VLM(cfg), group)
        teachers = None
        if with_teachers and cfg.distill is not None:
            from visper_lm_tpu_torch.models.teachers import build_teachers

            teachers = build_teachers(cfg)
    named = dict(model.named_parameters())
    mask = trainable_mask(named.items(), stage)
    trainable = {n: p for n, p in named.items() if mask[n]}
    moments, placed, _, _ = plan_zero(named, mask, dp, zero_params=zero_params,
                                      zero_frozen=zero_frozen, model_size=tp)

    def held(n: str) -> int:
        """The bytes of parameter n one rank keeps."""
        return _nbytes(named[n]) // placed[n].parts

    whole, specs, axis_sizes = offload_shapes(
        trainable, torch_dtype(mu_dtype), master_weights,
        ZeroPlan(None, 0, dp, moments, placed, tp=group))
    plan = (plan_offload_layout(whole, block_bytes=block_bytes, min_bytes=min_bytes,
                                specs=specs, axis_sizes=axis_sizes)
            if offload_opt_state else {k: None for k in whole})
    state = {k: int(np.prod(moments[k.split("/", 1)[1]].local_shape(
        trainable[k.split("/", 1)[1]].shape, 0))) * torch.empty((), dtype=d).element_size()
        for k, (_, d) in whole.items()}
    teacher_bytes = 0
    if teachers is not None:
        split = teacher_placements(teachers, tp) if shard_teachers and tp > 1 else {}
        teacher_bytes = sum(_nbytes(p) // (split[n].model_parts if n in split else 1)
                            for n, p in teachers.named_parameters())
    streamed = set()
    if stream_grads:
        from visper_lm_tpu_torch.models.vlm import tap_layer_union

        ranges = stream_chunk_ranges(cfg.decoder.num_layers, stream_grads, tap_layer_union(cfg))
        layers = range(ranges[0][0], ranges[-1][1])
        streamed = {n for n in trainable
                    if any(n.startswith(f"decoder.blocks.{i}.") for i in layers)}
    return {
        "params": sum(held(n) for n in trainable),
        "opt_state": sum(state.values()),
        "opt_state_device": sum(v for k, v in state.items() if plan[k] is None),
        "opt_state_host": sum(v for k, v in state.items() if plan[k] is not None),
        "grads_device": sum(_nbytes(p) for n, p in trainable.items() if n not in streamed),
        "grads_host": sum(_nbytes(p) for n, p in trainable.items() if n in streamed),
        "frozen": sum(held(n) for n in named if not mask[n]),
        "teachers": teacher_bytes,
        "batch": batch_bytes(cfg, batch_size, seq_len, with_teachers=with_teachers),
    }


def full_length_batch(cfg, batch_size: int, seq_len: int, *, with_teachers: bool,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """A batch of sequences that fill seq_len: the system prompt, the image
    and random text, every text token supervised (numpy, from `seed`)."""
    from visper_lm_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from visper_lm_tpu_torch.data.collate import build_splice_plan, collate_plans

    rng = np.random.default_rng(seed)
    vocab, ns = cfg.decoder.vocab_size, cfg.num_sys_tokens
    ntask = cfg.distill.num_task_tokens * len(cfg.distill.task_order()) if cfg.distill else 0
    text = seq_len - ns - cfg.num_image_tokens - ntask
    plans = []
    for _ in range(batch_size):
        ids = (list(rng.integers(3, vocab - 10, size=ns)) + [IMAGE_TOKEN_INDEX]
               + list(rng.integers(3, vocab - 10, size=text)))
        labels = [IGNORE_INDEX] * (ns + 1) + ids[ns + 1:]
        plans.append(build_splice_plan(
            ids, labels, seq_len, num_image_tokens=cfg.num_image_tokens,
            num_task_tokens=cfg.distill.num_task_tokens if cfg.distill else 0,
            num_tasks=len(cfg.distill.task_order()) if cfg.distill else 0,
        ))
    side = cfg.vision.image_size
    batch = collate_plans(plans, images=rng.normal(size=(batch_size, side, side, 3)).astype(np.float32))
    if cfg.distill is not None:
        for tc in cfg.distill.tasks:
            batch[f"{tc.task}_mask"] = np.ones((batch_size,), np.float32)
            if not with_teachers:
                batch[f"{tc.task}_target"] = rng.normal(
                    size=(batch_size, tc.target_tokens, tc.target_dim)).astype(np.float32)
        if with_teachers:
            for key, size in (("depth_images", 336), ("gen_images", 224), ("seg_images", 768)):
                batch[key] = rng.normal(size=(batch_size, size, size, 3)).astype(np.float32)
    return batch


def run_step(cfg, *, stage: str, batch_size: int, seq_len: int, with_teachers: bool,
             offload_opt_state: bool, stream_grads: int, master_weights: bool, mu_dtype: str,
             remat_policy: Optional[str], learning_rate: float, blockwise_staging: bool,
             block_bytes: int, scan_chunks: bool, device: str = "cuda",
             use_kernel: Optional[bool] = None) -> Dict[str, Any]:
    """One warm-up and one measured step on `device` (module docstring);
    use_kernel=False: the decoder's attention on the plain path."""
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.train.optimizer import OptimizerConfig
    from visper_lm_tpu_torch.train.train_step import make_train_step

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    model = init_vlm(cfg, device=dev, seed=0)
    weights = sum(_nbytes(p) for p in model.parameters())
    teacher_fn = teachers = None
    if with_teachers and cfg.distill is not None:
        from visper_lm_tpu_torch.models.teachers import init_teachers, make_teacher_fn

        teachers = init_teachers(cfg, device=dev, seed=7)
        teacher_fn = make_teacher_fn(cfg)
    opt_cfg = OptimizerConfig(learning_rate=learning_rate, total_steps=1000, stage=stage,
                              master_weights=master_weights, mu_dtype=mu_dtype)
    step = make_train_step(cfg, opt_cfg, model, teacher_fn=teacher_fn, teacher_params=teachers,
                           remat_policy=remat_policy, offload_opt_state=offload_opt_state,
                           blockwise_staging=blockwise_staging, block_bytes=block_bytes,
                           scan_chunks=scan_chunks, stream_grads=stream_grads,
                           use_kernel=use_kernel)
    opt = step.optimizer
    state_device = sum(_nbytes(t) for t in opt.state_tensors().values() if t.device == dev)
    # the allocator's own count of what the set-up left on the card
    resident = torch.cuda.memory_allocated(dev) - before if cuda else None
    batch = full_length_batch(cfg, batch_size, seq_len, with_teachers=with_teachers)
    losses, times = [], []
    for _ in range(2):
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(step(batch)["loss"])
        if cuda:
            torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    stream = step.grad_stream
    out = {
        "weights_gib": weights / GIB,
        "opt_state_device_measured_gib": state_device / GIB,
        "pinned_host_gib": (getattr(opt, "host_bytes", 0)
                            + (stream.host_bytes if stream is not None else 0)) / GIB,
        "opt_state_host_measured_gib": getattr(opt, "host_bytes", 0) / GIB,
        "grads_host_measured_gib": (stream.host_bytes if stream is not None else 0) / GIB,
        "losses": losses,
        "warmup_step_ms": times[0],
        "step_ms": times[1],
        "update_ms": step.update_ms(),
    }
    if cuda:
        out["resident_hbm_gib"] = resident / GIB
        out["peak_hbm_gib"] = torch.cuda.max_memory_allocated(dev) / GIB
    if stream is not None:
        stream.close()
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--topology", default=None,
                   help="a TPU slice: no GPU counterpart (raises; give --dp and --tp)")
    p.add_argument("--dp", type=int, default=1, help="data-parallel ranks: one rank's breakdown")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks: one rank's breakdown")
    p.add_argument("--batch", type=int, default=8, help="the batch on the card")
    p.add_argument("--seq", type=int, default=4096)
    p.add_argument("--model", default="llama3", choices=["llama3", "phi3"])
    p.add_argument("--stage", default="pretrain",
                   choices=["pretrain", "finetune", "vpt", "pretrain_full"])
    p.add_argument("--master-weights", action="store_true")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--remat-policy", default=None)
    p.add_argument("--no-teachers", action="store_true")
    p.add_argument("--no-zero3", action="store_true",
                   help="keep the trainables whole on every rank (the moments stay sharded)")
    p.add_argument("--offload-opt", action="store_true")
    p.add_argument("--whole-tree-staging", action="store_true")
    p.add_argument("--block-bytes", type=int, default=256 << 20)
    p.add_argument("--unrolled-staging", action="store_true",
                   help="taken and ignored: the blockwise update has one layout (JAX keeps "
                        "the flag for command-line compatibility)")
    p.add_argument("--scan-staging", action="store_true")
    p.add_argument("--stream-grads", type=int, default=0)
    p.add_argument("--mu-dtype", default=None)
    p.add_argument("--no-pallas", action="store_true",
                   help="--run's step with the decoder's attention on the plain path "
                        "(use_kernel=False), JAX's use_pallas=False")
    p.add_argument("--shard-teachers", action="store_true",
                   help="the teachers' large leaves over the tp ranks")
    p.add_argument("--zero-frozen", action="store_true",
                   help="shard the frozen parameters over the data axis too")
    p.add_argument("--run", action="store_true",
                   help="also run a warm-up and a measured step on the card")
    p.add_argument("--device", default="cuda", help="where --run runs")
    p.add_argument("--out", default=None, help="append the JSON line here")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.topology is not None:
        raise ValueError(
            f"--topology {args.topology}: a TPU slice has no counterpart on GPUs; the device "
            "count is --dp x --tp (ROADMAP C)")
    if args.run and (args.dp != 1 or args.tp != 1):
        raise ValueError("--run measures one process on one card; --dp N --tp M give one "
                         "rank's static breakdown")
    from visper_lm_tpu_torch.config import llama3_clip_vlm, phi3_clip_vlm

    distill = args.stage in ("pretrain", "pretrain_full")
    with_teachers = distill and not args.no_teachers
    cfg = (llama3_clip_vlm if args.model == "llama3" else phi3_clip_vlm)(distill=distill)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, max_seq_len=args.seq))
    stage = {"pretrain_full": "full"}.get(args.stage, args.stage)
    mu_dtype = args.mu_dtype or "float32"
    t0 = time.perf_counter()
    sizes = static_breakdown(
        cfg, stage=stage, batch_size=args.batch, seq_len=args.seq, with_teachers=with_teachers,
        offload_opt_state=args.offload_opt, stream_grads=args.stream_grads,
        master_weights=args.master_weights, mu_dtype=mu_dtype, block_bytes=args.block_bytes,
        dp=args.dp, zero_params=not args.no_zero3, zero_frozen=args.zero_frozen, tp=args.tp,
        shard_teachers=args.shard_teachers,
    )
    report: Dict[str, Any] = {
        "mesh": {"data": args.dp, "model": args.tp}, "zero3": not args.no_zero3,
        "zero_frozen": args.zero_frozen, "shard_teachers": args.shard_teachers,
        "model": args.model, "stage": args.stage, "master_weights": args.master_weights,
        "remat_policy": args.remat_policy, "global_batch": args.batch, "seq": args.seq,
        "teachers_in_step": with_teachers, "offload_opt_state": args.offload_opt,
        "blockwise_staging": not args.whole_tree_staging, "block_bytes": args.block_bytes,
        "scan_chunks": args.scan_staging, "stream_grads": args.stream_grads,
        "mu_dtype": mu_dtype, "breakdown_s": time.perf_counter() - t0,
    }
    for key in ("params", "opt_state", "frozen", "teachers", "batch"):
        report[f"{key}_gib_per_chip"] = sizes[key] / GIB
    for key in ("opt_state_device", "opt_state_host", "grads_device", "grads_host"):
        report[f"{key}_gib"] = sizes[key] / GIB
    if args.run:
        report.update(run_step(
            cfg, stage=stage, batch_size=args.batch, seq_len=args.seq, with_teachers=with_teachers,
            offload_opt_state=args.offload_opt, stream_grads=args.stream_grads,
            master_weights=args.master_weights, mu_dtype=mu_dtype,
            remat_policy=args.remat_policy,
            learning_rate=args.lr or (1e-3 if args.stage == "pretrain" else 2e-5),
            blockwise_staging=not args.whole_tree_staging, block_bytes=args.block_bytes,
            scan_chunks=args.scan_staging, device=args.device,
            use_kernel=False if args.no_pallas else None,
        ))
    line = json.dumps(report)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
