"""The multi-process dry run (counterpart of the JAX system's
`__graft_entry__.dryrun_multichip`).

JAX jits one training step over a mesh of virtual CPU devices; the port runs
one process per device. `dryrun_multichip()` starts eight ranks of this
module on gloo (a free localhost port, each rank its own process), on the
CUDA cards present (rank r on card r modulo their count, so ranks share a
card, their collectives staged through host memory) or, when the caller
asks for it, on the CPU; each runs JAX's four dry runs at `tiny_test_vlm`
sizes:

  1. the PT step (distillation + contrastive, targets in the batch) at dp 4
     x tp 2 with ZeRO-3 trainables, ZeRO-sharded frozen parameters and the
     save_qkv_mlp remat policy;
  2. the finetune step at dp 2 x pp 2 x tp 2 (the decoder pipelined,
     ZeRO-3 inside each stage);
  3. the finetune step of a MoE decoder (E 4, top-2) at dp 2 x ep 2 x tp 2;
  4. the pretrain_full step (taps and the whole model's backward) at dp 4 x
     tp 2 with ZeRO-3 and the gradient-streaming layout (2 segments), the
     moments offloaded to the host: the port streams each segment's
     gradient into page-locked host memory, which only the staged update
     reads (JAX's pinned-host put is a no-op on its CPU devices).

Each asserts a finite loss (and the MoE step a finite load-balance loss),
as JAX's does; the ranks' losses are reported per run. The weights are the
port's seeded init, not JAX's numbers. A rank that fails, or a run that
does not finish within `timeout` seconds, fails the dry run.

    python -m visper_lm_tpu_torch.dryrun [--device cuda|cpu] [--timeout 600]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

# the processes the meshes span (JAX's dry run: 8 devices)
WORLD = 8

# the runs, in JAX's order: (name, mesh axes, stage, distill, moe, step keywords)
RUNS = (
    ("pt", dict(dp=4, tp=2), "pretrain", True, False,
     dict(zero_params=True, zero_frozen=True, remat_policy="save_qkv_mlp")),
    ("pipeline", dict(dp=2, pp=2, tp=2), "finetune", False, False, dict(zero_params=True)),
    ("expert", dict(dp=2, ep=2, tp=2), "finetune", False, True, {}),
    ("stream_full", dict(dp=4, tp=2), "full", True, False,
     dict(zero_params=True, stream_grads=2, offload_opt_state=True)),
)


def build_batch(cfg, batch_size: int = 4, seed: int = 0) -> Dict[str, np.ndarray]:
    """JAX `_build`'s batch: 4 rows of T 64 (T 1024 above a 256-wide
    decoder), system ids, the image, 12 + b text ids; the images normal."""
    from visper_lm_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from visper_lm_tpu_torch.data.collate import build_splice_plan, collate_plans

    rng = np.random.default_rng(seed)
    t = 64 if cfg.decoder.hidden_size <= 256 else 1024
    n_tasks = len(cfg.distill.task_order()) if cfg.distill else 0
    plans = []
    for b in range(batch_size):
        ids = (list(rng.integers(3, cfg.decoder.vocab_size - 10, size=cfg.num_sys_tokens))
               + [IMAGE_TOKEN_INDEX]
               + list(rng.integers(3, cfg.decoder.vocab_size - 10, size=12 + b % 4)))
        labels = [IGNORE_INDEX] * (cfg.num_sys_tokens + 1) + ids[cfg.num_sys_tokens + 1:]
        plans.append(build_splice_plan(
            ids, labels, t, num_image_tokens=cfg.num_image_tokens,
            num_task_tokens=cfg.distill.num_task_tokens if cfg.distill else 0,
            num_tasks=n_tasks))
    img = rng.normal(size=(batch_size, cfg.vision.image_size, cfg.vision.image_size, 3))
    batch = collate_plans(plans, images=img.astype(np.float32))
    if cfg.distill is not None:
        # distillation targets in the batch (the teachers integrate via teacher_fn)
        rng = np.random.default_rng(seed + 1)
        for tcfg in cfg.distill.tasks:
            batch[f"{tcfg.task}_target"] = rng.normal(
                size=(batch_size, tcfg.target_tokens, tcfg.target_dim)).astype(np.float32)
            batch[f"{tcfg.task}_mask"] = np.ones((batch_size,), np.float32)
    return batch


def run_config(distill: bool, moe: bool):
    from visper_lm_tpu_torch.config import tiny_test_vlm

    cfg = tiny_test_vlm(distill=distill)
    if moe:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, moe_experts=4, moe_top_k=2))
    return cfg


def run_rank(rank: int, port: int, device: str) -> List[dict]:
    """One rank of the dry run on `device` ("cuda": the card this rank's
    index picks; "cpu"): the four steps in JAX's order (collective)."""
    import torch

    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.ops.moe import expert_parallel
    from visper_lm_tpu_torch.parallel import distributed as D
    from visper_lm_tpu_torch.parallel.pipeline import pipe_parallel
    from visper_lm_tpu_torch.parallel.tensor import tensor_parallel
    from visper_lm_tpu_torch.train.optimizer import OptimizerConfig
    from visper_lm_tpu_torch.train.train_step import make_train_step

    torch.set_num_threads(1)
    D.init_distributed(f"localhost:{port}", WORLD, rank, device=device, backend="gloo")
    dev = D.local_device(device)
    out = []
    for seed, (name, axes, stage, distill, moe, kw) in enumerate(RUNS):
        t0 = time.perf_counter()
        cfg = run_config(distill, moe)
        mesh = D.make_global_mesh(**axes)
        model = init_vlm(cfg, device=dev, seed=seed, tp=tensor_parallel(mesh),
                         pp=pipe_parallel(mesh, cfg.decoder.num_layers),
                         ep=expert_parallel(mesh))
        step = make_train_step(cfg, OptimizerConfig(learning_rate=1e-3, total_steps=10,
                                                    stage=stage), model, mesh=mesh, **kw)
        dp = mesh.data_size
        batch = build_batch(cfg, seed=seed)
        # the global batch tiled to a multiple of the data size (JAX's rule)
        reps = -(-dp * 2 // batch["labels"].shape[0])
        batch = {k: np.concatenate([v] * reps)[: batch["labels"].shape[0] * reps // dp * dp]
                 for k, v in batch.items()}
        index, count = D.data_shard(mesh)
        n = batch["labels"].shape[0] // count
        local = D.shard_batch_multihost({k: v[index * n:(index + 1) * n] for k, v in batch.items()},
                                        mesh)
        metrics = step(local)
        loss = metrics["loss"]
        if not math.isfinite(loss):
            raise AssertionError(f"dry run {name}: non-finite loss {loss}")
        rec = dict(name=name, mesh=mesh.shape, loss=loss, seconds=time.perf_counter() - t0)
        if moe:
            lb = metrics["moe_lb_loss"]
            if not math.isfinite(lb):
                raise AssertionError(f"dry run {name}: non-finite lb loss {lb}")
            rec["lb"] = lb
        if name == "stream_full":
            rec["segments"] = len(step.grad_stream.ranges)
        out.append(rec)
        del step, model
    D.barrier()
    D.shutdown()
    return out


def dryrun_multichip(device: str = "cuda", timeout: float = 600.0) -> List[dict]:
    """Start the WORLD ranks of this module on gloo, computing on `device`
    ("cuda" or "cpu"), wait for all of them within `timeout` seconds
    (killing what is left), print each run's line and return rank 0's
    records. Raises unless every rank exits 0."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"the dry run runs on cuda or cpu, not {device!r}")
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("the dry run asks for CUDA and no card is present (device='cpu' "
                               "runs it on the CPU)")
    from visper_lm_tpu_torch.parallel.distributed import free_port

    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if not k.startswith("VISPER_")}
    env.update(OMP_NUM_THREADS="1", PYTHONHASHSEED="0",
               PYTHONPATH=os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(WORLD)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "visper_lm_tpu_torch.dryrun", "--rank", str(r),
             "--port", str(port), "--device", device],
            cwd=root, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(WORLD)]
        deadline = time.monotonic() + timeout
        try:
            codes = [p.wait(timeout=max(deadline - time.monotonic(), 0)) for p in procs]
        except subprocess.TimeoutExpired:
            codes = None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    if codes != [0] * WORLD:
        bad = [r for r in range(WORLD) if codes is None or codes[r] != 0]
        raise RuntimeError(
            f"dry run: ranks {bad} failed (exit codes {codes}; None: not done within "
            f"{timeout} s); rank {bad[0]}'s log:\n{texts[bad[0]][-3000:]}")
    recs = [json.loads(ln[len("DRYRUN "):]) for ln in texts[0].splitlines()
            if ln.startswith("DRYRUN ")]
    for rec in recs:
        extra = f" lb={rec['lb']:.3f}" if "lb" in rec else ""
        extra += f" chunks={rec['segments']}" if "segments" in rec else ""
        print(f"dryrun {rec['name']}: mesh={rec['mesh']} loss={rec['loss']:.4f}{extra} ok")
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ranks compute (default: the CUDA cards, shared by the ranks)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is None:
        dryrun_multichip(args.device, args.timeout)
        return 0
    for rec in run_rank(args.rank, args.port, args.device):
        print("DRYRUN " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
