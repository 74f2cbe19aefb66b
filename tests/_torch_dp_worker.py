"""One rank of tests/test_torch_multiprocess.py: the port's data-parallel PT
step on gloo over the CPU.

    VISPER_COORDINATOR=localhost:<port> VISPER_NUM_PROCESSES=2 VISPER_PROCESS_ID=<rank> \\
        python tests/_torch_dp_worker.py <workdir>

The runtime starts from the VISPER_* environment. `<workdir>` holds what the
test wrote: model.pt (the tiny model's state dict, the JAX package's
initial weights), batch.npz (the global batch of 4), accum.npz (two
micro-batches of 4) and the CLI's dataset under data/. Each rank trains on
its own rows and writes what it computed to rank<r>.pt:

  plain        loss and metrics of the first micro-batch (its shares summed
               over the ranks), the gradients summed over the ranks, the
               metrics of 3 updates, the trainables and moments after them;
  zero_params, zero_frozen   the same 3 updates with ZeRO-3 (leaves of at
               least 1024 elements), the bytes each rank keeps;
  accum        3 updates of 2 micro-batches each;
  ift_plain, ift_zero_params   the finetune stage (the decoder trains) plain
               and with ZeRO-3;
  offload      zero_params with every moment in host blocks;
  ckpt         zero_params' state saved at dp 2 and restored at dp 2;
  hooked       `trainer.train` with zero_frozen: a step hook runs the
               model's forward, rank 1 alone sends itself SIGTERM at step
               1; the forward in the hook and the returned model's export
               against an unsharded copy of the same parameters;
  cli          `cli.main(["--smoke", ...])` with --dp 2 --zero-params.
"""

import functools
import os
import signal
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from visper_lm_tpu_torch import config as tconfig  # noqa: E402
from visper_lm_tpu_torch.checkpoint.hf_export import export_vlm  # noqa: E402
from visper_lm_tpu_torch.models.vlm import VLM, vlm_forward  # noqa: E402
from visper_lm_tpu_torch.parallel import distributed as D  # noqa: E402
from visper_lm_tpu_torch.train import cli as tcli  # noqa: E402
from visper_lm_tpu_torch.train import train_step as tts  # noqa: E402
from visper_lm_tpu_torch.train import trainer as ttr  # noqa: E402
from visper_lm_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from visper_lm_tpu_torch.train.optimizer import OptimizerConfig  # noqa: E402
from visper_lm_tpu_torch.train.staged_update import OffloadedAdamW  # noqa: E402
from visper_lm_tpu_torch.train.train_step import make_train_step  # noqa: E402

OPT = dict(learning_rate=3e-3, total_steps=30, warmup_ratio=0.1, stage="pretrain")
STEPS = 3


def collectives(rank: int) -> dict:
    """Each collective against what it must give, on tensors whose values
    name their rank, position and dtype: {check: passed}."""
    def part(r, dtype=torch.float32):
        return (torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) - 7 + 100 * r).to(dtype)

    got = {}
    for dtype in (torch.float32, torch.bfloat16):
        for dim in range(3):
            want = torch.cat([part(0, dtype), part(1, dtype)], dim)
            got[f"all_gather_{dtype}_{dim}"] = torch.equal(D.all_gather(part(rank, dtype), dim), want)
            full = torch.stack([part(0, dtype), part(1, dtype)]).sum(0).repeat(2, 2, 2)
            want = full.narrow(dim, rank * full.shape[dim] // 2, full.shape[dim] // 2)
            got[f"reduce_scatter_{dtype}_{dim}"] = torch.equal(
                D.reduce_scatter(part(rank, dtype).repeat(2, 2, 2), dim), want)
    x = part(rank).clone().requires_grad_(True)
    w = torch.arange(48.0).reshape(4, 3, 4) * (rank + 1)
    (D.all_gather_autograd(x, 0) * w).sum().backward()
    # d/dx of both ranks' losses: the sum of their weights on this rank's rows
    got["all_gather_autograd"] = torch.equal(x.grad, 3 * torch.arange(48.0).reshape(4, 3, 4)[
        2 * rank:2 * rank + 2])
    y = part(rank).clone()
    got["broadcast"] = torch.equal(D.broadcast(y, 1), part(1))
    summed = D.reduce(part(rank).clone(), 0)
    got["reduce"] = rank != 0 or torch.equal(summed, part(0) + part(1))
    return got


def hooked(workdir: str, rank: int, cfg, init, local: dict, opt_cfg) -> dict:
    """`trainer.train` under zero_frozen (leaves of at least 1024 elements)
    for up to 3 steps, with a hook that (every parameter whole) runs the
    model's forward beside an unsharded model holding the same parameters;
    rank 1 alone asks for SIGTERM at step 1. Then the returned model's
    forward and export beside the unsharded one's."""
    ref = VLM(cfg)
    ref.load_state_dict(init)
    keys = ("images", "text_ids", "token_type", "src_index", "seq_lengths")
    dbatch = {k: torch.as_tensor(local[k]) for k in keys}

    @torch.no_grad()
    def same_as_ref(state) -> dict:
        for n in state.trainable:
            ref.get_parameter(n).copy_(state.full_param(n))
        whole = all(p.untyped_storage().nbytes() == p.numel() * p.element_size()
                    for p in state.sharded.params.values())
        got = vlm_forward(state.model, cfg, dbatch)["logits"]
        want = vlm_forward(ref, cfg, dbatch)["logits"]
        return dict(whole=whole, equal=torch.equal(got, want), sharded=len(state.sharded.params))

    seen = []

    def hook(step, state, batch):
        seen.append(dict(same_as_ref(state), step=step))
        if rank == 1 and step == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    model = VLM(cfg)
    model.load_state_dict(init)
    tcfg = ttr.TrainerConfig(output_dir=os.path.join(workdir, "hooked"), max_steps=3,
                             save_steps=100, zero_frozen=True, device="cpu")
    build = ttr.make_train_step
    ttr.make_train_step = functools.partial(tts.make_train_step, zero_min_size=1024)
    try:
        state = ttr.train(cfg, opt_cfg, tcfg, model, lambda epoch: iter([local] * 3),
                          step_hooks=[hook])
    finally:
        ttr.make_train_step = build
    after = same_as_ref(state)
    exported, want = export_vlm(state.model, cfg), export_vlm(ref, cfg)
    after["export_equal"] = sorted(exported) == sorted(want) and all(
        torch.equal(exported[k], want[k]) for k in want)
    return dict(step=state.step, seen=seen, after=after)


def main(workdir: str) -> None:
    t0 = time.perf_counter()
    D.init_distributed(device="cpu")
    rank, world = D.process_index(), D.process_count()
    assert world == 2, world
    cfg = tconfig.tiny_test_vlm(distill=True)
    init = torch.load(os.path.join(workdir, "model.pt"), weights_only=True)
    batch = dict(np.load(os.path.join(workdir, "batch.npz")))
    accum = dict(np.load(os.path.join(workdir, "accum.npz")))
    lb = D.local_batch_size(batch["labels"].shape[0])
    rows = slice(rank * lb, (rank + 1) * lb)
    mesh = D.make_global_mesh()
    local = D.shard_batch_multihost({k: v[rows] for k, v in batch.items()}, mesh)
    assert local.global_batch_size == batch["labels"].shape[0]
    local_accum = D.shard_batch_multihost({k: v[:, rows] for k, v in accum.items()}, mesh,
                                          leading_accum=True)
    opt_cfg = OptimizerConfig(**OPT)

    def build(opt=opt_cfg, **kw):
        model = VLM(cfg)
        model.load_state_dict(init)
        return make_train_step(cfg, opt, model, mesh=mesh, **kw)

    def run(step, data):
        metrics = [step(data) for _ in range(STEPS)]
        return dict(metrics=metrics, state={k: v.detach().clone() for k, v in
                                            step.state_tensors().items()})

    out = {"collectives": collectives(rank)}
    step = build()
    met, grads = step.loss_and_grads(local)
    summed = D.all_reduce_scalars(list(met.values()))
    for n in sorted(grads):
        D.all_reduce(grads[n])
    out["plain"] = dict(met={k: float(v) for k, v in zip(met, summed)},
                        grads={n: g.clone() for n, g in grads.items()}, **run(step, local))
    # what each rank alone would call its loss (the mean of its own rows)
    out["local_met"] = {k: float(v) for k, v in met.items()}

    zp = build(zero_params=True, zero_min_size=1024)
    out["zero_params"] = dict(run(zp, local), shard_bytes=zp.sharded.shard_bytes,
                              sharded=sorted(zp.sharded.shards))
    zf = build(zero_frozen=True, zero_min_size=1024)
    out["zero_frozen"] = dict(run(zf, local), shard_bytes=zf.sharded.shard_bytes,
                              sharded=sorted(zf.sharded.shards))
    out["accum"] = run(build(accum_steps=2), local_accum)
    # the whole model trains: q_proj's moments take o_proj's spec (same
    # shape), so its ZeRO-3 slice and its moments' slice differ
    ift = OptimizerConfig(**dict(OPT, stage="finetune"))
    out["ift_plain"] = run(build(ift), local)
    zi = build(ift, zero_params=True, zero_min_size=1024)
    q = "decoder.blocks.0.q_proj.weight"
    out["ift_zero_params"] = dict(run(zi, local), q_slices=(zi.sharded.plan[q].dim,
                                                             zi.zero.moments[q].dim))

    off = build(zero_params=True, zero_min_size=1024)
    off.optimizer = OffloadedAdamW(off.trainable.items(), opt_cfg, min_bytes=0, block_bytes=4096,
                                   zero=off.zero, sharded=off.sharded)
    out["offload"] = dict(run(off, local), blocks=sum(len(p) for p in off.optimizer.plan.values()
                                                      if p))

    mgr = CheckpointManager(os.path.join(workdir, "ckpt"))
    mgr.save(STEPS, zp, cfg)
    back = build(zero_params=True, zero_min_size=1024)
    mgr.restore(back)
    saved, restored = zp.state_tensors(), back.state_tensors()
    out["ckpt"] = dict(step=back.step, equal=sorted(saved) == sorted(restored) and all(
        torch.equal(saved[k], restored[k]) for k in saved))

    out["hooked"] = hooked(workdir, rank, cfg, init, {k: v[rows] for k, v in batch.items()},
                           opt_cfg)

    data = os.path.join(workdir, "data")
    state = tcli.main([
        "--stage", "pretrain", "--smoke", "--device", "cpu", "--data-path",
        os.path.join(data, "data.json"), "--image-folder", data, "--tokenizer",
        "fake-whitespace", "--output-dir", os.path.join(workdir, "cli"),
        "--per-device-batch-size", "2", "--save-steps", "1", "--seq-buckets", "64,128",
        "--dataloader-num-workers", "0", "--warmup-ratio", "0.0", "--lr", "1e-2",
        "--max-steps", "2", "--dp", "2", "--zero-params"])
    out["cli"] = dict(step=state.step, metrics=state.last_metrics)
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    D.barrier()
    D.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
