"""One rank of tests/test_torch_tensor_parallel.py: the port's tensor
parallelism at dp 2 x tp 2 on gloo over the CPU (four ranks).

    VISPER_COORDINATOR=localhost:<port> VISPER_NUM_PROCESSES=4 VISPER_PROCESS_ID=<rank> \\
        python tests/_torch_tp_worker.py <workdir>

`<workdir>` holds what the test wrote: params.pkl and teachers.pkl (the
JAX package's initial trees, as numpy), batch.npz (the global PT batch of
4 with the teachers' pixels), gen.npz (the generation batch of 4) and the
CLI's dataset under data/. Each rank builds its tensor-parallel slices from
the trees on the host (`from_jax_params(..., tp=)`), works on the rows of
its data coordinate, and writes what it computed to rank<r>.pt:

  ops        the tp operators, the vocab-parallel lookup and cross-entropy
             against their one-process forms on small tensors;
  generate   the rank's rows of the greedy tokens of a tp x dp Generator,
             with a bf16 / f32 cache and with an int8 one;
  pt         the PT step with the teachers in it: step-1 loss, metrics and
             gradients (summed over the data group), the same with the
             chunked cross-entropy forced, 3 updates, the trainables after
             them and the rank's replicated parameters;
  teachers   the same PT step with shard_teachers: its step-1 metrics, 3
             updates, the teachers' bytes held;
  ft, ft_zero   the finetune stage (the decoder's Megatron leaves train)
             plain and with zero_params; ft_zero's state is saved at dp 2 x
             tp 2 and restored at dp 2 x tp 2 and (ranks 0 and 1) at dp 1 x
             tp 2;
  full       the pretrain_full levers (stage full, teachers in the step):
             zero_params + offloaded moments + stream_grads 2 +
             shard_teachers, 3 updates;
  cli        `cli.main(["@recipes/pretrain_full.args", "--smoke", "--dp",
             "2", "--tp", "2", ...])`: the rows each rank read.
"""

import os
import pickle
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

torch.set_num_threads(1)

from visper_lm_tpu_torch import config as tconfig  # noqa: E402
from visper_lm_tpu_torch.data import dataset as tdata  # noqa: E402
from visper_lm_tpu_torch.models import teachers as tteach  # noqa: E402
from visper_lm_tpu_torch.models.teachers import swin as tswin  # noqa: E402
from visper_lm_tpu_torch.parallel import distributed as D  # noqa: E402
from visper_lm_tpu_torch.parallel import tensor as T  # noqa: E402
from visper_lm_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator  # noqa: E402
from visper_lm_tpu_torch.train import cli as tcli  # noqa: E402
from visper_lm_tpu_torch.train import train_step as tts  # noqa: E402
from visper_lm_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from visper_lm_tpu_torch.train.optimizer import OptimizerConfig  # noqa: E402
from visper_lm_tpu_torch.train.staged_update import OffloadedAdamW  # noqa: E402
from visper_lm_tpu_torch.weights import from_jax_params, teachers_from_jax_params  # noqa: E402

OPT = dict(learning_rate=3e-3, total_steps=30, warmup_ratio=0.1)
STEPS = 3
# the test's tiny teachers, with MLPs of >= 2^16 elements so that
# model_shard_pspec splits them
TEACHERS = dict(
    dinov2=dict(image_size=28, patch_size=14, hidden_size=24, num_layers=2, num_heads=2,
                mlp_dim=2736, norm_eps=1e-6, hidden_act="gelu", use_pre_norm=False,
                dtype="float32"),
    clip_h=dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=2,
                mlp_dim=2048, hidden_act="gelu", dtype="float32"),
    swin=dict(embed_dim=2, depths=(1, 1, 1, 1), num_heads=(1, 1, 1, 2), window_size=2),
)


def teacher_configs():
    return tteach.TeacherConfigs(
        dinov2=tconfig.VisionConfig(**TEACHERS["dinov2"]),
        clip_h=tconfig.VisionConfig(**TEACHERS["clip_h"]),
        swin=tswin.SwinConfig(**TEACHERS["swin"]), gen_embed_dim=24)


def ops(tp) -> dict:
    """The tp operators on small tensors against their one-process forms."""
    got = {}
    torch.manual_seed(0)
    x = torch.randn(3, 5, dtype=torch.float64)        # the same on every rank
    parts = [torch.randn(3, 5, dtype=torch.float64) for _ in range(tp.size)]
    a = x.clone().requires_grad_(True)
    y = D.copy_to_group(a, tp.group)
    (y * (tp.rank + 1)).sum().backward()
    got["copy_to_group"] = torch.equal(y.detach(), x) and torch.allclose(
        a.grad, torch.full_like(x, sum(range(1, tp.size + 1))))
    b = parts[tp.rank].clone().requires_grad_(True)
    z = D.reduce_from_group(b, tp.group)
    z.sum().backward()
    got["reduce_from_group"] = torch.allclose(z.detach(), sum(parts)) and torch.equal(
        b.grad, torch.ones_like(b))
    # the lookup: 40 rows, ids of every block and negative markers
    table = torch.randn(40, 6, dtype=torch.float64)
    ids = torch.tensor([[0, 9, 10, 39, -200], [21, 20, 19, 5, 30]])
    rows = table.shape[0] // tp.size
    local = table[tp.rank * rows:(tp.rank + 1) * rows]
    want = F.embedding(ids.clamp(min=0), table) * (ids >= 0)[..., None]
    got["vocab_embed"] = torch.allclose(T.vocab_embed(local, ids, tp), want)
    # the cross-entropy and its gradient against F.cross_entropy
    logits = torch.randn(2, 7, 40, dtype=torch.float64) * 3
    target = torch.randint(0, 40, (2, 7))
    ref_in = logits.clone().requires_grad_(True)
    ref = F.cross_entropy(ref_in.reshape(-1, 40), target.reshape(-1), reduction="none")
    w = torch.randn(14, dtype=torch.float64)
    (ref * w).sum().backward()
    mine = logits[..., tp.rank * rows:(tp.rank + 1) * rows].clone().requires_grad_(True)
    nll = T.vocab_parallel_nll(mine, target, tp)
    (nll.reshape(-1) * w).sum().backward()
    got["vocab_parallel_nll"] = float((nll.reshape(-1) - ref.detach()).abs().max())
    got["vocab_parallel_nll_grad"] = float(
        (mine.grad - ref_in.grad[..., tp.rank * rows:(tp.rank + 1) * rows]).abs().max())
    return got


def replicated(step) -> dict:
    """The rank's trainables that tensor parallelism does not split (its own
    copies, not gathered over tp; ZeRO-3's gathered over the data group)."""
    split = T.model_placements(step.model)
    with step.whole():
        return {n: p.detach().clone() for n, p in step.trainable.items() if n not in split}


def main(workdir: str) -> None:
    t0 = time.perf_counter()
    D.init_distributed(device="cpu")
    rank, world = D.process_index(), D.process_count()
    assert world == 4, world
    mesh = make_mesh(dp=2, tp=2)
    tp = T.tensor_parallel(mesh)
    data_index, data_size = D.data_shard(mesh)
    cfg = tconfig.tiny_test_vlm(distill=True)
    tcfgs = teacher_configs()
    with open(os.path.join(workdir, "params.pkl"), "rb") as f:
        tree = pickle.load(f)
    with open(os.path.join(workdir, "teachers.pkl"), "rb") as f:
        teacher_tree = pickle.load(f)
    batch = dict(np.load(os.path.join(workdir, "batch.npz")))
    gen = dict(np.load(os.path.join(workdir, "gen.npz")))
    lb = D.local_batch_size(batch["labels"].shape[0], mesh)
    rows = slice(data_index * lb, (data_index + 1) * lb)
    local = D.shard_batch_multihost({k: v[rows] for k, v in batch.items()}, mesh)
    out = dict(coords=mesh.coords(rank), data_shard=(data_index, data_size), rows=(rows.start,
                                                                                    rows.stop))
    out["ops"] = ops(tp)

    def model_of(c=cfg):
        return from_jax_params(tree, c, device="cpu", tp=tp)

    def teachers():
        return teachers_from_jax_params(teacher_tree, cfg, tcfgs, device="cpu")

    def run(step, data):
        metrics = [step(data) for _ in range(STEPS)]
        return dict(metrics=metrics, replicated=replicated(step),
                    state={k: v.detach().clone() for k, v in step.state_tensors().items()})

    def step_one(step, data):
        met, grads = step.loss_and_grads(data)
        summed = D.all_reduce_scalars(list(met.values()), step.zero.group)
        for n in sorted(grads):
            D.all_reduce(grads[n], step.zero.group)
            grads[n] = T.whole_param(step.model, n, grads[n])
        return {k: float(v) for k, v in zip(met, summed)}, grads

    # the Generator: each data rank its own rows, on the rank's heads
    model = model_of()
    g_rows = slice(data_index * 2, (data_index + 1) * 2)
    generator = Generator(model, cfg, GenerationConfig(max_new_tokens=5), 2, 64,
                          cache_dtype=torch.float32, device="cpu")
    out["generate"] = dict(rows=(g_rows.start, g_rows.stop), tokens=generator.generate(
        {k: v[g_rows] for k, v in gen.items()}))
    out["cache_heads"] = generator.prefill({k: v[g_rows] for k, v in gen.items()})[1].k.shape[3]
    out["generate_int8_kv"] = Generator(
        model, cfg, GenerationConfig(max_new_tokens=5, kv_quant=True), 2, 64,
        cache_dtype=torch.float32, device="cpu").generate({k: v[g_rows] for k, v in gen.items()})
    whole = {n: T.whole_param(model, n, p.detach()) for n, p in model.named_parameters()}
    out["whole_params"] = {n: t.clone() for n, t in whole.items()} if rank == 0 else None
    out["local_shapes"] = {n: tuple(p.shape) for n, p in model.named_parameters()}
    del model, generator, whole

    # the PT step with the teachers in it
    tfn = tteach.make_teacher_fn(cfg, tcfgs)
    pt_opt = OptimizerConfig(**OPT, stage="pretrain")
    step = tts.make_train_step(cfg, pt_opt, model_of(), teacher_fn=tfn, teacher_params=teachers(),
                               mesh=mesh)
    met, grads = step_one(step, local)
    build = tts.uses_chunked_ce
    tts.uses_chunked_ce = lambda *a: True
    try:
        met_c, grads_c = step_one(step, local)
    finally:
        tts.uses_chunked_ce = build
    out["pt"] = dict(met=met, grads=grads, met_chunked=met_c, grads_chunked=grads_c,
                     **run(step, local))
    out["pt"]["loss_after"] = float(D.all_reduce_scalars(
        [step.loss_fn(step.model, step.to_device(local), step.teacher_params)[0].detach()],
        step.zero.group)[0])

    # shard_teachers: the same step, the teachers held as slices
    tch = teachers()
    whole_bytes = sum(p.numel() * p.element_size() for p in tch.parameters())
    st = tts.make_train_step(cfg, pt_opt, model_of(), teacher_fn=tfn, teacher_params=tch,
                             mesh=mesh, shard_teachers=True)
    held = st.teacher_sharded
    split_whole = sum(held.params[n].numel() * held.params[n].element_size() for n in held.shards)
    met_s, _ = step_one(st, local)
    out["teachers"] = dict(met=met_s, **run(st, local), whole_bytes=whole_bytes,
                           split_whole_bytes=split_whole, shard_bytes=held.shard_bytes,
                           split=sorted(held.shards),
                           storage_after=sum(p.untyped_storage().nbytes()
                                             for p in held.params.values()))
    del st, tch, held

    # finetune: the decoder's Megatron leaves train, plain and ZeRO-3
    ft_opt = OptimizerConfig(**OPT, stage="finetune")
    ft = tts.make_train_step(cfg, ft_opt, model_of(), mesh=mesh)
    out["ft"] = run(ft, local)
    zp = tts.make_train_step(cfg, ft_opt, model_of(), mesh=mesh, zero_params=True,
                             zero_min_size=1024)
    out["ft_zero"] = dict(run(zp, local), shard_bytes=zp.sharded.shard_bytes,
                          sharded=sorted(zp.sharded.shards))
    mgr = CheckpointManager(os.path.join(workdir, "ckpt"))
    mgr.save(STEPS, zp, cfg)
    back = tts.make_train_step(cfg, ft_opt, model_of(), mesh=mesh, zero_params=True,
                               zero_min_size=1024)
    mgr.restore(back)
    saved, restored = out["ft_zero"]["state"], back.state_tensors()
    out["restore_dp2_tp2"] = dict(step=back.step, equal=sorted(saved) == sorted(restored) and all(
        torch.equal(saved[k], restored[k]) for k in saved))
    del ft, zp, back

    # the same files at dp 1 x tp 2 (ranks 0 and 1; every rank makes the groups)
    mesh12 = make_mesh(dp=1, tp=2)
    if rank < 2:
        back = tts.make_train_step(cfg, ft_opt, from_jax_params(
            tree, cfg, device="cpu", tp=T.tensor_parallel(mesh12)), mesh=mesh12, zero_params=True,
            zero_min_size=1024)
        mgr.restore(back)
        restored = back.state_tensors()
        out["restore_dp1_tp2"] = dict(step=back.step, equal=sorted(saved) == sorted(restored) and all(
            torch.equal(saved[k], restored[k]) for k in saved))
        del back
    else:
        for make in (D.model_group, D.data_group):
            try:
                make(mesh12)
            except ValueError:           # not in that mesh: the groups are made all the same
                pass
    D.barrier()

    # the pretrain_full levers: stage full, teachers in the step
    full_opt = OptimizerConfig(**OPT, stage="full")
    full = tts.make_train_step(cfg, full_opt, model_of(), teacher_fn=tfn, teacher_params=teachers(),
                               mesh=mesh, zero_params=True, zero_min_size=1024,
                               offload_opt_state=True, stream_grads=2, shard_teachers=True)
    full.optimizer = OffloadedAdamW(full.trainable.items(), full_opt, min_bytes=0,
                                    block_bytes=4096, zero=full.zero, sharded=full.sharded)
    out["full"] = dict(run(full, local), streamed=full.grad_stream is not None,
                       blocks=sum(len(p) for p in full.optimizer.plan.values() if p),
                       offloaded=sum(p is not None for p in full.optimizer.plan.values()),
                       teacher_split=len(full.teacher_sharded.shards))
    del full

    # the CLI from the pretrain_full recipe, with the rows each rank reads
    seen = []
    iterator = tdata.BatchIterator

    class Recording(iterator):
        def __iter__(self):
            for b in super().__iter__():
                seen.append(b["labels"].copy())
                yield b

    tdata.BatchIterator = Recording
    data = os.path.join(workdir, "data")
    try:
        state = tcli.main([
            "@" + os.path.join(REPO, "recipes", "pretrain_full.args"), "--smoke", "--device",
            "cpu", "--data-path", os.path.join(data, "data.json"), "--image-folder", data,
            "--tokenizer", "fake-whitespace", "--output-dir", os.path.join(workdir, "cli"),
            "--per-device-batch-size", "2", "--save-steps", "1", "--seq-buckets", "64,128",
            "--dataloader-num-workers", "0", "--prefetch-depth", "0", "--warmup-ratio", "0.0",
            "--lr", "1e-2", "--max-steps", "2", "--dp", "2", "--tp", "2"])
    finally:
        tdata.BatchIterator = iterator
    out["cli"] = dict(step=state.step, metrics=state.last_metrics, rows=seen,
                      streamed=state.grad_stream is not None, tp=state.model.decoder.tp.size,
                      optimizer=type(state.optimizer).__name__)
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    D.barrier()
    D.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
