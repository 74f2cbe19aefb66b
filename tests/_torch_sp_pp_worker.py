"""One rank of tests/test_torch_sequence_parallel.py and
tests/test_torch_pipeline_parallel.py: the port's sequence and pipeline
parallelism on gloo over the CPU (four ranks).

    VISPER_COORDINATOR=localhost:<port> VISPER_NUM_PROCESSES=4 VISPER_PROCESS_ID=<rank> \\
        python tests/_torch_sp_pp_worker.py <workdir> sp|pp

The second argument picks the part: "sp" (the sequence-parallel cases and
steps) or "pp" (the pipeline's).

`<workdir>` holds what the tests wrote: dec.pkl and dec_remat.pkl (JAX
`init_decoder` trees of the tiny decoder, as numpy), ft.pkl and pt.pkl (JAX
`init_vlm` trees of tiny_test_vlm without and with distillation), ft.npz
and pt.npz (the global batches of 4). The attention and pipeline inputs are
made here from numpy seeds by the functions below, which the tests call
too. Every case runs on a mesh of all four ranks; each rank writes what it
computed to rank<r>.pt:

  ulysses / ring   the rank's rows of the output and of dq, dk, dv of
                   sum(sin(out)) at each (dp, sp, nq, nkv) case;
  route            multi_head_attention under sp 4 with 2 kv heads (the
                   ring: point-to-point sends, no all-to-all);
  dec_sp           decoder_forward's logits of the rank's rows at sp 4 (the
                   ring) and at dp 2 x sp 2 (Ulysses);
  pipe             pipeline_scan on the toy blocks at each (dp, pp, m), the
                   f64 schedule, the gradients at pp 4, the layer guard;
  dec_pp           decoder_forward under dp 1 x pp 4 with ragged lengths,
                   at sp 2 x pp 2 (forward), and the remat + save_gate
                   gradient at dp 2 x pp 2, with the point-to-point sends
                   each made;
  ft_* / pt_*      the finetune step at pp 2 x tp 2, at dp 2 x pp 2 with
                   zero_params, at dp 2 x sp 2 and at sp 2 x pp 2; the PT
                   step at dp 2 x sp 2, dp 2 x pp 2 and sp 2 x pp 2: 3
                   updates' metrics and the whole state after them;
                   ft_dp2_pp2_zero's state saved, restored at dp 2 x pp 2 in
                   the ranks;
  *_o<O>s<N>       the same steps with the memory levers (offload_opt_state
                   O, stream_grads N; LEVERS): the finetune step at dp 2 x
                   sp 2 and dp 2 x pp 2 with each, at pp 2 x tp 2 and sp 2 x
                   pp 2 with both, the PT step with both at dp 2 x pp 2 and
                   sp 2 x pp 2; ft_dp2_pp2_o1s2's state saved;
  lora_*           the LoRA stage at dp 2 x sp 2, dp 2 x pp 2, pp 2 x tp 2 and
                   sp 2 x pp 2 (the finetune batch);
  trainer_*        `trainer.train` at dp 2 x sp 2 and dp 2 x pp 2 (and the
                   LoRA stage at dp 2 x pp 2), 2 steps and a checkpoint;
  moe_layer_*      `moe_mlp` on the rank's rows of moe_layer.npz at dp 2 x
                   sp 2 and sp 2 x ep 2 over the routing group (capacity
                   binding): the rank's output rows, the aux, and the
                   gradients of the input, the router and the rank's banks
                   (the parameters' summed over the group, as the optimizer
                   sums them);
  moe_ft_* /       the finetune and PT steps of the MoE VLM (moe_ft.pkl /
  moe_pt_*         moe_pt.pkl: MOE, aux weight 1.0) at dp 2 x sp 2 and sp 2 x
                   ep 2 (part "sp"), dp 2 x pp 2 and pp 2 x ep 2 (part "pp":
                   the plain loop, foreign blocks gathered, no send): as the
                   steps above, and the finetune step's step-1 gradients of
                   the MoE parameters, summed over the data and seq groups;
  moe_init         `init_vlm` of the MoE VLM at dp 2 x pp 2 and pp 2 x ep 2:
                   the rank's parameters against the one-device model's from
                   the same seed (a foreign block's banks drawn and dropped).
"""

import dataclasses
import os
import pickle
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from visper_lm_tpu_torch import config as tconfig  # noqa: E402
from visper_lm_tpu_torch.ops import moe as moe_ops  # noqa: E402
from visper_lm_tpu_torch.ops.attention import multi_head_attention  # noqa: E402
from visper_lm_tpu_torch.parallel import distributed as D  # noqa: E402
from visper_lm_tpu_torch.parallel import pipeline as P  # noqa: E402
from visper_lm_tpu_torch.parallel import sequence as S  # noqa: E402
from visper_lm_tpu_torch.parallel import tensor as T  # noqa: E402
from visper_lm_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from visper_lm_tpu_torch.train import train_step as tts  # noqa: E402
from visper_lm_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from visper_lm_tpu_torch.train.optimizer import OptimizerConfig  # noqa: E402
from visper_lm_tpu_torch.train.trainer import TrainerConfig, train  # noqa: E402
from visper_lm_tpu_torch.models.vlm import init_vlm  # noqa: E402
from visper_lm_tpu_torch.weights import decoder_from_jax_params, from_jax_params  # noqa: E402

OPT = dict(learning_rate=3e-3, total_steps=30, warmup_ratio=0.1)
STEPS = 3
LORA = dict(r=4, alpha=8)
# (offload_opt_state, stream_grads) of the memory levers' cases
LEVERS = ((True, 0), (False, 2), (True, 2))
# (dp, sp, nkv) of the Ulysses cases (nq 4), as tests/test_sequence_parallel.py
ULYSSES = ((2, 2, 4), (1, 4, 4), (2, 2, 2))
# (dp, sp, nq, nkv) of the ring cases: JAX's, with sp 4 standing in for its
# sp 8 (four ranks) in the case of sp beyond the head count
RING = ((1, 4, 4, 4), (1, 4, 4, 2), (2, 2, 4, 1), (1, 4, 2, 1))
# (dp, pp, m) of pipeline_scan: JAX's (1, 4, 4) and (2, 2, 2), and m 8 over
# 4 stages standing in for its (2, 4, 8) and (1, 8, 8) (eight devices)
PIPE = ((1, 4, 4), (2, 2, 2), (1, 4, 8))
ATTN_T, ATTN_H = 32, 16
# the MoE cases' decoder: JAX's dry-run MoE (E 4, top-2) at a capacity factor
# that drops routes, and an aux weight of 1.0: the aux counted once a seq or
# pipe rank would move the router's gradient beyond the bounds
MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=1.0, moe_aux_weight=1.0)
# the MoE layer's calls: (name, dp, sp, ep); its global input (4, 16, 32),
# 4 experts of 64, top-2 at capacity factor 0.75 (16 of 128 routes a
# seq-sliced row, 24 slots an expert: the capacity binds)
MOE_LAYERS = (("dp2_sp2", 2, 2, 1), ("sp2_ep2", 1, 2, 2))
MOE_LAYER_CF = 0.75


def moe_config(C, distill: bool):
    """tiny_test_vlm with MOE (C: the JAX or the port's config module)."""
    cfg = C.tiny_test_vlm(distill=distill)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, **MOE))


def lever(offload: bool, stream: int) -> str:
    """A lever case's suffix: o<offload>s<stream_grads>."""
    return f"o{int(offload)}s{stream}"


def lora_config(C):
    """tiny_test_vlm(distill=False) with LoRA adapters (r 4) on every block
    linear (C: the JAX or the port's config module)."""
    return dataclasses.replace(C.tiny_test_vlm(distill=False), lora=C.LoraConfig(**LORA))


def attn_inputs(seed, b, nq, nkv):
    """q, k, v (f32) and the ragged kv_lengths / kv_starts of one case."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, ATTN_T, nq, ATTN_H)).astype(np.float32)
    k = rng.normal(size=(b, ATTN_T, nkv, ATTN_H)).astype(np.float32)
    v = rng.normal(size=(b, ATTN_T, nkv, ATTN_H)).astype(np.float32)
    lengths = np.array([ATTN_T] * (b - 1) + [ATTN_T - 5], np.int32)
    starts = np.array([0] * (b - 1) + [3], np.int32)
    return q, k, v, lengths, starts


def toy(seed, L=8, B=8, T=16, D=32, dtype=np.float32):
    """tests/test_pipeline_parallel.py's toy: w (L, D, D), b (L, D), h, scale."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(L, D, D)) * 0.1).astype(dtype)
    b = (rng.normal(size=(L, D)) * 0.1).astype(dtype)
    h = rng.normal(size=(B, T, D)).astype(dtype)
    scale = rng.normal(size=(B, 1, 1)).astype(dtype)
    return w, b, h, scale


def toy_block(blk, hh, args):
    return hh + torch.tanh(hh @ blk["w"] + blk["b"]) * args["scale"]


def _rows(mesh, b):
    d, n = D.data_shard(mesh)
    return slice(d * b // n, (d + 1) * b // n)


def attention_case(fn, dp, sp, nq, nkv, seed):
    mesh = make_mesh(dp=dp, sp=sp)
    seq = S.sequence_parallel(mesh)
    b = 2 * dp
    q, k, v, lengths, starts = attn_inputs(seed, b, nq, nkv)
    br, tr = _rows(mesh, b), seq.rows(ATTN_T)
    leaves = [torch.tensor(x[br, tr]).requires_grad_(True) for x in (q, k, v)]
    sends, before = D.p2p_sends, _a2a_calls[0]
    out = fn(*leaves, seq=seq, causal=True, kv_lengths=torch.tensor(lengths[br]),
             kv_starts=torch.tensor(starts[br]))
    torch.sin(out).sum().backward()
    return dict(rows=(br.start, br.stop, tr.start, tr.stop), out=out.detach(),
                grads=[x.grad for x in leaves], p2p=D.p2p_sends - sends,
                all_to_all=_a2a_calls[0] - before)


_a2a_calls = [0]
_a2a = D.all_to_all


def _counted_all_to_all(*a, **k):
    _a2a_calls[0] += 1
    return _a2a(*a, **k)


D.all_to_all = _counted_all_to_all


_gathers = [0]
_gather = P.PipeParallel.gather


def _counted_gather(self, layer):
    """A foreign block's gather from its owner (the plain loop's), counted."""
    if layer not in self.gathered and not self.owns(layer):
        _gathers[0] += 1
    return _gather(self, layer)


P.PipeParallel.gather = _counted_gather


def moe_layer_case(workdir, dp, sp, ep):
    """`moe_mlp` on this rank's rows of moe_layer.npz at (dp, sp, ep), over
    the routing group: its rows, output, aux and gradients of the rank's
    share of the global loss sum(out r) + 1.0 lb + 1e-3 z."""
    mesh = make_mesh(dp=dp, sp=sp, ep=ep)
    group, experts = D.routing_group(mesh), moe_ops.expert_parallel(mesh)
    seq = S.sequence_parallel(mesh)
    inp = np.load(os.path.join(workdir, "moe_layer.npz"))
    br, tr = _rows(mesh, inp["x"].shape[0]), seq.rows(inp["x"].shape[1])
    e_local = inp["gate"].shape[0] // ep
    first = 0 if experts is None else experts.rank * e_local
    params = {n: torch.tensor(inp[n] if n == "router" else inp[n][first:first + e_local])
              .requires_grad_(True) for n in ("router", "gate", "up", "down")}
    x = torch.tensor(inp["x"][br, tr]).requires_grad_(True)
    out, aux = moe_ops.moe_mlp(params, x, top_k=2, capacity_factor=MOE_LAYER_CF, ep=experts,
                               data=group)
    loss = (out * torch.tensor(inp["r"][br, tr])).sum()
    (loss + (1.0 * aux["lb_loss"] + 1e-3 * aux["z_loss"]) / group.size).backward()
    grads = {n: D.all_reduce(p.grad.contiguous(), group.group) for n, p in params.items()}
    return dict(rows=(br.start, br.stop, tr.start, tr.stop), first=first, out=out.detach(),
                dx=x.grad, aux={n: float(v) for n, v in aux.items()}, grads=grads,
                group=(group.size, group.inner))


def moe_grads(step, local) -> dict:
    """The step's gradients of the rank's MoE parameters on `local` (no
    update), summed over the data and seq groups as the optimizer sums
    them: {name: gradient}."""
    _, grads = step.loss_and_grads(local)
    out = {}
    for n, g in grads.items():
        if ".moe_" in n:
            g = D.all_reduce(g.contiguous(), step.zero.group)
            if step.zero.seq is not None:
                g = D.all_reduce(g, step.zero.seq.group)
            out[n] = g
    return out


def moe_init_case(**axes) -> dict:
    """`init_vlm` of the MoE VLM (seed 0) on make_mesh(**axes): whether
    every parameter the rank holds (its stage's blocks, its experts of each
    bank) equals the one-device model's from the same seed, and how many."""
    cfg = moe_config(tconfig, False)
    mesh = make_mesh(**axes)
    experts = moe_ops.expert_parallel(mesh)
    model = init_vlm(cfg, device="cpu", seed=0, pp=P.pipe_parallel(mesh, cfg.decoder.num_layers),
                     ep=experts)
    whole = dict(init_vlm(cfg, device="cpu", seed=0).named_parameters())
    held = [(n, p) for n, p in model.named_parameters() if p.untyped_storage().nbytes() > 0]
    equal = True
    for n, p in held:
        want = whole[n]
        if experts is not None and ".kernel" in n and ".moe_" in n:
            local = p.shape[0]
            want = want[experts.rank * local:(experts.rank + 1) * local]
        equal &= torch.equal(p, want)
    return dict(equal=equal, held=len(held),
                banks=sorted(n for n, _ in held if n.endswith(".moe_gate.kernel")))


def moe_cases(out, load, workdir, axes):
    """The MoE VLM's finetune and PT steps on make_mesh(**axes) of each of
    `axes`, as moe_ft_<name> / moe_pt_<name>."""
    batches = {n: dict(np.load(os.path.join(workdir, f"{n}.npz"))) for n in ("ft", "pt")}
    for name, kw in axes:
        for kind, stage in (("ft", "finetune"), ("pt", "pretrain")):
            _, out[f"moe_{kind}_{name}"] = step_case(
                moe_config(tconfig, kind == "pt"), load(f"moe_{kind}.pkl"), batches[kind], stage,
                make_mesh(**kw), grads=kind == "ft")


def pipe_case(dp, pp, m, seed=0, dtype=np.float32, grads=False):
    mesh = make_mesh(dp=dp, pp=pp)
    group, stage, _ = D.pipe_group(mesh)
    w, b, h, scale = toy(seed, dtype=dtype)
    br = _rows(mesh, h.shape[0])
    blocks = [dict(w=torch.tensor(w[i]).requires_grad_(grads), b=torch.tensor(b[i]))
              for i in range(w.shape[0])]
    per = w.shape[0] // pp
    mine = [blk["w"] for blk in blocks[stage * per:(stage + 1) * per]] if grads else []
    hh = torch.tensor(h[br]).requires_grad_(grads)
    sends = D.p2p_sends
    out = P.pipeline_scan(toy_block, blocks, hh, dict(scale=torch.tensor(scale[br])), group=group,
                          n_micro=m, params=mine)
    rec = dict(rows=(br.start, br.stop), out=out.detach(), p2p=D.p2p_sends - sends, stage=stage)
    if grads:
        torch.sin(out).sum().backward()
        rec.update(dh=hh.grad, dw={stage * per + i: x.grad for i, x in enumerate(mine)})
    return rec


def dec_sp_case(tree, dp, sp, embeds):
    cfg = tconfig.tiny_test_vlm(distill=False).decoder
    mesh = make_mesh(dp=dp, sp=sp)
    dec = decoder_from_jax_params(tree, cfg, device="cpu")
    dec.seq = S.sequence_parallel(mesh)
    br, tr = _rows(mesh, embeds.shape[0]), dec.seq.rows(embeds.shape[1])
    sends, before = D.p2p_sends, _a2a_calls[0]
    with torch.no_grad():
        logits = dec(torch.tensor(embeds[br, tr]), use_kernel=False)["logits"]
    return dict(rows=(br.start, br.stop, tr.start, tr.stop), logits=logits,
                p2p=D.p2p_sends - sends, all_to_all=_a2a_calls[0] - before)


def dec_pp_decoder(tree, mesh):
    cfg = tconfig.tiny_test_vlm(distill=False).decoder
    pipe = P.pipe_parallel(mesh, cfg.num_layers)
    dec = P.shard_pipeline(decoder_from_jax_params(tree, cfg, device="cpu"), pipe)
    return dec, pipe


def main(workdir: str, part: str) -> None:
    t0 = time.perf_counter()
    D.init_distributed(device="cpu")
    rank, world = D.process_index(), D.process_count()
    assert world == 4, world

    def load(name):
        with open(os.path.join(workdir, name), "rb") as f:
            return pickle.load(f)

    out = {}
    if part == "sp":
        sequence_part(out, load, workdir)
    else:
        pipeline_part(out, load, workdir)
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    D.barrier()
    D.shutdown()


def step_case(cfg, tree, batch, stage, mesh, grads=False, **kw):
    """STEPS updates of the step on `mesh` from the JAX tree, on the rank's
    rows of `batch`: (the step, its record); with grads, a MoE model's
    step-1 gradients first (`moe_grads`)."""
    tp = T.tensor_parallel(mesh)
    pipe = P.pipe_parallel(mesh, cfg.decoder.num_layers)
    model = from_jax_params(tree, cfg, device="cpu", tp=tp, pp=pipe,
                            ep=moe_ops.expert_parallel(mesh))
    step = tts.make_train_step(cfg, OptimizerConfig(**OPT, stage=stage), model, mesh=mesh, **kw)
    br = _rows(mesh, batch["labels"].shape[0])
    local = D.shard_batch_multihost({k: v[br] for k, v in batch.items()}, mesh)
    step_1 = moe_grads(step, local) if grads else None
    sends, gathers, metrics = [], [], []
    for _ in range(STEPS):
        before, gathered = D.p2p_sends, _gathers[0]
        metrics.append(step(local))
        sends.append(D.p2p_sends - before)
        gathers.append(_gathers[0] - gathered)
    state = {k: v.detach().clone() for k, v in step.state_tensors().items()}
    held = {int(n.split(".")[2]) for n, p in model.named_parameters()
            if n.startswith("decoder.blocks.") and p.untyped_storage().nbytes() > 0}
    ep = model.decoder.ep
    return step, dict(metrics=metrics, p2p=sends, gathers=gathers, grads=step_1,
                      expert_first=0 if ep is None else ep.rank * (cfg.decoder.moe_experts // ep.size),
                      foreign=[] if pipe is None else pipe.foreign,
                      state=state if D.process_index() == 0 else None,
                      keys=sorted(state), held_blocks=sorted(held), trainable=len(step.trainable),
                      segments=None if step.grad_stream is None else step.grad_stream.ranges,
                      optimizer=type(step.optimizer).__name__)


def lever_cases(out, prefix, cfg, tree, batch, stage, mesh_kw, levers=LEVERS):
    """`step_case` with each (offload_opt_state, stream_grads) of `levers`
    on make_mesh(**mesh_kw), recorded as <prefix>_<lever>; the last step."""
    step = None
    for offload, stream in levers:
        del step
        step, out[f"{prefix}_{lever(offload, stream)}"] = step_case(
            cfg, tree, batch, stage, make_mesh(**mesh_kw), offload_opt_state=offload,
            stream_grads=stream)
    return step


def trainer_case(cfg, tree, batch, workdir, name, stage="finetune", **axes):
    """`trainer.train` on a mesh of `axes` (TrainerConfig's dp / tp / sp /
    pp), 2 steps of `stage` on the rank's rows of `batch`, a checkpoint at
    step 2: the step and the last metrics (the coordinator writes the
    files)."""
    mesh = make_mesh(**axes)
    model = from_jax_params(tree, cfg, device="cpu", tp=T.tensor_parallel(mesh),
                            pp=P.pipe_parallel(mesh, cfg.decoder.num_layers))
    br = _rows(mesh, batch["labels"].shape[0])
    local = {k: v[br] for k, v in batch.items()}
    state = train(cfg, OptimizerConfig(**OPT, stage=stage),
                  TrainerConfig(output_dir=os.path.join(workdir, name), device="cpu", max_steps=2,
                                save_steps=2, **axes),
                  model, lambda epoch: iter([local, local]))
    return dict(step=state.step, metrics=state.last_metrics)


def sequence_part(out, load, workdir):
    out["ulysses"] = {c: attention_case(S.ulysses_attention, c[0], c[1], 4, c[2], 0) for c in ULYSSES}
    out["ring"] = {c: attention_case(S.ring_attention, *c, 10) for c in RING}
    out["route"] = attention_case(multi_head_attention, 1, 4, 4, 2, 12)
    rng = np.random.default_rng(4)
    embeds = rng.normal(size=(2, 32, 64)).astype(np.float32)
    dec_tree = load("dec.pkl")
    out["dec_sp4"] = dec_sp_case(dec_tree, 1, 4, embeds)
    embeds22 = np.concatenate([embeds, rng.normal(size=(2, 32, 64)).astype(np.float32)])
    out["dec_dp2_sp2"] = dec_sp_case(dec_tree, 2, 2, embeds22)
    cfg_ft = tconfig.tiny_test_vlm(distill=False)
    cfg_pt = tconfig.tiny_test_vlm(distill=True)
    ft_batch = dict(np.load(os.path.join(workdir, "ft.npz")))
    pt_batch = dict(np.load(os.path.join(workdir, "pt.npz")))
    _, out["ft_dp2_sp2"] = step_case(cfg_ft, load("ft.pkl"), ft_batch, "finetune",
                                     make_mesh(dp=2, sp=2))
    _, out["pt_dp2_sp2"] = step_case(cfg_pt, load("pt.pkl"), pt_batch, "pretrain",
                                     make_mesh(dp=2, sp=2))
    out["trainer_dp2_sp2"] = trainer_case(cfg_ft, load("ft.pkl"), ft_batch, workdir,
                                          "trainer_dp2_sp2", dp=2, sp=2)
    lever_cases(out, "ft_dp2_sp2", cfg_ft, load("ft.pkl"), ft_batch, "finetune", dict(dp=2, sp=2))
    _, out["lora_dp2_sp2"] = step_case(lora_config(tconfig), load("lora.pkl"), ft_batch, "lora",
                                       make_mesh(dp=2, sp=2))
    out["moe_layer"] = {name: moe_layer_case(workdir, *c) for name, *c in MOE_LAYERS}
    moe_cases(out, load, workdir, (("dp2_sp2", dict(dp=2, sp=2)), ("sp2_ep2", dict(sp=2, ep=2))))


def pipeline_part(out, load, workdir):
    dec_tree = load("dec.pkl")
    out["pipe"] = {c: pipe_case(*c) for c in PIPE}
    out["pipe_f64"] = pipe_case(1, 4, 8, seed=1, dtype=np.float64)
    out["pipe_grads"] = pipe_case(1, 4, 4, seed=2, grads=True)
    w, b, h, scale = toy(4, L=6)
    try:
        P.pipeline_scan(toy_block, [dict(w=torch.tensor(x), b=torch.tensor(y)) for x, y in
                                    zip(w, b)], torch.tensor(h), dict(scale=torch.tensor(scale)),
                        group=D.pipe_group(make_mesh(dp=1, pp=4))[0])
        out["layer_guard"] = None
    except ValueError as e:
        out["layer_guard"] = str(e)

    rng = np.random.default_rng(5)
    embeds8 = rng.normal(size=(8, 32, 64)).astype(np.float32)
    lengths8 = np.array([32] * 7 + [20], np.int32)
    dec, pipe = dec_pp_decoder(dec_tree, make_mesh(dp=1, pp=4))
    sends = D.p2p_sends
    with torch.no_grad():
        logits = dec(torch.tensor(embeds8), kv_lengths=torch.tensor(lengths8),
                     use_kernel=False)["logits"]
    out["dec_pp4"] = dict(logits=logits, p2p=D.p2p_sends - sends,
                          held=sum(p.untyped_storage().nbytes() > 0 for p in dec.parameters()),
                          stage=pipe.rank)
    # both axes at once: each stage's seq ranks pipeline their rows
    mesh = make_mesh(sp=2, pp=2)
    dec, pipe = dec_pp_decoder(dec_tree, mesh)
    dec.seq = S.sequence_parallel(mesh)
    tr = dec.seq.rows(32)
    sends = D.p2p_sends
    with torch.no_grad():
        logits = dec(torch.tensor(embeds8[:4, tr]), kv_lengths=torch.tensor(lengths8[:4]),
                     use_kernel=False)["logits"]
    out["dec_sp2_pp2"] = dict(logits=logits, rows=(0, 4, tr.start, tr.stop),
                              p2p=D.p2p_sends - sends, stage=pipe.rank)
    rng = np.random.default_rng(6)
    embeds4 = rng.normal(size=(4, 32, 64)).astype(np.float32)
    mesh = make_mesh(dp=2, pp=2)
    dec, pipe = dec_pp_decoder(load("dec_remat.pkl"), mesh)
    br = _rows(mesh, 4)
    e = torch.tensor(embeds4[br]).requires_grad_(True)
    sends = D.p2p_sends
    lg = dec(e, remat=True, remat_policy="save_gate", use_kernel=False)["logits"]
    (lg.square().sum() / (4 * lg.shape[1] * lg.shape[2])).backward()
    out["dec_pp_remat"] = dict(rows=(br.start, br.stop), grad=e.grad, p2p=D.p2p_sends - sends)

    # -- the train steps -----------------------------------------------------
    cfg_ft = tconfig.tiny_test_vlm(distill=False)
    cfg_pt = tconfig.tiny_test_vlm(distill=True)
    ft_tree, pt_tree = load("ft.pkl"), load("pt.pkl")
    ft_batch = dict(np.load(os.path.join(workdir, "ft.npz")))
    pt_batch = dict(np.load(os.path.join(workdir, "pt.npz")))

    _, out["ft_pp2_tp2"] = step_case(cfg_ft, ft_tree, ft_batch, "finetune", make_mesh(tp=2, pp=2))
    # from_jax_params(pp=) holds the stage's blocks; whole_params gathers them back
    mesh = make_mesh(dp=2, pp=2)
    model = from_jax_params(ft_tree, cfg_ft, device="cpu",
                            pp=P.pipe_parallel(mesh, cfg_ft.decoder.num_layers))
    whole = P.whole_params(model)
    out["whole_params"] = ({n: t.clone() for n, t in whole.items()} if D.process_index() == 0
                           else None)
    out["held_blocks"] = sorted({int(n.split(".")[2]) for n, p in model.named_parameters()
                                 if n.startswith("decoder.blocks.")
                                 and p.untyped_storage().nbytes() > 0})
    del model, whole
    zstep, out["ft_dp2_pp2_zero"] = step_case(cfg_ft, ft_tree, ft_batch, "finetune",
                                              make_mesh(dp=2, pp=2), zero_params=True,
                                              zero_min_size=1024)
    out["ft_dp2_pp2_zero"]["shard_bytes"] = zstep.sharded.shard_bytes
    mgr = CheckpointManager(os.path.join(workdir, "ckpt"))
    mgr.save(STEPS, zstep, cfg_ft)
    mesh = make_mesh(dp=2, pp=2)
    back = tts.make_train_step(cfg_ft, OptimizerConfig(**OPT, stage="finetune"), from_jax_params(
        ft_tree, cfg_ft, device="cpu", pp=P.pipe_parallel(mesh, cfg_ft.decoder.num_layers)),
        mesh=mesh, zero_params=True, zero_min_size=1024)
    mgr.restore(back)
    restored = back.state_tensors()
    saved = {k: v.detach().clone() for k, v in zstep.state_tensors().items()}
    out["restore_pp2"] = dict(step=back.step, equal=sorted(saved) == sorted(restored) and all(
        torch.equal(saved[k], restored[k]) for k in saved))
    del zstep, back
    _, out["pt_dp2_pp2"] = step_case(cfg_pt, pt_tree, pt_batch, "pretrain", make_mesh(dp=2, pp=2))
    out["trainer_dp2_pp2"] = trainer_case(cfg_ft, ft_tree, ft_batch, workdir, "trainer_dp2_pp2",
                                          dp=2, pp=2)

    # -- the memory levers, LoRA and sp x pp ---------------------------------
    both = LEVERS[-1:]
    step = lever_cases(out, "ft_dp2_pp2", cfg_ft, ft_tree, ft_batch, "finetune", dict(dp=2, pp=2))
    CheckpointManager(os.path.join(workdir, "ckpt_levers")).save(STEPS, step, cfg_ft)
    del step
    lever_cases(out, "ft_pp2_tp2", cfg_ft, ft_tree, ft_batch, "finetune", dict(tp=2, pp=2), both)
    lever_cases(out, "pt_dp2_pp2", cfg_pt, pt_tree, pt_batch, "pretrain", dict(dp=2, pp=2), both)
    cfg_lora, lora_tree = lora_config(tconfig), load("lora.pkl")
    for name, axes in (("lora_dp2_pp2", dict(dp=2, pp=2)), ("lora_pp2_tp2", dict(tp=2, pp=2)),
                       ("lora_sp2_pp2", dict(sp=2, pp=2))):
        _, out[name] = step_case(cfg_lora, lora_tree, ft_batch, "lora", make_mesh(**axes))
    out["trainer_lora_dp2_pp2"] = trainer_case(cfg_lora, lora_tree, ft_batch, workdir,
                                               "trainer_lora_dp2_pp2", stage="lora", dp=2, pp=2)
    for prefix, cfg, tree, batch, stage in (("ft_sp2_pp2", cfg_ft, ft_tree, ft_batch, "finetune"),
                                            ("pt_sp2_pp2", cfg_pt, pt_tree, pt_batch, "pretrain")):
        _, out[prefix] = step_case(cfg, tree, batch, stage, make_mesh(sp=2, pp=2))
        lever_cases(out, prefix, cfg, tree, batch, stage, dict(sp=2, pp=2), both)
    out["moe_init"] = {name: moe_init_case(**kw) for name, kw in (
        ("dp2_pp2", dict(dp=2, pp=2)), ("pp2_ep2", dict(pp=2, ep=2)))}
    moe_cases(out, load, workdir, (("dp2_pp2", dict(dp=2, pp=2)), ("pp2_ep2", dict(pp=2, ep=2))))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
