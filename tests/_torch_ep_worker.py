"""One rank of tests/test_torch_expert_parallel.py: the port's MoE layer and
MoE finetune step under data and expert parallelism on gloo over the CPU
(four ranks).

    VISPER_COORDINATOR=localhost:<port> VISPER_NUM_PROCESSES=4 VISPER_PROCESS_ID=<rank> \\
        python tests/_torch_ep_worker.py <workdir>

`<workdir>` holds what the test wrote: moe.npz (a layer's JAX weights, the
global input of 4 rows and a readout), params.pkl (the MoE VLM's JAX tree,
as numpy) and batch.npz (the global finetune batch of 4). Each rank writes
what it computed to rank<r>.pt:

  layer     `moe_mlp` on the rank's rows at dp 2 (x tp 2: the whole banks;
            a capacity factor that drops routes), dp 2 x ep 2 and ep 2 x tp 2
            (the rank's two experts): the rank's output rows, the aux, and
            the gradients of the router, the banks and the input, the
            parameters' summed over the data group as the optimizer sums
            them;
  ep_dp     the finetune step at dp 2 x ep 2 (ZeRO-1/2 moments on the banks:
            JAX's plan): step-1 loss and metrics, 3 updates, each update's
            metrics, the state gathered whole (`TrainStep.state_tensors`),
            the rank's router and the bytes of its banks; then, after the
            steps, greedy generation and a decoder forward on the data
            rank's own prompts (`after_step`), against one process's whole
            model with the gathered weights;
  ep_tp     the same at ep 2 x tp 2 (dp 1), without `after_step`;
  ep_dp_offload  ep_dp with offload_opt_state (`OffloadedAdamW`, no floor
            on a tensor's bytes): which state tensors its plan puts on the
            host, the same records.
"""

import os
import pickle
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from visper_lm_tpu_torch import config as tconfig  # noqa: E402
from visper_lm_tpu_torch.ops import moe as tmoe  # noqa: E402
from visper_lm_tpu_torch.parallel import distributed as D  # noqa: E402
from visper_lm_tpu_torch.parallel.tensor import tensor_parallel  # noqa: E402
from visper_lm_tpu_torch.train import train_step as tts  # noqa: E402
from visper_lm_tpu_torch.train.staged_update import OffloadedAdamW  # noqa: E402
from visper_lm_tpu_torch.train.optimizer import OptimizerConfig  # noqa: E402
from visper_lm_tpu_torch.weights import from_jax_params  # noqa: E402

OPT = dict(learning_rate=3e-3, total_steps=30, warmup_ratio=0.1, stage="finetune")
STEPS = 3
# the layer's calls: (name, dp, ep, tp, top_k, capacity factor); at dp 2 the
# 'model' axis (2) only makes the mesh span the four ranks
LAYER_CASES = (("dp2", 2, 1, 2, 2, 0.5), ("ep2_dp2", 2, 2, 1, 2, 0.5), ("ep2_tp2", 1, 2, 2, 2, 2.0))


def moe_configs(cf: float = 1.25):
    """tiny_test_vlm(distill=False) with JAX's dry-run MoE: E 4, top-2."""
    import dataclasses

    cfg = tconfig.tiny_test_vlm(distill=False)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, moe_experts=4, moe_top_k=2, moe_capacity_factor=cf))


def layer(workdir: str, dp: int, ep: int, tp: int, k: int, cf: float) -> dict:
    """`moe_mlp` on this rank's rows at (dp, ep, tp): output, aux, gradients."""
    mesh = D.make_global_mesh(dp=dp, ep=ep, tp=tp)
    data = D.AxisGroup(*D.data_group(mesh)) if dp > 1 else None
    group = tmoe.expert_parallel(mesh)
    inp = np.load(os.path.join(workdir, "moe.npz"))
    index, count = D.data_shard(mesh)
    rows = slice(index * 4 // count, (index + 1) * 4 // count)
    e_local = 4 // ep
    first = 0 if group is None else group.rank * e_local
    params = {n: torch.from_numpy(np.array(inp[n][first:first + e_local] if n != "router"
                                           else inp[n])).requires_grad_(True)
              for n in ("router", "gate", "up", "down")}
    x = torch.from_numpy(np.array(inp["x"][rows])).requires_grad_(True)
    r = torch.from_numpy(np.array(inp["r"][rows]))
    out, aux = tmoe.moe_mlp(params, x, top_k=k, capacity_factor=cf, ep=group, data=data)
    # the rank's share of the global loss sum(out r) + 0.01 lb + 1e-3 z
    ((out * r).sum() + (0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]) / dp).backward()
    grads = {}
    for n, p in params.items():
        g = p.grad.contiguous()
        if data is not None:
            D.all_reduce(g, data.group)
        grads[n] = g
    return dict(rows=(rows.start, rows.stop), first=first, out=out.detach(), dx=x.grad,
                aux={n: float(v) for n, v in aux.items()}, grads=grads)


def finetune(workdir: str, dp: int, ep: int, tp: int, offload: bool = False) -> dict:
    """The finetune step of the MoE VLM at (dp, ep, tp) from JAX's weights;
    offload: with offload_opt_state (`OffloadedAdamW` planned with no
    floor on a tensor's bytes, so that the tiny banks' moments can qualify)."""
    mesh = D.make_global_mesh(dp=dp, ep=ep, tp=tp)
    group, tpg = tmoe.expert_parallel(mesh), tensor_parallel(mesh)
    cfg = moe_configs()
    with open(os.path.join(workdir, "params.pkl"), "rb") as f:
        tree = pickle.load(f)
    model = from_jax_params(tree, cfg, device="cpu", tp=tpg, ep=group)
    step = tts.make_train_step(cfg, OptimizerConfig(**OPT), model, mesh=mesh,
                               offload_opt_state=offload)
    on_host = None
    if offload:
        step.optimizer = OffloadedAdamW(step.trainable.items(), OptimizerConfig(**OPT),
                                        min_bytes=0, zero=step.zero, sharded=step.sharded)
        on_host = sorted(k for k, v in step.optimizer.plan.items() if v is not None)
    batch = dict(np.load(os.path.join(workdir, "batch.npz")))
    index, count = D.data_shard(mesh)
    rows = slice(index * 4 // count, (index + 1) * 4 // count)
    local = D.shard_batch_multihost({k: v[rows] for k, v in batch.items()}, mesh)
    met, _ = step.loss_and_grads(local)
    shares = D.all_reduce_scalars(list(met.values()), step.zero.group)
    metrics = [step(local) for _ in range(STEPS)]
    blk = model.decoder.blocks[0]
    state = {k: v.detach().cpu() for k, v in step.state_tensors().items()}
    return dict(
        step1={k: float(v) for k, v in zip(met, shares)}, metrics=metrics,
        state=state,
        router=blk.moe_router.weight.detach().clone(),
        q_proj=blk.q_proj.weight.detach().clone(),
        bank_experts=int(blk.moe_gate.kernel.shape[0]), first=blk.moe_gate.first,
        banks_sharded=sorted(n for n, pl in step.zero.moments.items()
                             if pl.sharded and ".moe_" in n),
        on_host=on_host, optimizer=type(step.optimizer).__name__,
        after=after_step(model, cfg, tree, state, index) if dp > 1 and not offload else None)


def after_step(model, cfg, tree, state, index: int) -> dict:
    """After the dp 2 x ep 2 steps: greedy generation (4 tokens) and a
    decoder forward on this data rank's own prompts and hidden states (the
    two data ranks' differ), through the rank's model and through one
    process's whole model holding the gathered weights. The step's routing
    over the data group must not outlive the step: serving and eval route
    over their own tokens."""
    from visper_lm_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from visper_lm_tpu_torch.data.collate import build_splice_plan
    from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator, left_pad_plans

    whole = from_jax_params(tree, cfg, device="cpu")
    params = dict(whole.named_parameters())
    with torch.no_grad():
        for k, v in state.items():
            if k.startswith("params/"):
                params[k[len("params/"):]].copy_(v)
    rng = np.random.default_rng(20 + index)
    plans = [build_splice_plan(
        [1, 2, 3, IMAGE_TOKEN_INDEX] + [int(t) for t in rng.integers(4, 400, size=5 + 3 * b)],
        None, 32, num_image_tokens=cfg.num_image_tokens) for b in range(2)]
    batch = left_pad_plans(plans, 32)
    batch["images"] = rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(2, 16, cfg.decoder.hidden_size)).astype(np.float32))
    out = {}
    for name, m in (("ranks", model), ("whole", whole)):
        gen = Generator(m, cfg, GenerationConfig(max_new_tokens=4, decode_chunk=2), 2, 32,
                        cache_dtype=torch.float32, device="cpu")
        logits, _ = gen.prefill(batch)
        with torch.no_grad():
            aux = m.decoder(x, use_kernel=False)["moe_aux"]
        out[name] = dict(tokens=gen.generate(batch), logits=logits,
                         aux={k: float(v) for k, v in aux.items()})
    return out


def main(workdir: str) -> None:
    D.init_distributed(device="cpu")
    rank = D.process_index()
    out = {"layer": {name: layer(workdir, *case) for name, *case in LAYER_CASES}}
    out["ep_dp"] = finetune(workdir, 2, 2, 1)
    out["ep_tp"] = finetune(workdir, 1, 2, 2)
    out["ep_dp_offload"] = finetune(workdir, 2, 2, 1, offload=True)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    D.barrier()
    D.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
