"""What tests/test_torch_sequence_parallel.py and
tests/test_torch_pipeline_parallel.py share: the JAX trees and batches the
four ranks of tests/_torch_sp_pp_worker.py start from, the spawn (its own
timeout; a rank that fails or hangs kills the others), and JAX's
single-device steps that the ranks' steps are held to.
"""

import dataclasses
import os
import pickle
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from visper_lm_tpu.data.collate import build_splice_plan, collate_plans
from visper_lm_tpu.models import vlm as jvlm
from visper_lm_tpu.models.decoder import init_decoder
from visper_lm_tpu.ops import moe as jmoe
from visper_lm_tpu.parallel.mesh import make_mesh
from visper_lm_tpu.train import optimizer as jopt
from visper_lm_tpu.train import train_step as jts

from visper_lm_tpu_torch.train import optimizer as topt
from visper_lm_tpu_torch.utils.param import is_expert_kernel, split_layer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_spawn as S  # noqa: E402
from _torch_sp_pp_worker import MOE_LAYER_CF, OPT, STEPS, lora_config, moe_config  # noqa: E402

WORLD = 4
SPAWN_TIMEOUT = 300


def batch(cfg, pt: bool, bsz: int = 4, seq: int = 64):
    """A global batch of 4 at T 64 (rows of other lengths; with the
    distillation targets for PT)."""
    rng = np.random.default_rng(1 if pt else 0)
    plans = []
    for b in range(bsz):
        ids = [1, 2, 3] + [IMAGE_TOKEN_INDEX] + list(rng.integers(3, 400, size=8 + 9 * b))
        labels = [IGNORE_INDEX] * 4 + ids[4:]
        plans.append(build_splice_plan(ids, labels, seq, num_image_tokens=cfg.num_image_tokens,
                                       num_task_tokens=2 if pt else 0, num_tasks=3 if pt else 0))
    out = collate_plans(plans, images=rng.normal(size=(bsz, 28, 28, 3)).astype(np.float32))
    if pt:
        for t in cfg.distill.tasks:
            out[f"{t.task}_target"] = rng.normal(
                size=(bsz, t.target_tokens, t.target_dim)).astype(np.float32)
            out[f"{t.task}_mask"] = np.array([1, 0, 1, 1], np.float32)
    return out


def write_inputs(workdir):
    """The JAX trees and batches, written for the ranks; returns them."""
    dcfg = jconfig.tiny_test_vlm(distill=False).decoder
    lora = jvlm.init_vlm(jax.random.PRNGKey(0), lora_config(jconfig))
    rng = np.random.default_rng(1)        # a B that is not zero: the side path is live
    lora["lora"] = {k: {"a": ab["a"], "b": rng.normal(0, 0.05, ab["b"].shape).astype(np.float32)}
                    for k, ab in lora["lora"].items()}
    trees = dict(dec=init_decoder(jax.random.PRNGKey(0), dcfg),
                 dec_remat=init_decoder(jax.random.PRNGKey(1), dcfg),
                 ft=jvlm.init_vlm(jax.random.PRNGKey(0), jconfig.tiny_test_vlm(distill=False)),
                 pt=jvlm.init_vlm(jax.random.PRNGKey(0), jconfig.tiny_test_vlm(distill=True)),
                 lora=lora,
                 moe_ft=jvlm.init_vlm(jax.random.PRNGKey(2), moe_config(jconfig, False)),
                 moe_pt=jvlm.init_vlm(jax.random.PRNGKey(2), moe_config(jconfig, True)))
    for name, tree in trees.items():
        with open(os.path.join(workdir, f"{name}.pkl"), "wb") as f:
            pickle.dump(jax.tree_util.tree_map(np.asarray, tree), f)
    batches = dict(ft=batch(jconfig.tiny_test_vlm(distill=False), pt=False),
                   pt=batch(jconfig.tiny_test_vlm(distill=True), pt=True))
    for name, b in batches.items():
        np.savez(os.path.join(workdir, f"{name}.npz"), **b)
    np.savez(os.path.join(workdir, "moe_layer.npz"), **moe_layer_inputs())
    return trees, batches


def moe_layer_inputs():
    """The MoE layer cases' weights (JAX `init_moe_mlp`: D 32, F 64, E 4),
    global input (4, 16, 32) and readout, as numpy."""
    params = jmoe.init_moe_mlp(jax.random.PRNGKey(6), 32, 64, 4, dtype=jnp.float32)
    rng = np.random.default_rng(7)
    out = {k: np.asarray(v) for k, v in params.items()}
    out["x"] = rng.normal(size=(4, 16, 32)).astype(np.float32)
    out["r"] = rng.normal(size=(4, 16, 32)).astype(np.float32)
    return out


def moe_layer_refs(inp, dp, sp):
    """JAX's one-device `moe_mlp` on the global input: the output, aux and
    gradients of sum(out r) + w lb + 1e-3 z at w 1.0 (the ranks' loss) and
    the router's at w 2.0 (the aux counted twice); and the output of the
    same call with the tokens in rank-major order (each rank's rows one
    after another: what a priority taken rank by rank would give), put
    back in the global order."""
    params = {k: jnp.asarray(inp[k]) for k in ("router", "gate", "up", "down")}
    x, r = jnp.asarray(inp["x"]), jnp.asarray(inp["r"])

    def loss(p, xx, w):
        out, aux = jmoe.moe_mlp(p, xx, top_k=2, capacity_factor=MOE_LAYER_CF)
        return jnp.sum(out * r) + w * aux["lb_loss"] + 1e-3 * aux["z_loss"], (out, aux)

    grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True), static_argnums=2)
    (_, (out, aux)), (gp, gx) = grad(params, x, 1.0)
    twice = grad(params, x, 2.0)[1][0]["router"]
    b, t, d = inp["x"].shape
    # (dp, b/dp, sp, t/sp, d) -> rank-major (dp, sp, b/dp, t/sp, d) tokens
    blocks = inp["x"].reshape(dp, b // dp, sp, t // sp, d).transpose(0, 2, 1, 3, 4)
    rm, _ = jmoe.moe_mlp(params, jnp.asarray(blocks.reshape(1, b * t, d)), top_k=2,
                         capacity_factor=MOE_LAYER_CF)
    rm = np.asarray(rm).reshape(dp, sp, b // dp, t // sp, d).transpose(0, 2, 1, 3, 4)
    return dict(out=np.asarray(out), aux={k: float(v) for k, v in aux.items()},
                grads={k: np.asarray(v) for k, v in gp.items()}, dx=np.asarray(gx),
                router_aux_twice=np.asarray(twice), rank_major_out=rm.reshape(b, t, d))


def spawn(workdir, part: str):
    return S.spawn("_torch_sp_pp_worker.py", [workdir, part], WORLD, workdir, PYTHONHASHSEED="0")


def wait(procs, workdir):
    """Every rank's exit code 0 within SPAWN_TIMEOUT. A rank that fails
    stops the others at once (they would wait on it in a collective); a
    hang fails the test. No rank is left running (tests/_torch_spawn.py)."""
    S.wait(procs, workdir, SPAWN_TIMEOUT)


def flat(tree):
    return {jopt._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_steps(cfg, params, b, stage, ep=1):
    """JAX's single-device step, STEPS updates on the global batch: the
    metrics of each and the trainables after. ep: JAX's step of a MoE tree
    needs an 'expert' axis (ROADMAP C27): make_mesh(ep=2) of two virtual
    devices, whose result GSPMD makes the one-device step's."""
    mesh = make_mesh(dp=1, tp=1, ep=ep, devices=jax.devices()[:ep])
    with mesh:
        step, state, _ = jts.make_train_step(cfg, jopt.OptimizerConfig(**OPT, stage=stage), params,
                                             mesh, use_pallas=False)
        dbatch = jts.shard_batch(b, mesh)
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, dbatch)
            metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, params=flat(state.params))


def check_metrics(got, want, rtol=1e-5):
    for m_t, m_j in zip(got, want):
        for k in m_j:
            np.testing.assert_allclose(m_t[k], m_j[k], rtol=rtol, atol=1e-7, err_msg=k)


def check_params(state, ref_params, atol=2e-5):
    """Every trainable of a one-device state file against JAX's (the
    tolerances of tests/test_torch_tensor_parallel.py unless `atol` says
    otherwise); returns how many."""
    names = [k[len("params/"):] for k in state if k.startswith("params/")]
    for n in names:
        ref, layer = ref_params[topt.jax_path(n)], split_layer(n)[1]
        got = state[f"params/{n}"].numpy()
        path = topt.jax_path(n)
        got = got.T if path.endswith("/kernel") and not is_expert_kernel(path) else got
        np.testing.assert_allclose(got, ref if layer is None else ref[layer], atol=atol,
                                   rtol=1e-4, err_msg=n)
    return len(names)


def grad_close(got, want, msg=""):
    """tests/test_torch_expert_parallel.py's gradient bound: rtol 2e-5, atol
    1e-5 x the largest |gradient|."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=2e-5,
                               atol=1e-5 * float(np.abs(want).max()), err_msg=msg)


def _moe_ref(grads, n, first, local):
    """JAX's gradient of the port's MoE parameter n (layer's slice; the
    router transposed to the port's (E, D), a bank's rows of the rank's
    experts)."""
    ref = grads[topt.jax_path(n)][split_layer(n)[1]]
    return ref.T if ".moe_router." in n else ref[first:first + local]


def check_moe_step(recs, ref, kind):
    """A MoE step case against JAX's: every rank's metrics of 3 updates
    (rtol 1e-5, equal across the ranks), routes dropped, the state after
    them (atol 1e-4 / rtol 1e-4: a thirtieth of the largest move, 3e-3 over
    the updates; Adam's normalised step turns the f32 difference of a
    near-zero gradient element, summed in another order over the ranks,
    into a larger difference of its move); in the finetune step the step-1
    gradients
    of each rank's MoE parameters (the router's, with the aux weight 1.0,
    beyond the bound of the aux counted twice)."""
    for r in recs:
        check_metrics(r["metrics"], ref["metrics"])
        assert r["metrics"] == recs[0]["metrics"]
    assert recs[0]["metrics"][0]["moe_dropped_frac"] > 0
    assert recs[0]["metrics"][2]["loss"] != recs[0]["metrics"][1]["loss"]
    # the whole state (a pipeline's stages gathered) against JAX's
    n = check_params(recs[0]["state"], ref["params"], atol=1e-4)
    assert n >= recs[0]["trainable"] > 0 and all(r["keys"] == recs[0]["keys"] for r in recs)
    if kind != "ft":
        return
    routers = 0
    for r, rec in enumerate(recs):
        assert rec["grads"], r
        for n, g in rec["grads"].items():
            got = g.numpy()
            grad_close(got, _moe_ref(ref["grads"], n, rec["expert_first"], got.shape[0]),
                       msg=f"rank {r} {n}")
            if ".moe_router." in n:
                routers += 1
                twice = _moe_ref(ref["grads_aux_twice"], n, 0, got.shape[0])
                assert not np.allclose(got, twice, rtol=2e-5,
                                       atol=1e-5 * float(np.abs(twice).max())), n
    assert routers


def run(tmp_path_factory, part: str, refs):
    """Spawn the ranks of `part`, compute `refs(trees, batches)` on the JAX
    side while they run, and return (the ranks' records, refs' result, the
    workdir)."""
    workdir = tmp_path_factory.mktemp(part)
    trees, batches = write_inputs(workdir)
    procs = spawn(workdir, part)
    try:
        ref = refs(trees, batches)
    finally:
        wait(procs, workdir)
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, ref, workdir


def step_refs(trees, batches, pt: bool):
    """JAX's finetune step, its LoRA stage (on the finetune batch) and with
    pt its PT step, from the trees."""
    out = dict(ft=jax_steps(jconfig.tiny_test_vlm(distill=False), trees["ft"], batches["ft"],
                            "finetune"),
               lora=jax_steps(lora_config(jconfig), trees["lora"], batches["ft"], "lora"))
    if pt:
        out["pt"] = jax_steps(jconfig.tiny_test_vlm(distill=True), trees["pt"], batches["pt"],
                              "pretrain")
    return out


def moe_step_refs(trees, batches):
    """JAX's finetune and PT steps of the MoE VLM (aux weight 1.0) on the
    global batches, the finetune step's step-1 gradients, and the router's
    step-1 gradient with the aux weight doubled (the aux counted twice)."""
    out = {}
    for kind, stage in (("ft", "finetune"), ("pt", "pretrain")):
        cfg = moe_config(jconfig, kind == "pt")
        out[kind] = jax_steps(cfg, trees[f"moe_{kind}"], batches[kind], stage, ep=2)
    batch = {k: jnp.asarray(v) for k, v in batches["ft"].items()}
    for name, w in (("grads", 1.0), ("grads_aux_twice", 2.0)):
        cfg = moe_config(jconfig, False)
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, moe_aux_weight=w))
        grads = jax.jit(jax.grad(lambda p, bb: jts.make_loss_fn(cfg, use_pallas=False)(p, bb)[0]))(
            trees["moe_ft"], batch)
        out["ft"][name] = {k: v for k, v in flat(grads).items() if "/moe_" in k}
    return out

