"""Expert parallelism and the MoE layer's global-batch semantics in the port
(visper_lm_tpu_torch/ops/moe.py, the 'expert' mesh axis, the MoE step) on
four gloo ranks on the CPU, against the JAX package.

One spawn of tests/_torch_ep_worker.py (four processes from the VISPER_*
environment, a free port, its own timeout) runs every case; the ranks
write what they computed to files, and the tests below compare, in f32:

  1. `moe_mlp` at dp 2 with a capacity factor that drops routes: each
     rank's output rows, the dropped share (exactly) and the load-balance
     loss equal JAX's one-device call on the global batch (capacity,
     priority and aux over the global batch, as JAX computes them);
  2. `moe_mlp` at dp 2 x ep 2 and at ep 2 x tp 2 (two experts a rank): the
     same, and the gradients: the router's on every rank the one-device
     gradient (neither partial nor counted ep times), each rank's bank
     slices the one-device gradient's, the input's the whole gradient
     (tests/test_moe.py `test_expert_parallel_matches_single_device` with
     its JAX mesh replaced by ranks);
  3. the finetune step of a MoE VLM (tiny_test_vlm, E 4, top-2, cf 1.25) at
     dp 2 x ep 2 (JAX's ZeRO plan puts the banks' moments over 'data') and
     at ep 2 x tp 2, against JAX's `make_train_step` on the matching
     `make_mesh(dp=, ep=, tp=)` of the suite's virtual devices: step-1 loss
     and MoE metrics and each update's (rtol 1e-5), the state after 3
     updates gathered whole (atol 5e-5 / rtol 1e-4, as
     tests/test_torch_moe.py); the router and the replicated parameters
     bit-equal across the ranks that hold them; two experts a rank;
  4. after the dp 2 x ep 2 steps, greedy generation and a decoder forward
     on each data rank's own prompts: the rank's tokens, prefill logits
     and aux equal one process's whole model with the gathered weights
     (the step's routing over the data group ends with the step);
  5. the dp 2 x ep 2 step with offload_opt_state: JAX's plan (`_covers_mesh`
     on 'data' and 'expert') puts each bank's moments, the rank's E/ep
     experts of them, on the host and keeps the dense ones on the card; the
     metrics, the trainables and the moments after 3 updates are the plain
     step's bit for bit (the global norm over every rank's slices).

Tolerances of the layer: outputs, aux and gradients rtol 2e-5 / atol 2e-6
(gradients atol 1e-5 x the largest |grad|).
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu.models import vlm as jvlm
from visper_lm_tpu.ops import moe as jmoe
from visper_lm_tpu.parallel.mesh import make_mesh
from visper_lm_tpu.train import optimizer as jopt
from visper_lm_tpu.train import train_step as jts

from visper_lm_tpu_torch.utils.param import jax_flat_arrays

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_spawn as S  # noqa: E402
from _torch_ep_worker import LAYER_CASES, OPT, STEPS  # noqa: E402
from test_torch_moe import _vlm_batch, moe_vlm_configs  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SPAWN_TIMEOUT = 420


def _spawn(workdir):
    return S.spawn("_torch_ep_worker.py", [workdir], WORLD, workdir, PYTHONHASHSEED="0")


def _wait(procs, workdir):
    """Every rank's exit code 0 within SPAWN_TIMEOUT; a hang or a failure
    fails the test (and kills the ranks: tests/_torch_spawn.py)."""
    S.wait(procs, workdir, SPAWN_TIMEOUT)


def _flat(tree):
    return {jopt._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (spawned first, so they run while JAX compiles) and
    JAX's: the one-device layer calls on the global batch and their
    gradients; the finetune step's step-1 loss and metrics, and its updates
    on make_mesh(dp=2, ep=2) and make_mesh(ep=2, tp=2)."""
    workdir = tmp_path_factory.mktemp("ep")
    layer_p = jmoe.init_moe_mlp(jax.random.PRNGKey(6), 32, 64, 4, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(7), (4, 16, 32), jnp.float32)
    r = jax.random.normal(jax.random.PRNGKey(8), (4, 16, 32), jnp.float32)
    np.savez(workdir / "moe.npz", x=np.asarray(x), r=np.asarray(r),
             **{k: np.asarray(v) for k, v in layer_p.items()})
    cfg_j, _ = moe_vlm_configs()
    params = jvlm.init_vlm(jax.random.PRNGKey(2), cfg_j)
    with open(workdir / "params.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, params), f)
    batch = _vlm_batch(cfg_j)
    np.savez(workdir / "batch.npz", **batch)
    procs = _spawn(workdir)
    try:
        layer = {}
        for name, _, _, _, k, cf in LAYER_CASES:
            def loss(p, xx):
                out, aux = jmoe.moe_mlp(p, xx, top_k=k, capacity_factor=cf)
                return jnp.sum(out * r) + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"], (out, aux)

            (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(layer_p, x)
            layer[name] = dict(out=np.asarray(out), aux={n: float(v) for n, v in aux.items()},
                               grads={n: np.asarray(v) for n, v in gp.items()}, dx=np.asarray(gx))
        loss_fn = jts.make_loss_fn(cfg_j, use_pallas=False)
        _, met = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})[0]
        step1 = {k: float(v) for k, v in met.items()}
        ref = {}
        for name, kw in (("ep_dp", dict(dp=2, ep=2)), ("ep_tp", dict(dp=1, ep=2, tp=2))):
            mesh = make_mesh(**kw, devices=jax.devices()[:4])
            with mesh:
                step_j, state, _ = jts.make_train_step(cfg_j, jopt.OptimizerConfig(**OPT),
                                                       params, mesh, use_pallas=False)
                dbatch = jts.shard_batch(batch, mesh)
                metrics = []
                for _ in range(STEPS):
                    state, m = step_j(state, dbatch)
                    metrics.append({k: float(v) for k, v in m.items()})
            ref[name] = dict(params=_flat(state.params), metrics=metrics)
    finally:
        _wait(procs, workdir)
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(ranks=ranks, layer=layer, step1=step1, ref=ref)


def _close(got, want, rtol=2e-5, atol=2e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _grad_close(got, want, msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=2e-5,
                               atol=1e-5 * float(np.abs(want).max()), err_msg=msg)


def _check_layer(runs, name):
    ref = runs["layer"][name]
    for r, rank in enumerate(runs["ranks"]):
        got = rank["layer"][name]
        rows = slice(*got["rows"])
        _close(got["out"], ref["out"][rows], msg=f"rank {r} out")
        assert got["aux"]["dropped_frac"] == ref["aux"]["dropped_frac"], r
        for k in ("lb_loss", "z_loss"):
            _close(got["aux"][k], ref["aux"][k], msg=f"rank {r} {k}")
    return ref


@pytest.mark.parametrize("name", ["dp2", "ep2_dp2", "ep2_tp2"])
def test_moe_layer_matches_the_global_batch(runs, name):
    ref = _check_layer(runs, name)
    if name != "ep2_tp2":
        # the capacity binds: routes are dropped over the global batch
        assert ref["aux"]["dropped_frac"] > 0


@pytest.mark.parametrize("name", ["dp2", "ep2_dp2", "ep2_tp2"])
def test_moe_layer_gradients_are_the_one_device_gradients(runs, name):
    ref = runs["layer"][name]
    for r, rank in enumerate(runs["ranks"]):
        got = rank["layer"][name]
        first, n = got["first"], got["grads"]["gate"].shape[0]
        _grad_close(got["grads"]["router"].numpy(), ref["grads"]["router"],
                    msg=f"rank {r} router")
        for bank in ("gate", "up", "down"):
            _grad_close(got["grads"][bank].numpy(), ref["grads"][bank][first:first + n],
                        msg=f"rank {r} {bank}")
        _grad_close(got["dx"].numpy(), ref["dx"][slice(*got["rows"])], msg=f"rank {r} dx")
    if name != "dp2":
        assert [rank["layer"][name]["first"] for rank in runs["ranks"]] == [0, 2, 0, 2] \
            if name == "ep2_dp2" else [0, 0, 2, 2]


def _state_params(state):
    return {k[len("params/"):]: v for k, v in state.items() if k.startswith("params/")}


@pytest.mark.parametrize("name", ["ep_dp", "ep_tp"])
def test_moe_finetune_step_matches_jax_mesh(runs, name):
    ref = runs["ref"][name]
    for r, rank in enumerate(runs["ranks"]):
        got = rank[name]
        for k in ("loss", "text_loss", "moe_lb_loss", "moe_z_loss", "moe_dropped_frac"):
            _close(got["step1"][k], runs["step1"][k], rtol=1e-5, atol=1e-7, msg=f"rank {r} {k}")
        for m_t, m_j in zip(got["metrics"], ref["metrics"]):
            for k in ("loss", "moe_lb_loss", "moe_z_loss", "moe_dropped_frac"):
                _close(m_t[k], m_j[k], rtol=1e-5, atol=1e-7, msg=f"rank {r} {k}")
        flat = jax_flat_arrays(_state_params(got["state"]))
        assert any("moe_gate" in p for p in flat)
        for path, a in flat.items():
            np.testing.assert_allclose(a, ref["params"][path], atol=5e-5, rtol=1e-4,
                                       err_msg=f"rank {r} {path}")
        assert got["bank_experts"] == 2
    assert runs["step1"]["moe_dropped_frac"] > 0


@pytest.mark.parametrize("name", ["ep_dp", "ep_tp"])
def test_moe_replicas_bit_equal_and_banks_split(runs, name):
    ranks = [rank[name] for rank in runs["ranks"]]
    for rank in ranks[1:]:
        assert torch.equal(rank["router"], ranks[0]["router"])
    # q_proj: whole at dp x ep, split over 'model' at ep x tp (equal within
    # each expert group: ranks 0 / 2 and 1 / 3 share a model coordinate)
    pairs = [(0, 1), (2, 3), (0, 2)] if name == "ep_dp" else [(0, 2), (1, 3)]
    for a, b in pairs:
        assert torch.equal(ranks[a]["q_proj"], ranks[b]["q_proj"]), (a, b)
    firsts = [rank["first"] for rank in ranks]
    assert firsts == ([0, 2, 0, 2] if name == "ep_dp" else [0, 0, 2, 2])
    if name == "ep_dp":
        # JAX's plan puts 'data' on the banks' moments: ZeRO over the data group
        assert ranks[0]["banks_sharded"]


def test_moe_generation_after_a_dp_step_routes_over_its_own_tokens(runs):
    afters = [rank["ep_dp"]["after"] for rank in runs["ranks"]]
    for r, got in enumerate(afters):
        assert got["ranks"]["tokens"] == got["whole"]["tokens"], r
        _close(got["ranks"]["logits"], got["whole"]["logits"], rtol=1e-5, atol=1e-6,
               msg=f"rank {r} prefill logits")
        for k in ("lb_loss", "z_loss", "dropped_frac"):
            _close(got["ranks"]["aux"][k], got["whole"]["aux"][k], rtol=1e-5, atol=1e-6,
                   msg=f"rank {r} {k}")
    # the data ranks' inputs differ (ranks 0 and 2), so a forward that still
    # routed over the data group would read the mean of both ranks' aux
    assert afters[0]["whole"]["aux"]["z_loss"] != afters[2]["whole"]["aux"]["z_loss"]
    assert afters[0]["ranks"]["tokens"] == afters[1]["ranks"]["tokens"]


def test_moe_offloaded_step_at_ep2_plans_the_banks_and_equals_the_plain_step(runs):
    layers = moe_vlm_configs()[1].decoder.num_layers
    for r, rank in enumerate(runs["ranks"]):
        got, plain = rank["ep_dp_offload"], rank["ep_dp"]
        assert got["optimizer"] == "OffloadedAdamW" and plain["optimizer"] == "AdamW"
        banks = sorted(f"{k}/decoder.blocks.{i}.{n}.kernel" for k in ("mu", "nu")
                       for i in range(layers) for n in ("moe_down", "moe_gate", "moe_up"))
        assert got["on_host"] == banks, (r, got["on_host"])
        assert got["step1"] == plain["step1"] and got["metrics"] == plain["metrics"], r
        assert sorted(got["state"]) == sorted(plain["state"])
        for k, v in plain["state"].items():
            assert torch.equal(got["state"][k], v), (r, k)
        assert any(k.startswith("opt/mu/") and ".moe_gate." in k for k in got["state"])
