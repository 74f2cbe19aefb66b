"""Data parallelism and ZeRO in the port (visper_lm_tpu_torch/parallel/,
train/) on two gloo ranks on the CPU, against the JAX package's step on a
make_mesh(dp=2) of the suite's virtual CPU devices at the same global batch.

One spawn of tests/_torch_dp_worker.py (two processes started from the
VISPER_* environment, a free port, their own timeout) runs every case; the
ranks write what they computed to files, and the tests below compare (after
a check of each collective on small tensors, exact):

  1. a dp=2 PT step of tiny_test_vlm(distill=True) at global batch 4, the
     distillation targets in the batch, the ranks' rows of unequal
     valid-token counts and a sample without an image: loss and metrics
     (rtol 1e-5), gradients (atol 1e-4 x the tensor's largest |grad| + rtol
     1e-3) and the trainables after 3 updates (atol 2e-5 / rtol 1e-4), the
     tolerances of test_torch_train_step.py. Each rank's own mean (of its
     NTP tokens, of its contrastive rows against its own targets) differs
     from its share of the global one, and that is asserted;
  2. zero_params and zero_frozen (ZeRO-3 of leaves >= 1024 elements)
     against the plain dp=2 run: not bit-equal, since a sharded leaf's share
     of the global norm is its slices' sums added in another order; within
     rtol 1e-6 / atol 1e-7 of it, and each rank keeps less;
  3. accumulation 2 x dp 2 against JAX's accum_steps=2 on the same global
     micro-batches (the tolerances of 1);
  4. ZeRO-3 with every moment in host blocks (OffloadedAdamW) bit-equal to
     the on-card moments at dp 2;
  5. the ZeRO state saved at dp 2 is the files of a one-device run: restored
     at dp 2 (in the ranks) and at dp 1 (here), bit-true;
  6. trainer.train under zero_frozen: a step hook sees every parameter
     whole (its forward equal to an unsharded copy's), as does what reads
     the returned model (forward, export); SIGTERM on one rank stops both
     at the same step, with one checkpoint;
  7. cli.main(["--smoke", ..., "--dp", "2", "--zero-params"]) under VISPER_*:
     one metrics.jsonl row a step and one checkpoint a step (the coordinator
     writes), and both ranks log the same loss.

These run in tier-1 while their JAX twins (tests/test_multihost.py) are
marked slow: the JAX ones compile XLA programs in each process, these spawn
two torch ranks of a tiny model (a few seconds each).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from visper_lm_tpu.data.collate import build_splice_plan, collate_plans
from visper_lm_tpu.models import vlm as jvlm
from visper_lm_tpu.parallel.mesh import make_mesh
from visper_lm_tpu.train import optimizer as jopt
from visper_lm_tpu.train import train_step as jts

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.data.image_io import write_png
from visper_lm_tpu_torch.train import losses as tloss
from visper_lm_tpu_torch.train import optimizer as topt
from visper_lm_tpu_torch.train import train_step as tts
from visper_lm_tpu_torch.train.checkpoint import CheckpointManager
from visper_lm_tpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_spawn as S  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(learning_rate=3e-3, total_steps=30, warmup_ratio=0.1, stage="pretrain")
STEPS = 3
SPAWN_TIMEOUT = 240


def _batch(cfg, seed):
    """A global PT batch of 4: rows 0-1 (rank 0) short, rows 2-3 (rank 1)
    long; row 1 without an image (its task masks 0); the targets in the batch."""
    rng = np.random.default_rng(seed)
    plans = []
    for b, n in enumerate((5, 9, 20, 27)):
        ids = [1, 2, 3] + [IMAGE_TOKEN_INDEX] + list(rng.integers(3, 400, size=n))
        labels = [IGNORE_INDEX] * 4 + ids[4:]
        plans.append(build_splice_plan(ids, labels, 64, num_image_tokens=cfg.num_image_tokens,
                                       num_task_tokens=2, num_tasks=3))
    batch = collate_plans(plans, images=rng.normal(size=(4, 28, 28, 3)).astype(np.float32))
    for t in cfg.distill.tasks:
        batch[f"{t.task}_target"] = rng.normal(
            size=(4, t.target_tokens, t.target_dim)).astype(np.float32)
        batch[f"{t.task}_mask"] = np.array([1, 0, 1, 1], np.float32)
    return batch


def _dataset(root):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    records = []
    for i in range(12):
        h, w = (int(x) for x in rng.integers(20, 70, size=2))
        write_png(os.path.join(root, f"{i}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        words = " ".join(f"w{int(x)}" for x in rng.integers(0, 99, size=4 + i))
        records.append({"image": f"{i}.png", "conversations": [
            {"from": "human", "value": f"<image>\nwhat is {i}"},
            {"from": "gpt", "value": words}]})
    with open(os.path.join(root, "data.json"), "w") as f:
        json.dump(records, f)


def _spawn(workdir, world=2):
    return S.spawn("_torch_dp_worker.py", [workdir], world, workdir, PYTHONHASHSEED="0",
                   OMP_NUM_THREADS="2")


def _wait(procs, workdir):
    """Every rank's exit code 0 within SPAWN_TIMEOUT; a hang or a failure
    fails the test (and kills the ranks: tests/_torch_spawn.py)."""
    S.wait(procs, workdir, SPAWN_TIMEOUT)


def _flat(tree):
    return {jopt._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_view(name, arr):
    return arr.T if topt.jax_path(name).endswith("/kernel") else arr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (spawned first, so they run while JAX compiles) and
    JAX's: step-1 loss, metrics and gradients at the global batch, the
    trainables after STEPS updates on make_mesh(dp=2), and with accum_steps=2."""
    workdir = tmp_path_factory.mktemp("dp")
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    params = jvlm.init_vlm(jax.random.PRNGKey(0), cfg_j)
    host = jax.tree_util.tree_map(np.asarray, params)
    torch.save(from_jax_params(host, cfg_t, device="cpu").state_dict(), workdir / "model.pt")
    batch, batch2 = _batch(cfg_j, 0), _batch(cfg_j, 1)
    accum = {k: np.stack([batch[k], batch2[k]]) for k in batch}
    np.savez(workdir / "batch.npz", **batch)
    np.savez(workdir / "accum.npz", **accum)
    _dataset(str(workdir / "data"))
    procs = _spawn(workdir)

    loss_fn = jts.make_loss_fn(cfg_j, use_pallas=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, jbatch)
    mesh = make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    ref = {}
    for name, accum_steps, data in (("plain", 1, batch), ("accum", 2, accum)):
        with mesh:
            step_j, state, _ = jts.make_train_step(cfg_j, jopt.OptimizerConfig(**OPT), params, mesh,
                                                   use_pallas=False, accum_steps=accum_steps)
            dbatch = jts.shard_batch(data, mesh, leading_accum=accum_steps > 1)
            metrics = []
            for _ in range(STEPS):
                state, m = step_j(state, dbatch)
                metrics.append({k: float(v) for k, v in m.items()})
        ref[name] = dict(params=_flat(state.params), metrics=metrics)
    _wait(procs, workdir)
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(ranks=ranks, workdir=workdir, batch=batch, cfg_t=cfg_t, host=host,
                loss_j=float(loss_j), met_j={k: float(v) for k, v in met_j.items()},
                grads_j=_flat(grads_j), ref=ref)


def _check_params(state, ref_params):
    names = [k[len("params/"):] for k in state if k.startswith("params/")]
    assert len(names) == 90
    for n in names:
        np.testing.assert_allclose(_port_view(n, state[f"params/{n}"].numpy()),
                                   ref_params[topt.jax_path(n)], atol=2e-5, rtol=1e-4, err_msg=n)


def test_collectives_give_what_they_must(runs):
    """all_gather and reduce_scatter along every dim in f32 and bf16 (bit for
    bit), the all-gather's gradient summed over the ranks, broadcast, reduce,
    through reduce_scatter_tensor and all_gather_into_tensor, which every
    backend runs."""
    for rank in runs["ranks"]:
        assert rank["collectives"] and all(rank["collectives"].values()), rank["collectives"]


def test_dp2_first_step_loss_metrics_and_grads_match_jax(runs):
    """The ranks' shares summed: JAX's loss and metrics on the global batch,
    and the summed gradients JAX's."""
    for rank in runs["ranks"]:
        met = rank["plain"]["met"]
        assert sorted(met) == sorted(runs["met_j"])
        for k, v in runs["met_j"].items():
            np.testing.assert_allclose(met[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(met["loss"], runs["loss_j"], rtol=1e-5)
        grads = rank["plain"]["grads"]
        assert len(grads) == 90
        for n, g in grads.items():
            ref = runs["grads_j"][topt.jax_path(n)]
            np.testing.assert_allclose(_port_view(n, g.numpy()), ref,
                                       atol=1e-4 * float(np.abs(ref).max()) + 1e-12, rtol=1e-3,
                                       err_msg=n)


def test_dp2_trainables_after_three_updates_match_jax(runs):
    """Every step's metrics (each rank logs the global ones) and the
    trainables after the third update: JAX's on make_mesh(dp=2)."""
    for rank in runs["ranks"]:
        for m_t, m_j in zip(rank["plain"]["metrics"], runs["ref"]["plain"]["metrics"]):
            for k in m_j:
                np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-5, atol=1e-7, err_msg=k)
        _check_params(rank["plain"]["state"], runs["ref"]["plain"]["params"])
    assert runs["ranks"][0]["plain"]["metrics"] == runs["ranks"][1]["plain"]["metrics"]


def test_a_rank_alone_would_compute_another_loss(runs):
    """The global reductions matter on this batch: each rank's own NTP mean
    (over its own valid tokens) and its own contrastive loss (its rows
    against its own targets) differ from its share of the global one."""
    cfg = runs["cfg_t"]
    batch = runs["batch"]
    g = torch.from_numpy(np.array(batch["labels"]))
    counts = [int(tloss.valid_count(g[r * 2:(r + 1) * 2])) for r in range(2)]
    assert counts[0] != counts[1]
    total = sum(counts)
    text = [rank["local_met"]["text_loss"] for rank in runs["ranks"]]
    # shares of the global mean add up to it; the ranks' own means do not
    np.testing.assert_allclose(sum(text), runs["met_j"]["text_loss"], rtol=1e-5)
    own = [text[r] * total / counts[r] for r in range(2)]
    assert abs(np.mean(own) - runs["met_j"]["text_loss"]) > 1e-3
    # contrastive: rows against the global batch's targets vs the rank's own
    tc = cfg.distill.tasks[0]
    rng = np.random.default_rng(3)
    preds = torch.from_numpy(rng.normal(size=(4, tc.target_tokens, tc.target_dim)).astype(np.float32))
    targets = torch.from_numpy(batch[f"{tc.task}_target"])
    scale = torch.tensor(np.log(1 / 0.07), dtype=torch.float32)
    full = tloss.contrastive_loss(preds, targets, scale)
    halves = torch.cat([tloss.contrastive_loss(preds[s], targets[s], scale)
                        for s in (slice(0, 2), slice(2, 4))])
    assert float((full - halves).abs().max()) > 1e-2


@pytest.mark.parametrize("mode", ["zero_params", "zero_frozen"])
def test_zero3_trains_as_plain_dp(mode, runs):
    """ZeRO-3 against the plain dp=2 run: the same metrics and trainables
    within rtol 1e-6 / atol 1e-7 (not bit-equal: a sharded leaf's norm is its
    slices' sums added in another order), so within JAX's tolerances too;
    each rank keeps a slice of every parameter the plan shards."""
    for rank in runs["ranks"]:
        got, plain = rank[mode], rank["plain"]
        for m_t, m_p in zip(got["metrics"], plain["metrics"]):
            for k in m_p:
                np.testing.assert_allclose(m_t[k], m_p[k], rtol=1e-6, atol=1e-7, err_msg=k)
        for k, v in plain["state"].items():
            if k.startswith("params/"):
                np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=1e-6,
                                           atol=1e-7, err_msg=k)
        _check_params(got["state"], runs["ref"]["plain"]["params"])
        assert got["sharded"] and got["shard_bytes"] > 0
    frozen = [n for n in runs["ranks"][0]["zero_frozen"]["sharded"]]
    assert any(n.startswith("decoder.blocks.") for n in frozen)
    assert "decoder.embed_tokens.weight" in frozen
    trained = runs["ranks"][0]["zero_params"]["sharded"]
    assert trained and all(not n.startswith("decoder.") for n in trained)


def test_zero3_where_a_parameters_slice_is_not_its_moments(runs):
    """Finetune stage (the decoder trains) with zero_params: q_proj's
    persistent slice is along its input dim, its moments' along its output
    dim (they take o_proj's spec, as JAX looks moments up by shape). It
    trains as plain dp within the JAX tolerances of test 1 (atol 2e-5 /
    rtol 1e-4): the sharded leaves' norm, summed in another order, moves the
    update of an element whose gradient is near 0 (3e-6 at most here)."""
    for rank in runs["ranks"]:
        got, plain = rank["ift_zero_params"], rank["ift_plain"]
        assert got["q_slices"] == (1, 0)
        trained = [k for k in plain["state"] if k.startswith("params/")]
        assert "params/decoder.blocks.0.q_proj.weight" in trained
        assert not any(k.startswith("params/vision_tower.") for k in trained)
        for m_t, m_p in zip(got["metrics"], plain["metrics"]):
            for k in m_p:
                np.testing.assert_allclose(m_t[k], m_p[k], rtol=1e-6, atol=1e-7, err_msg=k)
        for k, v in plain["state"].items():
            if k.startswith("params/"):
                np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=1e-4,
                                           atol=2e-5, err_msg=k)
        assert plain["metrics"][2]["loss"] != plain["metrics"][1]["loss"]


def test_accumulation_2_by_dp_2_matches_jax(runs):
    for rank in runs["ranks"]:
        for m_t, m_j in zip(rank["accum"]["metrics"], runs["ref"]["accum"]["metrics"]):
            for k in m_j:
                np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-5, atol=1e-7, err_msg=k)
        _check_params(rank["accum"]["state"], runs["ref"]["accum"]["params"])


def test_offloaded_moments_at_dp2_bit_equal_on_card(runs):
    for rank in runs["ranks"]:
        off, card = rank["offload"], rank["zero_params"]
        assert off["blocks"] > 0
        assert off["metrics"] == card["metrics"]
        assert sorted(off["state"]) == sorted(card["state"])
        for k, v in card["state"].items():
            assert torch.equal(off["state"][k], v), k


def test_checkpoint_saved_at_dp2_restores_at_dp2_and_dp1(runs):
    """The coordinator wrote the one-device files; the ranks restored them
    bit-true at dp 2, and a one-process step restores them bit-true here."""
    for rank in runs["ranks"]:
        assert rank["ckpt"] == dict(step=STEPS, equal=True)
    mgr = CheckpointManager(str(runs["workdir"] / "ckpt"))
    assert mgr.steps() == [STEPS]
    cfg = runs["cfg_t"]
    step = tts.make_train_step(cfg, topt.OptimizerConfig(**OPT),
                               from_jax_params(runs["host"], cfg, device="cpu"))
    mgr.restore(step)
    assert step.step == STEPS
    saved = runs["ranks"][0]["zero_params"]["state"]
    got = step.state_tensors()
    assert sorted(got) == sorted(saved)
    for k, v in saved.items():
        assert torch.equal(got[k].detach(), v), k


def test_zero3_model_is_whole_in_step_hooks_and_after_train(runs):
    """ZeRO-3 frees the sharded parameters' storage between uses; the
    trainer runs the hooks with every parameter whole, and hands back a
    whole model: the forward and the export equal an unsharded copy's."""
    for rank in runs["ranks"]:
        got = rank["hooked"]
        assert got["seen"], got
        for rec in got["seen"] + [got["after"]]:
            assert rec["sharded"] > 0 and rec["whole"] and rec["equal"], rec
        assert got["after"]["export_equal"]


def test_sigterm_on_one_rank_stops_every_rank_at_the_same_step(runs):
    """Rank 1 alone is signalled at step 1: the ranks agree on it after the
    step, so both save the same checkpoint and stop (a rank that stopped
    alone would hang the other in the next step's collectives)."""
    steps = [rank["hooked"]["step"] for rank in runs["ranks"]]
    assert steps == [1, 1]
    assert [[r["step"] for r in rank["hooked"]["seen"]] for rank in runs["ranks"]] == [[1], [1]]
    mgr = CheckpointManager(str(runs["workdir"] / "hooked" / "checkpoints"))
    assert mgr.steps() == [1]


def test_cli_under_visper_env_writes_once_and_ranks_agree(runs):
    out = runs["workdir"] / "cli"
    with open(out / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    assert sorted(os.listdir(out / "checkpoints")) == ["1", "2"]
    a, b = (rank["cli"] for rank in runs["ranks"])
    assert a["step"] == b["step"] == 2
    assert a["metrics"]["loss"] == b["metrics"]["loss"] == rows[-1]["loss"]
    assert np.isfinite(rows[-1]["loss"])
