"""Pipeline parallelism in the port (visper_lm_tpu_torch/parallel/pipeline.py,
the 'pipe' mesh axis, the decoder's stages, `from_jax_params(..., pp=)`,
the optimizer's norm over the stages, the step and its checkpoints) on four
gloo ranks on the CPU, against the JAX package on the same numpy inputs:
the cases of tests/test_pipeline_parallel.py, at its bounds.

One spawn of tests/_torch_sp_pp_worker.py (part "pp": four processes from
the VISPER_* environment, a free port, its own timeout) runs every
multi-rank case while JAX computes its references here:

  1. `pipeline_scan` on JAX's toy blocks at (dp, pp, m) in {(1, 4, 4),
     (2, 2, 2), (1, 4, 8)} (four ranks: m 8 over 4 stages stands in for
     JAX's (2, 4, 8) and (1, 8, 8)) against the plain scan (1e-4), with the
     point-to-point sends each stage made;
  2. the schedule in f64, exact to 1e-12 against the plain loop in numpy
     (a wrong microbatch, layer range or collected bubble is an O(1) error);
  3. the gradients of sum(sin(out)) to the blocks and to h at pp 4 against
     JAX's (1e-4): one copy of the loss, not the sum over the stages;
  4. pp = 1 falls through to the plain loop, and L % S raises;
  5. `Decoder.forward` at dp 1 x pp 4 with ragged kv_lengths against JAX's
     single-device logits (2e-4), the pipeline engaged (sends counted) and
     each stage holding its own block only; remat + save_gate at dp 2 x pp
     2: the gradient of mean(logits^2) to the embeddings (2e-4);
  6. the finetune step at pp 2 x tp 2 and at dp 2 x pp 2 with zero_params,
     and the PT step at dp 2 x pp 2 (taps: the foreign blocks gathered
     around the plain loop), against JAX's single-device step: metrics of 3
     updates (rtol 1e-5), the whole state after them (atol 2e-5 / rtol 1e-4);
  7. a checkpoint saved at dp 2 x pp 2 is one device's files: restored at
     dp 2 x pp 2 in the ranks and at pp 1 here, bit-true;
  8. the memory levers under pp (offload_opt_state, stream_grads): the
     finetune step at dp 2 x pp 2 with (on, 0), (off, 2), (on, 2), at pp 2
     x tp 2 and sp 2 x pp 2 with both, the PT step with both at dp 2 x pp 2
     and sp 2 x pp 2 (a tap and a stage bound end segments), each stage
     streaming its own segments, against JAX's single-device step as in 6;
     the offloaded state saved at dp 2 x pp 2 restores at pp 1 bit-true;
     the finetune and PT steps at sp 2 x pp 2 without the levers;
  9. the LoRA stage at dp 2 x pp 2, pp 2 x tp 2 and sp 2 x pp 2 (the
     factors through the pipeline, their gradients summed over the stages) and
     `trainer.train` of it at dp 2 x pp 2, against JAX's single-device
     LoRA step;
 10. the MoE VLM's finetune and PT steps (aux weight 1.0, routes dropped)
     at dp 2 x pp 2 and pp 2 x ep 2: JAX's plain loop (no send; each
     foreign block gathered before its forward and before its backward),
     against JAX's one-device steps as the sp file holds them; `init_vlm`
     of it at each stage holds the one-device model's numbers.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.models.decoder import decoder_forward

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.models.decoder import stage_chunk_ranges, stream_chunk_ranges
from visper_lm_tpu_torch.models.vlm import tap_layer_union
from visper_lm_tpu_torch.parallel import pipeline as P
from visper_lm_tpu_torch.train import optimizer as topt
from visper_lm_tpu_torch.train import train_step as tts
from visper_lm_tpu_torch.train.checkpoint import CheckpointManager
from visper_lm_tpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_sp_pp_common as C  # noqa: E402
from _torch_sp_pp_worker import OPT, PIPE, STEPS, lora_config, toy, toy_block  # noqa: E402

torch.set_num_threads(2)


def _jblock(blk, hh, scale):
    return hh + jnp.tanh(hh @ blk["w"] + blk["b"]) * scale


def _jscan(w, b, h, scale):
    def body(hh, blk):
        return _jblock(blk, hh, scale), None

    return jax.lax.scan(body, h, {"w": w, "b": b})[0]


def _refs(trees, batches):
    w, b, h, scale = (jnp.asarray(x) for x in toy(0))
    out = dict(scan=np.asarray(_jscan(w, b, h, scale)))
    w, b, h, scale = (jnp.asarray(x) for x in toy(2))
    gw, gh = jax.grad(lambda w_, h_: jnp.sum(jnp.sin(_jscan(w_, b, h_, scale))),
                      argnums=(0, 1))(w, h)
    out.update(grad_w=np.asarray(gw), grad_h=np.asarray(gh))
    dcfg = jconfig.tiny_test_vlm(distill=False).decoder
    rng = np.random.default_rng(5)
    e8 = jnp.asarray(rng.normal(size=(8, 32, 64)).astype(np.float32))
    lengths = jnp.asarray([32] * 7 + [20], jnp.int32)
    out["dec_pp4"] = np.asarray(jax.jit(lambda p, e: decoder_forward(
        p, dcfg, e, kv_lengths=lengths, use_pallas=False)["logits"])(trees["dec"], e8))
    out["dec_sp2_pp2"] = np.asarray(jax.jit(lambda p, e: decoder_forward(
        p, dcfg, e, kv_lengths=lengths[:4], use_pallas=False)["logits"])(trees["dec"], e8[:4]))
    e4 = jnp.asarray(np.random.default_rng(6).normal(size=(4, 32, 64)).astype(np.float32))

    def loss(e):
        lg = decoder_forward(trees["dec_remat"], dcfg, e, remat=True, remat_policy="save_gate",
                             use_pallas=False)["logits"]
        return jnp.mean(jnp.square(lg))

    out["dec_pp_remat"] = np.asarray(jax.jit(jax.grad(loss))(e4))
    out.update(C.step_refs(trees, batches, pt=True))
    out["moe"] = C.moe_step_refs(trees, batches)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ranks, ref, workdir = C.run(tmp_path_factory, "pp", _refs)
    return dict(ranks=ranks, ref=ref, workdir=workdir)


def _rows(records, key, n):
    """The data ranks' rows of `key` (each record's (b0, b1)), once each."""
    out = [None] * n
    for rec in records:
        b0, b1 = rec["rows"]
        part = np.asarray(rec[key])
        for i in range(b0, b1):
            assert out[i] is None or np.array_equal(out[i], part[i - b0])
            out[i] = part[i - b0]
    return np.stack(out)


@pytest.mark.parametrize("case", PIPE, ids=[f"dp{a}-pp{b}-m{c}" for a, b, c in PIPE])
def test_pipeline_matches_scan(runs, case):
    """Every stage returns the last stage's result: the plain scan's."""
    recs = [r["pipe"][case] for r in runs["ranks"]]
    got = _rows(recs, "out", 8)
    np.testing.assert_allclose(got, runs["ref"]["scan"], rtol=1e-4, atol=1e-4)
    dp, pp, m = case
    for r in recs:
        # one send a microbatch from every stage but the last
        assert r["p2p"] == (m if r["stage"] < pp - 1 else 0)


def test_schedule_exact_f64(runs):
    """f64: the pipeline is the plain loop to 1e-12; any off-by-one in the
    schedule would be an O(1) difference."""
    w, b, h, scale = toy(1, dtype=np.float64)
    ref = h
    for i in range(w.shape[0]):
        ref = ref + np.tanh(ref @ w[i] + b[i]) * scale
    for r in runs["ranks"]:
        got = r["pipe_f64"]["out"]
        assert got.dtype == torch.float64
        assert float(np.abs(got.numpy() - ref).max()) < 1e-12


def test_pipeline_gradients_match(runs):
    """The reversed schedule: each stage's blocks' gradients and h's (the
    same on every stage) are JAX's gradients of ONE copy of the loss."""
    recs = [r["pipe_grads"] for r in runs["ranks"]]
    seen = {}
    for r in recs:
        np.testing.assert_allclose(r["dh"].numpy(), runs["ref"]["grad_h"], rtol=1e-4, atol=1e-4)
        seen.update(r["dw"])
    assert sorted(seen) == list(range(8))
    for i, g in seen.items():
        np.testing.assert_allclose(g.numpy(), runs["ref"]["grad_w"][i], rtol=1e-4, atol=1e-4)


def test_pp1_falls_through_to_scan():
    """Without a process group (or a pipe axis of one) it is the plain loop."""
    w, b, h, scale = toy(3)
    blocks = [dict(w=torch.tensor(w[i]), b=torch.tensor(b[i])) for i in range(8)]
    got = P.pipeline_scan(toy_block, blocks, torch.tensor(h), dict(scale=torch.tensor(scale)),
                          group=None)
    ref = _jscan(*(jnp.asarray(x) for x in (w, b, h, scale)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    from visper_lm_tpu_torch.parallel.mesh import make_mesh

    assert P.pipe_parallel(make_mesh(dp=1, tp=1, world=1), 4) is None


def test_layer_divisibility_guard(runs):
    """6 layers over 4 stages raise ValueError on every rank (JAX's guard)."""
    for r in runs["ranks"]:
        assert r["layer_guard"] and "layers (6) % pipe stages (4)" in r["layer_guard"]


def test_decoder_forward_under_pipe_mesh_matches_single_device(runs):
    """dp 1 x pp 4, B 8, ragged kv_lengths: each stage holds its own block
    only, the pipeline ENGAGES (8 microbatches: stages 0-2 send 8
    activations each; numbers alone could hide a plain loop), and every
    stage returns JAX's single-device logits."""
    per_block = 9                      # two norms and seven linears
    for r in runs["ranks"]:
        rec = r["dec_pp4"]
        np.testing.assert_allclose(rec["logits"].numpy(), runs["ref"]["dec_pp4"], rtol=2e-4,
                                   atol=2e-4)
        assert rec["p2p"] == (8 if rec["stage"] < 3 else 0)
        # the embedding, the final norm, the lm head and the stage's one block
        assert rec["held"] == 3 + per_block


def test_decoder_forward_under_seq_and_pipe_axes_matches_single_device(runs):
    """sp 2 x pp 2: each stage's two seq ranks pipeline their rows (the ring
    or Ulysses inside each block, the activations sent between the stages):
    the rows put together are JAX's logits."""
    ref = runs["ref"]["dec_sp2_pp2"]
    got = np.full(ref.shape, np.nan, np.float32)
    for r in runs["ranks"]:
        rec = r["dec_sp2_pp2"]
        b0, b1, t0, t1 = rec["rows"]
        got[b0:b1, t0:t1] = rec["logits"].numpy()
        # 4 microbatches of 1 sent by stage 0 (Ulysses inside: no sends)
        assert rec["p2p"] == (4 if rec["stage"] == 0 else 0)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_decoder_pipeline_with_remat_matches(runs):
    """remat + save_gate inside the pipeline (dp 2 x pp 2): the gradient of
    mean(logits^2) to the embeddings, rows of both data ranks."""
    recs = [r["dec_pp_remat"] for r in runs["ranks"]]
    got = _rows(recs, "grad", 4)
    np.testing.assert_allclose(got, runs["ref"]["dec_pp_remat"], rtol=2e-4, atol=2e-4)
    assert all(r["p2p"] > 0 for r in recs)


@pytest.mark.parametrize("name", ["ft_pp2_tp2", "ft_dp2_pp2_zero"])
def test_finetune_step_at_pp2_matches_jax(runs, name):
    """The finetune stage trains every block, each on its stage: the
    pipelined step's metrics and the whole state after 3 updates equal
    JAX's single-device step's; each rank holds its own stage's blocks."""
    recs = [r[name] for r in runs["ranks"]]
    ref = runs["ref"]["ft"]
    for r in recs:
        C.check_metrics(r["metrics"], ref["metrics"])
        assert r["metrics"] == recs[0]["metrics"]
        # stage 0 sends activations forward, stage 1 gradients back
        assert all(s > 0 for s in r["p2p"])
    stages = sorted({tuple(r["held_blocks"]) for r in recs})
    assert stages == [(0, 1), (2, 3)]
    assert recs[0]["metrics"][2]["loss"] != recs[0]["metrics"][1]["loss"]
    state = recs[0]["state"]
    n = C.check_params(state, ref["params"])
    assert n > recs[0]["trainable"] and all(r["keys"] == recs[0]["keys"] for r in recs)
    if name == "ft_dp2_pp2_zero":
        assert all(r["shard_bytes"] > 0 for r in recs)


def test_from_jax_params_holds_the_stage_and_gathers_back(runs):
    """`from_jax_params(..., pp=)` copies the stage's own blocks only (the
    others have no storage); `whole_params` gathers every block from its
    owner: the one-process model's parameters, bit for bit."""
    # dp 2 x pp 2, 'pipe' inside 'data': ranks 0 and 2 are stage 0, ranks 1 and 3 stage 1
    assert [r["held_blocks"] for r in runs["ranks"]] == [[0, 1], [2, 3], [0, 1], [2, 3]]
    import pickle

    with open(runs["workdir"] / "ft.pkl", "rb") as f:
        tree = pickle.load(f)
    want = from_jax_params(tree, tconfig.tiny_test_vlm(distill=False), device="cpu")
    whole = runs["ranks"][0]["whole_params"]
    assert sorted(whole) == sorted(n for n, _ in want.named_parameters())
    for n, p in want.named_parameters():
        assert torch.equal(whole[n], p.detach()), n


def test_pt_step_at_pp2_matches_jax(runs):
    """PT taps the decoder: JAX does not pipeline it, and the port runs the
    plain loop with each foreign block gathered from its owner: JAX's
    single-device step, with no activation sent point to point."""
    recs = [r["pt_dp2_pp2"] for r in runs["ranks"]]
    ref = runs["ref"]["pt"]
    for r in recs:
        C.check_metrics(r["metrics"], ref["metrics"])
        assert r["p2p"] == [0] * STEPS
    assert recs[0]["metrics"][2]["loss"] != recs[0]["metrics"][1]["loss"]
    assert C.check_params(recs[0]["state"], ref["params"]) == recs[0]["trainable"]


def test_checkpoint_at_pp2_restores_at_pp1(runs):
    """The coordinator wrote one device's files, the stages gathered: the
    ranks restored them at dp 2 x pp 2, and one process restores them here
    at pp 1, bit-true."""
    for r in runs["ranks"]:
        assert r["restore_pp2"] == dict(step=STEPS, equal=True)
    mgr = CheckpointManager(str(runs["workdir"] / "ckpt"))
    assert mgr.steps() == [STEPS]
    import pickle

    with open(runs["workdir"] / "ft.pkl", "rb") as f:
        tree = pickle.load(f)
    cfg = tconfig.tiny_test_vlm(distill=False)
    step = tts.make_train_step(cfg, topt.OptimizerConfig(**OPT, stage="finetune"),
                               from_jax_params(tree, cfg, device="cpu"))
    mgr.restore(step)
    assert step.step == STEPS
    saved = runs["ranks"][0]["ft_dp2_pp2_zero"]["state"]
    got = step.state_tensors()
    assert sorted(got) == sorted(saved)
    for k, v in saved.items():
        assert torch.equal(got[k].detach(), v), k


def test_trainer_at_dp2_pp2_logs_once_and_ranks_agree(runs):
    """`trainer.train(TrainerConfig(dp=2, pp=2))`: every rank at step 2 with
    the same metrics, the step's own (the same batch as ft_dp2_pp2_zero's first
    two updates); only the coordinator wrote metrics.jsonl and the
    checkpoint."""
    import json

    recs = [r["trainer_dp2_pp2"] for r in runs["ranks"]]
    out = runs["workdir"] / "trainer_dp2_pp2"
    with open(out / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    assert sorted(os.listdir(out / "checkpoints")) == ["2"]
    want = runs["ranks"][0]["ft_dp2_pp2_zero"]["metrics"]
    for r in recs:
        assert r["step"] == 2 and r["metrics"] == recs[0]["metrics"]
    for row, m in zip(rows, want):
        np.testing.assert_allclose(row["loss"], m["loss"], rtol=1e-6)


# -- the memory levers, LoRA and sp x pp ---------------------------------------

FT_LEVERS = ["ft_dp2_pp2_o1s0", "ft_dp2_pp2_o0s2", "ft_dp2_pp2_o1s2", "ft_pp2_tp2_o1s2",
             "ft_sp2_pp2", "ft_sp2_pp2_o1s2"]


def _stage_segments(cfg, stream, stage):
    """The segments a stage of two streams: stream_chunk_ranges cut at the
    stage bounds (ROADMAP C31)."""
    pipe = P.PipeParallel(None, stage, 2, cfg.decoder.num_layers)
    return stage_chunk_ranges(stream_chunk_ranges(cfg.decoder.num_layers, stream,
                                                  tap_layer_union(cfg)), pipe)


def _check_step(runs, name, cfg, ref):
    """A step case's ranks against JAX's single-device step: the metrics of
    3 updates on every rank, the whole state after them; with streaming,
    each stage's own segments."""
    recs = [r[name] for r in runs["ranks"]]
    for r in recs:
        C.check_metrics(r["metrics"], ref["metrics"])
        assert r["metrics"] == recs[0]["metrics"]
        stage = 0 if r["held_blocks"] == [0, 1] else 1
        assert r["held_blocks"] == [[0, 1], [2, 3]][stage]
        levers = re.search(r"_o(\d)s(\d)$", name)
        offload, stream = (0, 0) if levers is None else map(int, levers.groups())
        assert r["segments"] == (_stage_segments(cfg, stream, stage) if stream else None)
        assert r["optimizer"] == ("OffloadedAdamW" if offload else "AdamW")
    assert recs[0]["metrics"][2]["loss"] != recs[0]["metrics"][1]["loss"]
    return recs, C.check_params(recs[0]["state"], ref["params"])


@pytest.mark.parametrize("name", FT_LEVERS)
def test_finetune_step_with_the_levers_under_pp_matches_jax(runs, name):
    """offload_opt_state and stream_grads under pp (and at sp 2 x pp 2, with
    and without them): each stage streams the segments of its own blocks,
    once the last microbatch's backward has passed them (a segment that
    left after the first would carry a quarter of its gradient), summed
    over the seq group under sp; the offloaded update takes the stages'
    norm. JAX's single-device finetune step."""
    cfg = tconfig.tiny_test_vlm(distill=False)
    recs, n = _check_step(runs, name, cfg, runs["ref"]["ft"])
    assert n > recs[0]["trainable"]
    if "sp2" in name or "tp2" in name:
        # dp 1: the pipeline's activations go forward, their gradients back
        assert all(all(x > 0 for x in r["p2p"]) for r in recs)


@pytest.mark.parametrize("name", ["pt_dp2_pp2_o1s2", "pt_sp2_pp2", "pt_sp2_pp2_o1s2"])
def test_pt_step_with_the_levers_under_pp_matches_jax(runs, name):
    """The PT step taps the decoder (the plain loop, the foreign blocks
    gathered): with both levers a tap boundary and a stage bound both end
    segments ((0, 2) on stage 0; (2, 3), (3, 4) on stage 1); at sp 2 x pp 2
    the heads read the taps gathered over the seq group. JAX's
    single-device PT step."""
    cfg = tconfig.tiny_test_vlm(distill=True)
    recs, n = _check_step(runs, name, cfg, runs["ref"]["pt"])
    assert n == recs[0]["trainable"]
    if name.endswith("o1s2"):
        assert sorted(r["segments"] for r in recs)[-1] == ((2, 3), (3, 4))
    assert all(r["p2p"] == [0] * STEPS for r in recs)


def test_offloaded_state_at_dp2_pp2_restores_at_pp1(runs):
    """The offloaded optimizer's checkpoint at dp 2 x pp 2 (both levers) is
    one device's files: an offloaded step at pp 1 restores it bit-true."""
    mgr = CheckpointManager(str(runs["workdir"] / "ckpt_levers"))
    assert mgr.steps() == [STEPS]
    import pickle

    with open(runs["workdir"] / "ft.pkl", "rb") as f:
        tree = pickle.load(f)
    cfg = tconfig.tiny_test_vlm(distill=False)
    step = tts.make_train_step(cfg, topt.OptimizerConfig(**OPT, stage="finetune"),
                               from_jax_params(tree, cfg, device="cpu"), offload_opt_state=True)
    mgr.restore(step)
    assert step.step == STEPS
    saved = runs["ranks"][0]["ft_dp2_pp2_o1s2"]["state"]
    got = step.state_tensors()
    assert sorted(got) == sorted(saved) and any(k.startswith("opt/mu/") for k in saved)
    for k, v in saved.items():
        assert torch.equal(got[k].detach(), v), k


@pytest.mark.parametrize("name", ["lora_dp2_pp2", "lora_pp2_tp2", "lora_sp2_pp2"])
def test_lora_stage_under_pp_matches_jax(runs, name):
    """The LoRA side path through the pipeline: the stacked factors enter
    every stage whole, each stage's microbatches give its layers' rows
    their gradient, and the stages' shares are summed, so every rank holds
    the whole factors' gradient and update: JAX's single-device LoRA step
    (a B that is not zero, so A's gradient is live from the first step)."""
    recs = [r[name] for r in runs["ranks"]]
    ref = runs["ref"]["lora"]
    for r in recs:
        C.check_metrics(r["metrics"], ref["metrics"])
        assert r["metrics"] == recs[0]["metrics"]
        assert all(x > 0 for x in r["p2p"])
    assert recs[0]["metrics"][2]["loss"] != recs[0]["metrics"][1]["loss"]
    state = recs[0]["state"]
    assert C.check_params(state, ref["params"]) == recs[0]["trainable"]
    targets = lora_config(tconfig).lora.targets
    assert sum(k.startswith("params/lora.") for k in state) == 2 * len(targets)


def test_trainer_lora_at_dp2_pp2_matches_the_step(runs):
    """`trainer.train` of the LoRA stage at dp 2 x pp 2: 2 steps, the
    step's own metrics (lora_dp2_pp2's first two updates) on every rank."""
    recs = [r["trainer_lora_dp2_pp2"] for r in runs["ranks"]]
    want = runs["ranks"][0]["lora_dp2_pp2"]["metrics"][1]
    for r in recs:
        assert r["step"] == 2 and r["metrics"] == recs[0]["metrics"]
        np.testing.assert_allclose(r["metrics"]["loss"], want["loss"], rtol=1e-6)


@pytest.mark.parametrize("name", ["moe_ft_dp2_pp2", "moe_pt_dp2_pp2", "moe_ft_pp2_ep2",
                                  "moe_pt_pp2_ep2"])
def test_moe_steps_under_pp_take_the_plain_loop_and_match_jax(runs, name):
    """A MoE stack is not pipelined (JAX's `_maybe_pipelined_stack`): no
    point-to-point send, each foreign block gathered twice a step (forward
    and backward), every pipe rank computing the whole loss with the aux
    once; JAX's one-device steps' metrics, state and step-1 gradients."""
    kind = name.split("_")[1]
    recs = [r[name] for r in runs["ranks"]]
    for r, rec in enumerate(recs):
        assert rec["p2p"] == [0] * STEPS, (r, rec["p2p"])
        assert len(rec["foreign"]) == 2 and rec["gathers"] == [2 * 2] * STEPS, (r, rec["gathers"])
    C.check_moe_step(recs, runs["ref"]["moe"][kind], kind)


@pytest.mark.parametrize("name", ["dp2_pp2", "pp2_ep2"])
def test_moe_init_under_pp_holds_the_one_device_numbers(runs, name):
    """`init_vlm(..., pp=)` of a MoE VLM: every parameter a stage holds is
    the one-device model's from the same seed, the second stage's banks
    included (the first stage's banks, foreign there, drawn and dropped)."""
    recs = [r["moe_init"][name] for r in runs["ranks"]]
    for r, rec in enumerate(recs):
        assert rec["equal"] and rec["held"] > 0, (r, rec)
    stages = sorted({tuple(rec["banks"]) for rec in recs})
    assert len(stages) == 2 and all(len(b) == 2 for b in stages), stages
