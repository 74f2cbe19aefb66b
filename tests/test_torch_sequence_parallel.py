"""Sequence parallelism in the port (visper_lm_tpu_torch/parallel/sequence.py,
the 'seq' mesh axis, the attention route and the decoder's rows, the
losses' row targets, and the step at dp 2 x sp 2) on four gloo ranks on the
CPU, against the JAX package's functions on the same numpy inputs: the
cases of tests/test_sequence_parallel.py, at its bounds.

One spawn of tests/_torch_sp_pp_worker.py (part "sp": four processes from
the VISPER_* environment, a free port, its own timeout) runs every
multi-rank case while JAX computes its references here; the ranks write
their rows to files, and the tests put the rows together:

  1. `ulysses_attention` at (dp, sp, nkv) in {(2, 2, 4), (1, 4, 4), (2, 2, 2)}
     with ragged kv_lengths / kv_starts: the output and dq, dk, dv of
     sum(sin(out)) against `mha_xla` and its gradients (2e-5);
  2. `ring_attention` at JAX's (dp, sp, nq, nkv) cases (sp 4 stands in for
     its sp 8 with 2 q heads: sp beyond the head count), values and
     gradients (2e-5);
  3. the sp = 1 fall-through, the head and row guards, and the calls the
     route cannot take (a cache, an offset), which raise;
  4. `multi_head_attention` under sp 4 with 2 kv heads goes through the
     ring (point-to-point sends, no all-to-all) and matches;
  5. `Decoder.forward` on each rank's rows at sp 4 (the ring) and at dp 2
     x sp 2 (Ulysses) against JAX's single-device `decoder_forward` (5e-5);
  6. the finetune and PT steps at dp 2 x sp 2 against JAX's single-device
     step: the metrics of 3 updates (rtol 1e-5) and the trainables after
     them (atol 2e-5 / rtol 1e-4); in PT the heads read the taps gathered
     over the group;
  7. the finetune step at dp 2 x sp 2 with the memory levers
     (offload_opt_state, stream_grads) at (on, 0), (off, 2) and (on, 2),
     and the LoRA stage at dp 2 x sp 2, against JAX's single-device steps
     as in 6;
  8. the MoE layer at dp 2 x sp 2 and sp 2 x ep 2 over the data x seq
     routing group, capacity binding: the ranks' output rows, the aux
     (dropped share exactly) and the gradients against JAX's one-device
     call on the global input (2e-5); the controls: a priority taken rank
     by rank (JAX's call on the tokens in rank-major order) gives other
     outputs, and the router's gradient with the aux counted twice misses
     the bound;
  9. the MoE VLM's finetune and PT steps (aux weight 1.0, routes dropped)
     at dp 2 x sp 2 and sp 2 x ep 2 against JAX's one-device steps: metrics
     of 3 updates (rtol 1e-5), the state after them (atol 1e-4 / rtol
     1e-4), the finetune step's step-1 gradients of the router and the
     banks (the router's beyond the bound of the aux counted twice).

JAX's file is marked slow (it compiles shard_maps on 8 virtual devices);
this one spawns four torch ranks of tiny shapes.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.models.decoder import decoder_forward
from visper_lm_tpu.ops.attention import mha_xla
from visper_lm_tpu.parallel.mesh import make_mesh as jmake_mesh

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.constants import IGNORE_INDEX
from visper_lm_tpu_torch.models.decoder import Decoder, init_kv_cache
from visper_lm_tpu_torch.ops.attention import multi_head_attention
from visper_lm_tpu_torch.parallel import sequence as S
from visper_lm_tpu_torch.parallel.mesh import make_mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_sp_pp_common as C  # noqa: E402
from _torch_sp_pp_worker import LEVERS, MOE_LAYERS, RING, ULYSSES, attn_inputs, lever  # noqa: E402

torch.set_num_threads(2)


def _attention_refs(dp, nq, nkv, seed):
    """mha_xla's output and the gradients of sum(sin(out)) on one case."""
    q, k, v, lengths, starts = (jnp.asarray(x) for x in attn_inputs(seed, 2 * dp, nq, nkv))

    def f(q, k, v):
        return mha_xla(q, k, v, causal=True, kv_lengths=lengths, kv_starts=starts)

    out = f(q, k, v)
    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))), argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _refs(trees, batches):
    out = dict(ulysses={c: _attention_refs(c[0], 4, c[2], 0) for c in ULYSSES},
               ring={c: _attention_refs(c[0], c[2], c[3], 10) for c in RING},
               route=_attention_refs(1, 4, 2, 12))
    dcfg = jconfig.tiny_test_vlm(distill=False).decoder
    rng = np.random.default_rng(4)
    e = rng.normal(size=(2, 32, 64)).astype(np.float32)
    e22 = np.concatenate([e, rng.normal(size=(2, 32, 64)).astype(np.float32)])
    fwd = jax.jit(lambda p, x: decoder_forward(p, dcfg, x, use_pallas=False)["logits"])
    out["dec_sp4"] = np.asarray(fwd(trees["dec"], jnp.asarray(e)))
    out["dec_dp2_sp2"] = np.asarray(fwd(trees["dec"], jnp.asarray(e22)))
    out.update(C.step_refs(trees, batches, pt=True))
    inp = C.moe_layer_inputs()
    out["moe_layer"] = {name: C.moe_layer_refs(inp, dp, sp) for name, dp, sp, _ in MOE_LAYERS}
    out["moe"] = C.moe_step_refs(trees, batches)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ranks, ref, workdir = C.run(tmp_path_factory, "sp", _refs)
    return dict(ranks=ranks, ref=ref, workdir=workdir)


def _assemble(records, key, shape):
    """The ranks' rows of `key` (by their (b0, b1, t0, t1)) in one array."""
    out = np.full(shape, np.nan, np.float32)
    for rec in records:
        b0, b1, t0, t1 = rec["rows"]
        out[b0:b1, t0:t1] = np.asarray(rec[key] if not isinstance(key, tuple)
                                       else rec[key[0]][key[1]])
    assert not np.isnan(out).any()
    return out


def _case(runs, name, c=None):
    return [r[name] if c is None else r[name][c] for r in runs["ranks"]]


@pytest.mark.parametrize("case", ULYSSES, ids=[f"dp{a}-sp{b}-nkv{c}" for a, b, c in ULYSSES])
def test_ulysses_matches_single_device(runs, case):
    ref, _ = runs["ref"]["ulysses"][case]
    got = _assemble(_case(runs, "ulysses", case), "out", ref.shape)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    # q, k, v and the output, then their inverses in the backward
    assert all(r["all_to_all"] == 8 and r["p2p"] == 0 for r in _case(runs, "ulysses", case))


@pytest.mark.parametrize("case", ULYSSES, ids=[f"dp{a}-sp{b}-nkv{c}" for a, b, c in ULYSSES])
def test_ulysses_gradients_match(runs, case):
    """dq, dk, dv through both exchanges (the backward runs the inverse
    all-to-all) against JAX's gradients of the same loss."""
    _, grads = runs["ref"]["ulysses"][case]
    for i, g in enumerate(grads):
        got = _assemble(_case(runs, "ulysses", case), ("grads", i), g.shape)
        np.testing.assert_allclose(got, g, rtol=2e-5, atol=2e-5)


def test_sp1_mesh_falls_through():
    """sp == 1 (no group, or a group of one) is plain attention."""
    q, k, v, lengths, starts = attn_inputs(2, 2, 4, 4)
    ref = np.asarray(mha_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    assert make_mesh(dp=1, tp=1, world=1).seq_size == 1
    assert S.sequence_parallel(make_mesh(dp=1, tp=1, world=1)) is None
    for seq in (None, S.SequenceParallel(None, 0, 1)):
        for fn in (S.ulysses_attention, S.ring_attention):
            got = fn(torch.tensor(q), torch.tensor(k), torch.tensor(v), seq=seq, causal=True)
            np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_head_divisibility_guard():
    """Ulysses needs both head counts to divide sp (JAX's ValueError); a
    sequence that does not divide sp raises where it is cut into rows."""
    q, k, v, _, _ = attn_inputs(3, 2, 4, 2)
    seq = S.SequenceParallel(None, 0, 4)
    with pytest.raises(ValueError, match="must divide the 'seq' axis"):
        S.ulysses_attention(torch.tensor(q)[:, :8], torch.tensor(k)[:, :8],
                            torch.tensor(v)[:, :8], seq=seq)
    with pytest.raises(ValueError, match=r"T \(30\) % sp \(4\)"):
        seq.rows(30)


def test_calls_the_route_cannot_take_raise():
    """Under sp > 1 the route takes self-attention at an int offset 0 only:
    an offset or a cache raises rather than attend over the rank's rows."""
    q, k, v, _, _ = attn_inputs(3, 2, 4, 4)
    seq = S.SequenceParallel(None, 0, 2)
    t = [torch.tensor(x)[:, :16] for x in (q, k, v)]
    with pytest.raises(ValueError, match="self-attention at offset 0 only"):
        multi_head_attention(*t, q_offset=3, seq=seq)
    with pytest.raises(ValueError, match="self-attention at offset 0 only"):
        multi_head_attention(*t, q_offset=torch.tensor(0), seq=seq)
    cfg = tconfig.tiny_test_vlm(distill=False).decoder
    dec = Decoder(cfg)
    dec.seq = seq
    with pytest.raises(ValueError, match="a cache under sequence parallelism"):
        dec(torch.zeros(1, 4, cfg.hidden_size), cache=init_kv_cache(cfg, 1, 8, device="cpu"))


@pytest.mark.parametrize("case", RING, ids=[f"dp{a}-sp{b}-nq{c}-nkv{d}" for a, b, c, d in RING])
def test_ring_matches_single_device(runs, case):
    ref, _ = runs["ref"]["ring"][case]
    got = _assemble(_case(runs, "ring", case), "out", ref.shape)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    # sp - 1 hops forward, as many back in the backward
    assert all(r["all_to_all"] == 0 and r["p2p"] == 2 * (case[1] - 1)
               for r in _case(runs, "ring", case))


@pytest.mark.parametrize("case", RING, ids=[f"dp{a}-sp{b}-nq{c}-nkv{d}" for a, b, c, d in RING])
def test_ring_gradients_match(runs, case):
    """Through the unrolled ring, each shift's backward the reverse shift."""
    _, grads = runs["ref"]["ring"][case]
    for i, g in enumerate(grads):
        got = _assemble(_case(runs, "ring", case), ("grads", i), g.shape)
        np.testing.assert_allclose(got, g, rtol=2e-5, atol=2e-5)


def test_dispatch_routes_gqa_to_ring(runs):
    """multi_head_attention under sp 4 with 2 kv heads must stay sequence
    parallel, through the ring (point-to-point sends, no all-to-all)."""
    ref, grads = runs["ref"]["route"]
    recs = _case(runs, "route")
    np.testing.assert_allclose(_assemble(recs, "out", ref.shape), ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_assemble(recs, ("grads", 0), grads[0].shape), grads[0],
                               rtol=2e-5, atol=2e-5)
    assert all(r["all_to_all"] == 0 and r["p2p"] == 6 for r in recs)


@pytest.mark.parametrize("name", ["dec_sp4", "dec_dp2_sp2"])
def test_decoder_forward_under_sp_mesh_matches_single_device(runs, name):
    """Each rank runs the stack on its rows (global rope positions): the
    logits put together are JAX's single-device logits. sp 4 with the tiny
    config's 2 kv heads takes the ring, dp 2 x sp 2 Ulysses."""
    ref = runs["ref"][name]
    recs = _case(runs, name)
    got = _assemble(recs, "logits", ref.shape)
    np.testing.assert_allclose(got, ref, rtol=5e-5, atol=5e-5)
    layers = tconfig.tiny_test_vlm(distill=False).decoder.num_layers
    if name == "dec_sp4":
        assert all(r["all_to_all"] == 0 and r["p2p"] == 3 * layers for r in recs)
    else:
        assert all(r["all_to_all"] == 4 * layers and r["p2p"] == 0 for r in recs)


def test_finetune_step_at_dp2_sp2_matches_jax(runs):
    """Every trainable replicated over 'seq', each rank's loss its rows'
    share, the gradients summed over the seq group: JAX's single-device
    step's metrics and trainables after 3 updates."""
    recs = _case(runs, "ft_dp2_sp2")
    ref = runs["ref"]["ft"]
    for r in recs:
        C.check_metrics(r["metrics"], ref["metrics"])
        assert r["metrics"] == recs[0]["metrics"]
    assert recs[0]["metrics"][2]["loss"] != recs[0]["metrics"][1]["loss"]
    assert C.check_params(recs[0]["state"], ref["params"]) == recs[0]["trainable"] > 0


@pytest.mark.parametrize("name", [f"ft_dp2_sp2_{lever(*c)}" for c in LEVERS])
def test_finetune_step_with_the_levers_at_dp2_sp2_matches_jax(runs, name):
    """offload_opt_state and stream_grads under sp: a streamed segment is
    summed over the seq group before the data group's reduce-scatter (one
    rank's rows would be half the gradient), the offloaded update's norm
    takes the seq-summed gradients. JAX's single-device finetune step."""
    recs = _case(runs, name)
    ref = runs["ref"]["ft"]
    stream = int(name[-1])
    for r in recs:
        C.check_metrics(r["metrics"], ref["metrics"])
        assert r["metrics"] == recs[0]["metrics"]
        assert r["segments"] == (((0, 2), (2, 4)) if stream else None)
        assert r["optimizer"] == ("OffloadedAdamW" if "_o1" in name else "AdamW")
    assert recs[0]["metrics"][2]["loss"] != recs[0]["metrics"][1]["loss"]
    assert C.check_params(recs[0]["state"], ref["params"]) == recs[0]["trainable"] > 0


def test_lora_stage_at_dp2_sp2_matches_jax(runs):
    """The LoRA stage under sp: each rank's rows take the side path, the
    factors' gradients are summed over the seq group. JAX's single-device
    LoRA step."""
    recs = _case(runs, "lora_dp2_sp2")
    ref = runs["ref"]["lora"]
    for r in recs:
        C.check_metrics(r["metrics"], ref["metrics"])
        assert r["metrics"] == recs[0]["metrics"]
    assert recs[0]["metrics"][2]["loss"] != recs[0]["metrics"][1]["loss"]
    state = recs[0]["state"]
    assert C.check_params(state, ref["params"]) == recs[0]["trainable"]
    assert any(k.startswith("params/lora.") for k in state)


def test_pt_step_at_dp2_sp2_matches_jax(runs):
    """The PT step: the heads read the taps gathered over the seq group, and
    every rank takes 1/sp of their loss."""
    recs = _case(runs, "pt_dp2_sp2")
    ref = runs["ref"]["pt"]
    for r in recs:
        C.check_metrics(r["metrics"], ref["metrics"])
    assert recs[0]["metrics"][2]["loss"] != recs[0]["metrics"][1]["loss"]
    assert C.check_params(recs[0]["state"], ref["params"]) == recs[0]["trainable"] > 0


def test_mesh_axes_follow_jax():
    """make_mesh(sp=, pp=) builds JAX's axis order ('data', 'pipe', 'seq',
    'model') over the first dp·pp·sp·tp ranks; the groups are its lines;
    ep > 1 adds JAX's 'expert' axis between 'pipe' and 'seq'."""
    jm = jmake_mesh(dp=1, pp=2, sp=2, tp=2, devices=jax.devices()[:8])
    tm = make_mesh(dp=1, pp=2, sp=2, tp=2, world=8)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.ranks.shape == jm.devices.shape
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert np.array_equal(tm.ranks, ids - ids.min())
    assert tm.seq_group_ranks(0) == (0, 2) and tm.pipe_group_ranks(0) == (0, 4)
    assert tm.model_group_ranks(5) == (4, 5) and tm.data_group_ranks(3) == (3,)
    assert make_mesh(sp=2, world=4).shape == {"data": 2, "seq": 2, "model": 1}
    em = make_mesh(ep=2, world=4)
    assert em.axis_names == tuple(jmake_mesh(ep=2, devices=jax.devices()[:4]).axis_names)
    assert em.shape == {"data": 2, "expert": 2, "model": 1}


def test_row_targets_cross_the_rank_boundary():
    """A rank's last row's target is the next rank's first label; the last
    rank's last row has none: the rows' targets put together are the whole
    sequence's shifted labels."""
    from visper_lm_tpu_torch.train.losses import row_targets

    labels = torch.arange(24).reshape(2, 12)
    parts = [row_targets(labels, S.SequenceParallel(None, r, 3)) for r in range(3)]
    whole = torch.cat(parts, 1)
    assert torch.equal(whole[:, :-1], labels[:, 1:]) and (whole[:, -1] == IGNORE_INDEX).all()
    assert torch.equal(parts[0][:, -1], labels[:, 4])


def test_trainer_at_dp2_sp2_logs_once_and_ranks_agree(runs):
    """`trainer.train(TrainerConfig(dp=2, sp=2))`: every rank at step 2 with
    the same metrics, the step's own (the same batch as ft_dp2_sp2's first
    two updates); only the coordinator wrote metrics.jsonl and the
    checkpoint."""
    import json

    recs = [r["trainer_dp2_sp2"] for r in runs["ranks"]]
    out = runs["workdir"] / "trainer_dp2_sp2"
    with open(out / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    assert sorted(os.listdir(out / "checkpoints")) == ["2"]
    want = runs["ranks"][0]["ft_dp2_sp2"]["metrics"]
    for r in recs:
        assert r["step"] == 2 and r["metrics"] == recs[0]["metrics"]
    for row, m in zip(rows, want):
        np.testing.assert_allclose(row["loss"], m["loss"], rtol=1e-6)


@pytest.mark.parametrize("name", [c[0] for c in MOE_LAYERS])
def test_moe_layer_under_sp_routes_over_the_global_batch(runs, name):
    """Each rank's rows of the output and the aux equal JAX's one-device
    call: capacity from the global N, priority in JAX's token-major order
    across the seq ranks' slices of every row. The capacity binds, and a
    priority taken rank by rank would give other outputs (the control)."""
    ref = runs["ref"]["moe_layer"][name]
    recs = [r["moe_layer"][name] for r in runs["ranks"]]
    got = _assemble(recs, "out", ref["out"].shape)
    np.testing.assert_allclose(got, ref["out"], rtol=2e-5, atol=2e-6)
    for r, rec in enumerate(recs):
        assert rec["aux"]["dropped_frac"] == ref["aux"]["dropped_frac"], r
        for k in ("lb_loss", "z_loss"):
            np.testing.assert_allclose(rec["aux"][k], ref["aux"][k], rtol=2e-5, atol=2e-6,
                                       err_msg=f"rank {r} {k}")
        assert rec["group"] == (4 if name == "dp2_sp2" else 2, 2)
    assert ref["aux"]["dropped_frac"] > 0.05
    assert np.abs(ref["rank_major_out"] - ref["out"]).max() > 1e-2


@pytest.mark.parametrize("name", [c[0] for c in MOE_LAYERS])
def test_moe_layer_under_sp_gradients_are_the_one_device_gradients(runs, name):
    """The router's gradient summed over the routing group is JAX's on every
    rank (the aux entering each rank's loss as 1/(dp sp) of it), each rank's
    bank slices the one-device gradient's, dx the rank's rows of JAX's; the
    router's gradient with the aux counted twice is not within the bound."""
    ref = runs["ref"]["moe_layer"][name]
    recs = [r["moe_layer"][name] for r in runs["ranks"]]
    for r, rec in enumerate(recs):
        first, n = rec["first"], rec["grads"]["gate"].shape[0]
        C.grad_close(rec["grads"]["router"].numpy(), ref["grads"]["router"], msg=f"rank {r}")
        for bank in ("gate", "up", "down"):
            C.grad_close(rec["grads"][bank].numpy(), ref["grads"][bank][first:first + n],
                         msg=f"rank {r} {bank}")
    C.grad_close(_assemble(recs, "dx", ref["dx"].shape), ref["dx"], msg="dx")
    twice = ref["router_aux_twice"]
    assert not np.allclose(recs[0]["grads"]["router"].numpy(), twice, rtol=2e-5,
                           atol=1e-5 * float(np.abs(twice).max()))
    if name == "sp2_ep2":
        assert [rec["first"] for rec in recs] == [0, 0, 2, 2]


@pytest.mark.parametrize("name", ["moe_ft_dp2_sp2", "moe_pt_dp2_sp2", "moe_ft_sp2_ep2",
                                  "moe_pt_sp2_ep2"])
def test_moe_steps_under_sp_match_jax(runs, name):
    """The MoE VLM's finetune and PT steps under sp (each rank's decoder
    routing over the data x seq group) against JAX's one-device steps."""
    kind = name.split("_")[1]
    C.check_moe_step(_case(runs, name), runs["ref"]["moe"][kind], kind)
