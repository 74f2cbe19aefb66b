"""The port's training loop and what it rests on, on the CPU, f32:
`train/trainer.py` (micro-batch grouping, resume with the data-order-correct
fast-forward, SIGTERM), `train/checkpoint.py`, the parameter-tree functions
of `utils/param.py` (npz files read and written both ways with the JAX
package), the config JSON (the JAX package's text), and `utils/diagnostics.py`
(FLOP counts equal to the JAX package's).

Tolerances: a restored state's next step and a resumed run's trainables are
bit-equal to the uninterrupted run's (the same ops on the same data); npz
contents are bit-equal; the FLOP counts rtol 1e-12.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from visper_lm_tpu.data.collate import build_splice_plan
from visper_lm_tpu.models import vlm as jvlm
from visper_lm_tpu.train import checkpoint as jckpt
from visper_lm_tpu.utils import diagnostics as jdiag
from visper_lm_tpu.utils import param as jparam

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.data.collate import collate_plans
from visper_lm_tpu_torch.models import decoder as tdec
from visper_lm_tpu_torch.train import checkpoint as tckpt
from visper_lm_tpu_torch.train import optimizer as topt
from visper_lm_tpu_torch.train import train_step as tts
from visper_lm_tpu_torch.train import trainer as ttrain
from visper_lm_tpu_torch.utils import diagnostics as tdiag
from visper_lm_tpu_torch.utils import param as tparam
from visper_lm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

OPT = dict(learning_rate=1e-3, total_steps=10, warmup_ratio=0.0, stage="pretrain")


@pytest.fixture(scope="module")
def jax_params():
    return jvlm.init_vlm(jax.random.PRNGKey(0), jconfig.tiny_test_vlm(distill=True))


@pytest.fixture(scope="module")
def host_params(jax_params):
    return jax.tree_util.tree_map(np.asarray, jax_params)


def _model(host_params):
    return from_jax_params(host_params, tconfig.tiny_test_vlm(distill=True), device="cpu")


def _batches(n, seed, bsz=2, seq=48):
    """n host batches with their own images and targets, so that the data
    order shows in the trained parameters."""
    cfg = tconfig.tiny_test_vlm(distill=True)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plans = []
        for b in range(bsz):
            ids = [1, 2, IMAGE_TOKEN_INDEX] + list(rng.integers(3, 400, size=6 + b))
            plans.append(build_splice_plan(
                ids, [IGNORE_INDEX] * 3 + ids[3:], seq, num_image_tokens=cfg.num_image_tokens,
                num_task_tokens=cfg.distill.num_task_tokens, num_tasks=3,
            ))
        img = rng.normal(size=(bsz, 28, 28, 3)).astype(np.float32)
        batch = collate_plans(plans, images=img)
        for t in cfg.distill.tasks:
            batch[f"{t.task}_mask"] = np.ones((bsz,), np.float32)
            batch[f"{t.task}_target"] = rng.normal(
                size=(bsz, t.target_tokens, t.target_dim)).astype(np.float32)
        out.append(batch)
    return out


def _trainer(tmp_path, name, **kw):
    kw = dict(dict(save_steps=100, num_epochs=1, device="cpu"), **kw)
    return ttrain.TrainerConfig(output_dir=str(tmp_path / name), **kw)


def _train(host_params, tcfg, data_iter, **kw):
    cfg = tconfig.tiny_test_vlm(distill=True)
    return ttrain.train(cfg, topt.OptimizerConfig(**OPT), tcfg, _model(host_params), data_iter, **kw)


def _trainables(state):
    return {n: p.detach().clone() for n, p in state.trainable.items()}


def _records(tmp_path, name):
    with open(tmp_path / name / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# parameter trees, npz files and the config JSON
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_npz_round_trip_with_jax_both_ways(jax_params, tmp_path, dtype):
    """The JAX package's save_params_npz -> the port's load_params_npz ->
    a model -> the port's save_params_npz -> the JAX package's
    load_params_npz: the same tree, every leaf's bytes equal (bf16 kept as
    raw 2-byte values)."""
    params = jparam.tree_cast(jax_params, dtype)
    jparam.save_params_npz(str(tmp_path / "jax.npz"), params)
    tree = tparam.load_params_npz(str(tmp_path / "jax.npz"))
    model = from_jax_params(tree, tconfig.tiny_test_vlm(distill=True), device="cpu")
    assert model.decoder.blocks[0].q_proj.weight.dtype == getattr(torch, dtype)
    tparam.save_params_npz(str(tmp_path / "port.npz"), model)
    back = jparam.load_params_npz(str(tmp_path / "port.npz"))
    ref = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (k, a), (_, b) in zip(ref, got):
        a = np.asarray(a)
        assert a.shape == b.shape, k
        assert a.tobytes() == np.asarray(b).tobytes(), k
    assert tparam.count_params(model) == jparam.count_params(params)


def test_partition_merge_cast_and_numpy_export(jax_params, host_params, tmp_path):
    model = _model(host_params)
    named = dict(model.named_parameters())
    mask = topt.trainable_mask(named.items(), "pretrain")
    trainable, frozen = tparam.partition_params(model, mask)
    assert set(trainable) == set(frozen) == set(named)
    assert all((trainable[n] is None) != (frozen[n] is None) for n in named)
    assert all(t is named[n] for n, t in tparam.merge_params(trainable, frozen).items())
    assert tparam.count_params({n: t for n, t in trainable.items() if t is not None}) == \
        jparam.count_params(jparam.partition_params(jax_params, _jax_mask(jax_params))[0])
    cast = tparam.tree_cast(model, "bfloat16")
    assert all(t.dtype == torch.bfloat16 for t in cast.values())
    # the flat export: the JAX package's keys and arrays
    tckpt.save_params_numpy(str(tmp_path / "port.npz"), model)
    jckpt.save_params_numpy(str(tmp_path / "jax.npz"), jax_params)
    got, ref = np.load(str(tmp_path / "port.npz")), np.load(str(tmp_path / "jax.npz"))
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _jax_mask(params):
    from visper_lm_tpu.train.optimizer import trainable_mask

    return trainable_mask(params, "pretrain")


@pytest.mark.parametrize("preset", ["tiny_test_vlm", "phi3_clip_vlm"])
@pytest.mark.parametrize("distill", [False, True])
def test_config_json_is_the_jax_packages(preset, distill):
    jcfg = getattr(jconfig, preset)(distill=distill)
    tcfg = getattr(tconfig, preset)(distill=distill)
    assert tconfig.config_to_json(tcfg) == jconfig.config_to_json(jcfg)
    assert tconfig.config_from_json(jconfig.config_to_json(jcfg)) == tcfg
    assert jconfig.config_from_json(tconfig.config_to_json(tcfg)) == jcfg
    lora = jconfig.config_to_json(jconfig.LoraConfig(r=8))
    assert tconfig.config_from_json(lora) == tconfig.LoraConfig(r=8)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_restore_gives_the_same_next_step(host_params, tmp_path):
    """master_weights on, so the master copies ride the checkpoint too."""
    cfg = tconfig.tiny_test_vlm(distill=True)
    b = _batches(2, seed=1)
    opt = topt.OptimizerConfig(**dict(OPT, master_weights=True))
    a = tts.make_train_step(cfg, opt, _model(host_params))
    a(b[0])
    a(b[1])
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"), save_total_limit=2)
    mgr.save(a.step, a, cfg, data_state={"epoch": 0, "steps_in_epoch": 2, "seed": 0})
    next_a = a(b[0])
    fresh = tts.make_train_step(cfg, opt, _model(host_params))
    assert mgr.latest_step() == 2
    mgr.restore(fresh)
    assert fresh.step == 2 and fresh.optimizer.count == 2
    assert fresh(b[0]) == next_a
    for n, p in a.trainable.items():
        assert torch.equal(fresh.trainable[n], p), n
        assert torch.equal(fresh.optimizer.master[n], a.optimizer.master[n]), n
    assert mgr.restore_config() == cfg
    assert mgr.restore_data_state() == {"epoch": 0, "steps_in_epoch": 2, "seed": 0}
    # rotation keeps the newest two; a step already on disk is not rewritten
    for s in (3, 4, 4):
        mgr.save(s, a, cfg)
    assert mgr.steps() == [3, 4]
    assert not [d for d in os.listdir(mgr.directory) if not d.isdigit()]
    assert mgr.restore_data_state() is None
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(str(tmp_path / "empty")).restore(fresh)


def test_checkpoint_save_holds_every_rank_when_one_looks_late(tmp_path, monkeypatch):
    """Two ranks (threads, a barrier each) save the same step twice, as the
    trainer's periodic and final saves do; the second rank reaches each point
    after the coordinator has renamed the step into place. Both pass every
    barrier of both saves: no rank skips one the other waits at."""
    bar = threading.Barrier(2, timeout=20)
    final = tmp_path / "ckpt" / "2"
    counts = {"A": 0, "B": 0}

    def barrier():
        me = threading.current_thread().name
        bar.wait()
        counts[me] += 1
        if me == "B" and counts[me] % 2:
            # the late rank: on past the first barrier only once the step is on disk
            deadline = time.monotonic() + 10
            while not final.exists() and time.monotonic() < deadline:
                time.sleep(0.01)

    monkeypatch.setattr(tckpt.distributed, "barrier", barrier)
    monkeypatch.setattr(tckpt.distributed, "is_coordinator",
                        lambda: threading.current_thread().name == "A")

    class State:
        def state_tensors(self):
            return {"params/w": torch.ones(2)}

    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"))
    errors = []

    def rank():
        try:
            mgr.save(2, State())
            mgr.save(2, State())
        except threading.BrokenBarrierError as e:
            errors.append(e)
            bar.abort()

    threads = [threading.Thread(target=rank, name=n) for n in ("A", "B")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert counts == {"A": 3, "B": 3} and mgr.steps() == [2]


@pytest.mark.parametrize("takes_skip", [True, False])
def test_resume_consumes_the_exact_data_order(host_params, tmp_path, takes_skip):
    """A run interrupted at step 3 and resumed to 6 trains on exactly the
    uninterrupted run's batches and lands on bit-equal trainables: with
    skip_batches the stream is asked for batch 3 on; without it the first
    three are drawn and dropped (islice)."""
    batches = _batches(6, seed=3)
    requested, produced = [], []

    if takes_skip:
        def data_iter(epoch, skip_batches=0):
            requested.append((epoch, skip_batches))
            yield from batches[skip_batches:]
    else:
        def data_iter(epoch):
            for i, b in enumerate(batches):
                produced.append(i)
                yield b

    full = _train(host_params, _trainer(tmp_path, "full", max_steps=6, resume=False), data_iter)
    _train(host_params, _trainer(tmp_path, "res", max_steps=3), data_iter)
    requested.clear()
    produced.clear()
    resumed = _train(host_params, _trainer(tmp_path, "res", max_steps=6), data_iter)
    assert resumed.step == full.step == 6
    if takes_skip:
        assert requested == [(0, 3)]
    else:
        assert produced == list(range(6))
    for n, p in _trainables(full).items():
        assert torch.equal(resumed.trainable[n], p), n
    assert [r["step"] for r in _records(tmp_path, "res")] == [1, 2, 3, 4, 5, 6]
    losses_full = [r["loss"] for r in _records(tmp_path, "full")]
    assert [r["loss"] for r in _records(tmp_path, "res")] == losses_full


def test_trainer_groups_micro_batches(host_params, tmp_path):
    """grad_accum_steps=2: five host batches make two steps (the fifth, an
    incomplete group, is dropped); each step is the accumulated step over
    its two batches."""
    batches = _batches(5, seed=5)
    state = _train(host_params, _trainer(tmp_path, "acc", grad_accum_steps=2,
                                          remat_policy="save_gate"),
                   lambda epoch: iter(batches))
    assert state.step == 2 and state.accum_steps == 2
    records = _records(tmp_path, "acc")
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["steps_per_sec"] > 0 for r in records)
    cfg = tconfig.tiny_test_vlm(distill=True)
    by_hand = tts.make_train_step(cfg, topt.OptimizerConfig(**OPT), _model(host_params),
                                  remat_policy="save_gate", accum_steps=2)
    for i in (0, 2):
        m = by_hand({k: np.stack([batches[i][k], batches[i + 1][k]]) for k in batches[i]})
        assert m["loss"] == records[i // 2]["loss"]
    assert tckpt.CheckpointManager(str(tmp_path / "acc" / "checkpoints")).latest_step() == 2


def test_sigterm_saves_a_checkpoint_and_stops(host_params, tmp_path):
    batches = _batches(5, seed=7)
    seen = []

    def hook(step, state, dbatch):
        seen.append(step)
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    state = _train(host_params, _trainer(tmp_path, "term", max_steps=5),
                   lambda epoch: iter(batches), step_hooks=[hook])
    assert state.step == 2 and seen == [1, 2]
    mgr = tckpt.CheckpointManager(str(tmp_path / "term" / "checkpoints"))
    assert mgr.steps() == [2]
    assert mgr.restore_data_state() == {"epoch": 0, "steps_in_epoch": 2, "seed": 0}
    assert signal.getsignal(signal.SIGTERM) is before


def test_a_failing_data_stream_raises_in_the_loop(host_params, tmp_path):
    """The prefetch thread hands the stream's exception to the loop, which
    raises it after the batches before it have trained."""
    batches = _batches(1, seed=9)

    def data_iter(epoch):
        yield batches[0]
        raise OSError("the stream broke")

    seen = []
    with pytest.raises(OSError, match="the stream broke"):
        _train(host_params, _trainer(tmp_path, "broken"), data_iter,
               step_hooks=[lambda step, state, dbatch: seen.append(step)])
    assert seen == [1]


def test_what_the_port_does_not_have_raises(host_params, tmp_path):
    cfg = tconfig.tiny_test_vlm(distill=True)
    model = _model(host_params)
    # sharded teachers without a model axis: nothing to shard (JAX's P() on
    # a one-device mesh), the teachers stay whole
    assert tts.make_train_step(cfg, topt.OptimizerConfig(**OPT), model,
                               shard_teachers=True).teacher_sharded is None
    # ZeRO-3 and sharded teachers in one process (no mesh, as on JAX's
    # one-device mesh: nothing to shard) and the one-device memory levers
    # train, and as the plain loop does
    batches = _batches(2, seed=5)
    plain = _trainables(_train(host_params, _trainer(tmp_path, "plain", max_steps=2),
                               lambda epoch: iter(batches)))
    for name, kw in (("offload", dict(offload_opt_state=True)), ("stream", dict(stream_grads=2)),
                     ("zero_params", dict(zero_params=True)),
                     ("zero_frozen", dict(zero_frozen=True)),
                     ("shard_teachers", dict(shard_teachers=True))):
        state = _train(host_params, _trainer(tmp_path, name, max_steps=2, **kw),
                       lambda epoch: iter(batches))
        assert state.step == 2
        assert (state.grad_stream is not None) == ("stream_grads" in kw)
        assert state.zero is None and state.sharded is None
        assert type(state.optimizer).__name__ == ("OffloadedAdamW" if "offload_opt_state" in kw
                                                  else "AdamW")
        for n, p in _trainables(state).items():
            assert torch.equal(p, plain[n]), (name, n)
    # dp 2 needs a second process (JAX's mesh assertion), tp 2 a second
    # process too (tests/test_torch_tensor_parallel.py runs it in four)
    with pytest.raises(AssertionError, match=r"!= available devices\(1\)"):
        ttrain.train(cfg, topt.OptimizerConfig(**OPT), _trainer(tmp_path, "x", dp=2), model,
                     lambda epoch: iter(()))
    with pytest.raises(ValueError, match="tp 2 needs 2 processes"):
        ttrain.train(cfg, topt.OptimizerConfig(**OPT), _trainer(tmp_path, "x", tp=2), model,
                     lambda epoch: iter(()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.train(cfg, topt.OptimizerConfig(**OPT), _trainer(tmp_path, "x", device=None),
                         model, lambda epoch: iter(()))


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny_test_vlm", "phi3_clip_vlm"])
def test_flop_counts_are_the_jax_packages(preset):
    jcfg, tcfg = getattr(jconfig, preset)(distill=True), getattr(tconfig, preset)(distill=True)
    for b, t in ((1, 64), (4, 1024)):
        np.testing.assert_allclose(tdiag.train_step_flops(tcfg, b, t),
                                   jdiag.train_step_flops(jcfg, b, t), rtol=1e-12)
    np.testing.assert_allclose(tdiag.vision_flops(tcfg), jdiag.vision_flops(jcfg), rtol=1e-12)
    np.testing.assert_allclose(tdiag.teacher_flops(4), jdiag.teacher_flops(4), rtol=1e-12)


def test_decoder_params_are_the_decoders_matmul_weights():
    """Every decoder parameter but the norms' scales, with the lm_head
    counted once more when it is tied to the embedding."""
    cfg = tconfig.tiny_test_vlm(distill=True)
    dec = tdec.Decoder(cfg.decoder)
    n = sum(p.numel() for name, p in dec.named_parameters() if "norm" not in name)
    if dec.lm_head is None:
        n += dec.embed_tokens.weight.numel()
    assert tdiag.decoder_params(cfg) == n


def test_finite_check_step_timer_and_trace():
    named = {"mm_projector.layers.0.weight": torch.tensor([[1.0, -3.0]]),
             "mm_projector.layers.0.bias": torch.tensor([2.0]),
             "heads.gen.0.proj_out.weight": torch.tensor([[float("nan"), 1.0]])}
    out = tdiag.finite_check(named)
    assert out == {"mm_projector/layers": (True, 3.0), "heads/gen": (False, out["heads/gen"][1])}
    ref = jdiag.finite_check({"mm_projector": {"layers": [{"kernel": jnp.asarray([[1.0], [-3.0]]),
                                                           "bias": jnp.asarray([2.0])}]}})
    assert ref == {"mm_projector/layers": out["mm_projector/layers"]}
    # a span in a CPU trace only while spans are on (tests/test_torch_spans.py)
    for on in (False, True):
        tdiag.enable(on)
        try:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                with tdiag.span("engine.admit", requests=2):
                    torch.ones(4).sum()
        finally:
            tdiag.enable(False)
        names = [e.name() for e in prof.profiler.kineto_results.events()]
        assert ("engine.admit[requests=2]" in names) == on
    x = torch.tensor([0.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"), tdiag.nan_guard():
        (torch.sqrt(x) * 0.0).sum().backward()
