"""Tensor parallelism in the port (visper_lm_tpu_torch/parallel/tensor.py and
the slice's changes to the decoder, the losses, the optimizer, the step,
the Generator, checkpoints and the CLI) on four gloo ranks on the CPU at
dp 2 x tp 2, against the JAX package on make_mesh(dp=2, tp=2) of the
suite's virtual CPU devices.

One spawn of tests/_torch_tp_worker.py (four processes started from the
VISPER_* environment, a free port, its own timeout) runs every case; the
ranks write what they computed to files, and the tests below compare, at
f32:

  1. the operators: copy_to_group / reduce_from_group, the vocab-parallel
     lookup (negative ids zeroed) and cross-entropy (1e-12 in f64) against
     their one-process forms;
  2. each rank reads the rows of its data coordinate: the tp ranks of one
     data group the same rows, the two data groups others (the CLI's
     iterator included);
  3. the tp x dp Generator: each data rank's greedy tokens equal the JAX
     single-device reference's rows exactly, as tests/test_sharded_generate.py
     holds JAX's own sharded Generator, with a bf16 / f32 cache of nkv / tp
     heads and with an int8 one;
  4. `from_jax_params(..., tp=)` slices on the host: gathered back, every
     parameter equals the JAX tree's bit for bit;
  5. the PT step of tiny_test_vlm(distill=True), teachers in the step, at
     global batch 4 against JAX's `make_train_step` on the same mesh: step-1
     loss and metrics (rtol 1e-5), gradients (atol 1e-4 x the largest |grad|
     + rtol 1e-3), the chunked cross-entropy forced (rtol 1e-6 of the full
     one), the trainables after 3 updates (atol 2e-5 / rtol 1e-4): the
     tolerances of test_torch_train_step.py; replicated parameters
     bit-identical across the two tp ranks;
  6. shard_teachers: the same metrics as replicated teachers, bit for bit
     (the gathered weights are the same bytes), and half the bytes of the
     split leaves a rank, freed between steps;
  7. zero_params at dp 2 x tp 2 in the finetune stage (the Megatron leaves
     train) against without, within rtol 1e-5 (test_multihost.py's bound:
     a split leaf's norm is its slices' sums added in another order);
  8. the pretrain_full levers on the tiny model (stage full, zero_params,
     offloaded moments, stream_grads 2, shard_teachers) against JAX's full
     stage without them (the tolerances of 5);
  9. a checkpoint saved at dp 2 x tp 2 is a one-device run's files: restored
     at dp 2 x tp 2 and dp 1 x tp 2 in the ranks and in one process here,
     bit-true;
 10. `cli.main(["@recipes/pretrain_full.args", "--smoke", "--dp", "2",
     "--tp", "2", ...])`: only rank 0 writes, and every rank logs the same
     loss.

These run in tier-1 while their JAX twins (tests/test_multihost.py,
tests/test_sharded_generate.py) are marked slow: the JAX ones compile XLA
programs in each process, these spawn four torch ranks of a tiny model.
"""

import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from visper_lm_tpu.data.collate import build_splice_plan, collate_plans
from visper_lm_tpu.models import teachers as jteach
from visper_lm_tpu.models import vlm as jvlm
from visper_lm_tpu.models.teachers import swin as jswin
from visper_lm_tpu.models.teachers import unclip as junclip
from visper_lm_tpu.parallel.mesh import make_mesh
from visper_lm_tpu.serve.generate import GenerationConfig, Generator, left_pad_plans
from visper_lm_tpu.train import optimizer as jopt
from visper_lm_tpu.train import train_step as jts

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.data.image_io import write_png
from visper_lm_tpu_torch.parallel import tensor as T
from visper_lm_tpu_torch.train import optimizer as topt
from visper_lm_tpu_torch.train import train_step as tts
from visper_lm_tpu_torch.train.checkpoint import CheckpointManager
from visper_lm_tpu_torch.utils.param import split_layer
from visper_lm_tpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_spawn as S  # noqa: E402
from _torch_tp_worker import OPT, STEPS, TEACHERS  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SPAWN_TIMEOUT = 420


def _batch(cfg, bsz=4, seq=64):
    """A global PT batch of 4 with the teachers' pixels: rows 0-1 (data
    rank 0) shorter than rows 2-3 (data rank 1)."""
    rng = np.random.default_rng(0)
    plans = []
    for b in range(bsz):
        ids = [1, 2, 3] + [IMAGE_TOKEN_INDEX] + list(rng.integers(3, 400, size=6 + 5 * b))
        labels = [IGNORE_INDEX] * 4 + ids[4:]
        plans.append(build_splice_plan(ids, labels, seq, num_image_tokens=cfg.num_image_tokens,
                                       num_task_tokens=2, num_tasks=3))
    img = rng.normal(size=(bsz, 28, 28, 3)).astype(np.float32)
    batch = collate_plans(plans, images=img)
    batch["depth_images"] = img
    batch["gen_images"] = rng.normal(size=(bsz, 28, 28, 3)).astype(np.float32)
    batch["seg_images"] = rng.normal(size=(bsz, 64, 64, 3)).astype(np.float32)
    for t in cfg.distill.tasks:
        batch[f"{t.task}_mask"] = np.array([1, 0, 1, 1], np.float32)
    return batch


def _gen_batch(cfg):
    """tests/test_sharded_generate.py's prompts and images."""
    rng = np.random.default_rng(0)
    plans = [build_splice_plan(
        [1, 2, 3, IMAGE_TOKEN_INDEX] + list(rng.integers(4, 400, size=5 + b)), None, 64,
        num_image_tokens=cfg.num_image_tokens, num_task_tokens=cfg.distill.num_task_tokens,
        num_tasks=3) for b in range(4)]
    images = rng.normal(size=(4, 28, 28, 3)).astype(np.float32)
    batch = left_pad_plans(plans, 64)
    batch["images"] = images
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


def _spawn(workdir):
    return S.spawn("_torch_tp_worker.py", [workdir], WORLD, workdir, PYTHONHASHSEED="0")


def _wait(procs, workdir):
    """Every rank's exit code 0 within SPAWN_TIMEOUT; a hang or a failure
    fails the test (and kills the ranks: tests/_torch_spawn.py)."""
    S.wait(procs, workdir, SPAWN_TIMEOUT)


def _flat(tree):
    return {jopt._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_view(name, arr):
    return arr.T if topt.jax_path(name).endswith("/kernel") else arr


def _jax_teachers(cfg_j):
    jt = jteach.TeacherConfigs(
        dinov2=jconfig.VisionConfig(**TEACHERS["dinov2"]),
        clip_h=jconfig.VisionConfig(**TEACHERS["clip_h"]),
        swin=jswin.SwinConfig(**TEACHERS["swin"]),
    )
    old = junclip.GEN_EMBED_DIM
    junclip.GEN_EMBED_DIM = 24
    try:
        teachers = jteach.init_teachers(jax.random.PRNGKey(1), cfg_j, dtype=jnp.float32, tcfgs=jt)
    finally:
        junclip.GEN_EMBED_DIM = old
    return jt, teachers


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (spawned first, so they run while JAX compiles) and
    JAX's: the single-device Generator's tokens, the PT step's step-1 loss,
    metrics and gradients at the global batch and its trainables after
    STEPS updates on make_mesh(dp=2, tp=2), and the full stage's."""
    workdir = tmp_path_factory.mktemp("tp")
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    params = jvlm.init_vlm(jax.random.PRNGKey(0), cfg_j)
    jt, teachers = _jax_teachers(cfg_j)
    host = jax.tree_util.tree_map(np.asarray, params)
    with open(workdir / "params.pkl", "wb") as f:
        pickle.dump(host, f)
    with open(workdir / "teachers.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, teachers), f)
    batch, gen = _batch(cfg_j), _gen_batch(cfg_j)
    np.savez(workdir / "batch.npz", **batch)
    np.savez(workdir / "gen.npz", **gen)
    _dataset(str(workdir / "data"))
    procs = _spawn(workdir)

    gen_ref = Generator(params, cfg_j, GenerationConfig(max_new_tokens=5), 4, 64,
                        cache_dtype=jnp.float32).generate(dict(gen))
    gen_int8 = Generator(params, cfg_j, GenerationConfig(max_new_tokens=5, kv_quant=True), 4, 64,
                         cache_dtype=jnp.float32).generate(dict(gen))
    tfn = jteach.make_teacher_fn(cfg_j, jt)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = jts.make_loss_fn(cfg_j, teacher_fn=tfn, use_pallas=False)
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jbatch, teachers)
    mesh = make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    ref = {}
    for stage in ("pretrain", "full"):
        with mesh:
            step_j, state, _ = jts.make_train_step(
                cfg_j, jopt.OptimizerConfig(**OPT, stage=stage), params, mesh, teacher_fn=tfn,
                teacher_params=teachers, use_pallas=False)
            dbatch = jts.shard_batch(batch, mesh)
            metrics = []
            for _ in range(STEPS):
                state, m = step_j(state, dbatch)
                metrics.append({k: float(v) for k, v in m.items()})
        ref[stage] = dict(params=_flat(state.params), metrics=metrics)
    _wait(procs, workdir)
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(ranks=ranks, workdir=workdir, cfg_t=cfg_t, host=host, gen_ref=gen_ref,
                gen_int8=gen_int8,
                loss_j=float(loss_j), met_j={k: float(v) for k, v in met_j.items()},
                grads_j=_flat(grads_j), ref=ref)


def _check_metrics(got, want, rtol=1e-5):
    for m_t, m_j in zip(got, want):
        for k in m_j:
            np.testing.assert_allclose(m_t[k], m_j[k], rtol=rtol, atol=1e-7, err_msg=k)


def _check_params(state, ref_params, count):
    names = [k[len("params/"):] for k in state if k.startswith("params/")]
    assert len(names) == count
    for n in names:
        ref, layer = ref_params[topt.jax_path(n)], split_layer(n)[1]
        np.testing.assert_allclose(_port_view(n, state[f"params/{n}"].numpy()),
                                   ref if layer is None else ref[layer], atol=2e-5, rtol=1e-4,
                                   err_msg=n)


def _peers(runs):
    """The two tensor-parallel groups' rank pairs."""
    return [(0, 1), (2, 3)]


def test_tp_operators_match_their_one_process_forms(runs):
    for rank in runs["ranks"]:
        ops = rank["ops"]
        assert ops["copy_to_group"] and ops["reduce_from_group"] and ops["vocab_embed"], ops
        assert ops["vocab_parallel_nll"] < 1e-12 and ops["vocab_parallel_nll_grad"] < 1e-12, ops


def test_each_rank_reads_the_rows_of_its_data_coordinate(runs):
    """'model' innermost: ranks 0-1 are data coordinate 0, ranks 2-3 data
    coordinate 1; the tp ranks of a group read the same rows (the worker's
    shard and every batch the CLI's iterator gave), the groups others."""
    ranks = runs["ranks"]
    assert [r["coords"] for r in ranks] == [{"data": d, "model": m} for d in (0, 1)
                                            for m in (0, 1)]
    assert [r["data_shard"] for r in ranks] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert [r["rows"] for r in ranks] == [(0, 2), (0, 2), (2, 4), (2, 4)]
    for a, b in _peers(runs):
        seen_a, seen_b = ranks[a]["cli"]["rows"], ranks[b]["cli"]["rows"]
        assert len(seen_a) >= 2 and len(seen_a) == len(seen_b)
        assert all(np.array_equal(x, y) for x, y in zip(seen_a, seen_b))
    assert not any(np.array_equal(x, y) for x, y in zip(ranks[0]["cli"]["rows"],
                                                        ranks[2]["cli"]["rows"]))


def test_tp_dp_generator_tokens_equal_jax(runs):
    """Each data rank generates its own 2 rows on tp 2: the greedy tokens of
    the single-device JAX reference, exactly; the cache holds nkv / 2 heads."""
    for rank in runs["ranks"]:
        s, e = rank["generate"]["rows"]
        assert rank["generate"]["tokens"] == runs["gen_ref"][s:e]
        assert rank["cache_heads"] == runs["cfg_t"].decoder.num_kv_heads // 2


def test_tp_dp_generator_with_an_int8_cache_equals_jax(runs):
    """The int8 KV cache (per (token, head) scales) of the rank's kv heads:
    the tokens of JAX's single-device Generator with kv_quant, exactly."""
    for rank in runs["ranks"]:
        s, e = rank["generate"]["rows"]
        assert rank["generate_int8_kv"] == runs["gen_int8"][s:e]


def test_from_jax_params_slices_on_the_host_and_gathers_back(runs):
    """Every rank holds half of each Megatron leaf (heads, kv heads, MLP
    columns, vocab rows); gathered back, each parameter is the JAX tree's."""
    cfg = runs["cfg_t"].decoder
    shapes = runs["ranks"][0]["local_shapes"]
    assert shapes["decoder.blocks.0.q_proj.weight"] == (cfg.num_heads * cfg.head_dim // 2,
                                                       cfg.hidden_size)
    assert shapes["decoder.blocks.0.k_proj.weight"] == (cfg.num_kv_heads * cfg.head_dim // 2,
                                                       cfg.hidden_size)
    assert shapes["decoder.blocks.0.o_proj.weight"] == (cfg.hidden_size,
                                                       cfg.num_heads * cfg.head_dim // 2)
    assert shapes["decoder.blocks.0.down_proj.weight"] == (cfg.hidden_size, cfg.mlp_dim // 2)
    assert shapes["decoder.embed_tokens.weight"] == (cfg.vocab_size // 2, cfg.hidden_size)
    assert shapes["decoder.lm_head.weight"] == (cfg.vocab_size // 2, cfg.hidden_size)
    assert shapes["decoder.blocks.0.attn_norm.scale"] == (cfg.hidden_size,)
    whole = runs["ranks"][0]["whole_params"]
    want = from_jax_params(runs["host"], runs["cfg_t"], device="cpu")
    for n, p in want.named_parameters():
        assert torch.equal(whole[n], p.detach()), n


def test_pt_step_at_dp2_tp2_matches_jax(runs):
    """Step-1 loss, metrics and the gradients summed over the data group
    (replicated over tp: PT trains no Megatron leaf), the chunked
    cross-entropy forced, and the trainables after 3 updates: JAX's."""
    for rank in runs["ranks"]:
        pt = rank["pt"]
        for k, v in runs["met_j"].items():
            np.testing.assert_allclose(pt["met"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(pt["met_chunked"][k], pt["met"][k], rtol=1e-6, atol=1e-8,
                                       err_msg=k)
        np.testing.assert_allclose(pt["met"]["loss"], runs["loss_j"], rtol=1e-5)
        assert len(pt["grads"]) == 90
        for n, g in pt["grads"].items():
            ref = runs["grads_j"][topt.jax_path(n)]
            np.testing.assert_allclose(_port_view(n, g.numpy()), ref,
                                       atol=1e-4 * float(np.abs(ref).max()) + 1e-12, rtol=1e-3,
                                       err_msg=n)
            np.testing.assert_allclose(pt["grads_chunked"][n].numpy(), g.numpy(), rtol=1e-5,
                                       atol=1e-6 * float(g.abs().max()) + 1e-12, err_msg=n)
        _check_metrics(pt["metrics"], runs["ref"]["pretrain"]["metrics"])
        _check_params(pt["state"], runs["ref"]["pretrain"]["params"], 90)
        assert pt["loss_after"] != pt["met"]["loss"]
    ranks = runs["ranks"]
    for a, b in _peers(runs):
        rep_a, rep_b = ranks[a]["pt"]["replicated"], ranks[b]["pt"]["replicated"]
        assert len(rep_a) == 90 and sorted(rep_a) == sorted(rep_b)
        for n in rep_a:
            assert torch.equal(rep_a[n], rep_b[n]), n
    assert all(r["pt"]["metrics"] == ranks[0]["pt"]["metrics"] for r in ranks)


def test_shard_teachers_gives_the_same_step_with_half_the_large_leaves(runs):
    for rank in runs["ranks"]:
        got, plain = rank["teachers"], rank["pt"]
        assert got["met"] == plain["met"]
        assert got["metrics"] == plain["metrics"]
        for k, v in plain["state"].items():
            assert torch.equal(got["state"][k], v), k
        # the leaves of >= 2^16 elements (the MLPs of DINOv2 and CLIP-H, the
        # DPT head's convolutions), half a rank, freed between steps
        mlps = {f"{t}.blocks.{i}.{fc}.weight" for t in ("dinov2", "clip_h") for i in range(2)
                for fc in ("fc1", "fc2")}
        assert mlps <= set(got["split"])
        assert not any(n.startswith("swin.") for n in got["split"])
        assert got["shard_bytes"] * 2 == got["split_whole_bytes"] > 0
        assert got["storage_after"] == 0
        assert got["split_whole_bytes"] > got["whole_bytes"] / 2


def test_zero_params_at_dp2_tp2_trains_as_without(runs):
    """The finetune stage, whose Megatron leaves train: ZeRO-3 over the data
    group of the tp-local tensors against the plain step, rel 1e-5
    (test_multihost.py::test_zero_params_step_runs' bound), each rank
    keeping a slice; the replicated trainables bit-identical across tp."""
    ranks = runs["ranks"]
    for rank in ranks:
        got, plain = rank["ft_zero"], rank["ft"]
        _check_metrics(got["metrics"], plain["metrics"])
        for k, v in plain["state"].items():
            if k.startswith("params/"):
                np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=1e-5,
                                           atol=1e-7, err_msg=k)
        assert "decoder.blocks.0.q_proj.weight" in got["sharded"] and got["shard_bytes"] > 0
        assert plain["metrics"][2]["loss"] != plain["metrics"][1]["loss"]
    for a, b in _peers(runs):
        rep_a, rep_b = ranks[a]["ft"]["replicated"], ranks[b]["ft"]["replicated"]
        assert "decoder.final_norm.scale" in rep_a
        for n in rep_a:
            assert torch.equal(rep_a[n], rep_b[n]), n


def test_pretrain_full_levers_at_dp2_tp2_match_jax(runs):
    """zero_params + offloaded moments + stream_grads 2 + shard_teachers in
    the full stage: JAX's full stage without the levers (the tolerances of
    the PT step)."""
    ranks = runs["ranks"]
    for rank in ranks:
        full = rank["full"]
        # offloaded: the moments split over both axes (JAX's covers-the-mesh
        # rule), each a whole block (dim 0 of every one is split)
        assert full["streamed"] and full["offloaded"] > 0 and full["blocks"] == 0
        assert full["teacher_split"] == len(rank["teachers"]["split"])
        _check_metrics(full["metrics"], runs["ref"]["full"]["metrics"])
        n_params = sum(1 for k in full["state"] if k.startswith("params/"))
        assert n_params > 90
        _check_params(full["state"], runs["ref"]["full"]["params"], n_params)
    for a, b in _peers(runs):
        rep_a, rep_b = ranks[a]["full"]["replicated"], ranks[b]["full"]["replicated"]
        assert any(n.startswith("vision_tower.") for n in rep_a)
        for n in rep_a:
            assert torch.equal(rep_a[n], rep_b[n]), n


def test_checkpoint_at_dp2_tp2_restores_anywhere(runs):
    """The coordinator wrote the one-device files; the ranks restored them
    bit-true at dp 2 x tp 2 and (ranks 0, 1) at dp 1 x tp 2, and a
    one-process step restores them bit-true here."""
    for r, rank in enumerate(runs["ranks"]):
        assert rank["restore_dp2_tp2"] == dict(step=STEPS, equal=True)
        if r < 2:
            assert rank["restore_dp1_tp2"] == dict(step=STEPS, equal=True)
    mgr = CheckpointManager(str(runs["workdir"] / "ckpt"))
    assert mgr.steps() == [STEPS]
    cfg = runs["cfg_t"]
    step = tts.make_train_step(cfg, topt.OptimizerConfig(**OPT, stage="finetune"),
                               from_jax_params(runs["host"], cfg, device="cpu"))
    mgr.restore(step)
    assert step.step == STEPS
    saved = runs["ranks"][0]["ft_zero"]["state"]
    got = step.state_tensors()
    assert sorted(got) == sorted(saved)
    for k, v in saved.items():
        assert torch.equal(got[k].detach(), v), k


def test_cli_pretrain_full_recipe_at_dp2_tp2_writes_once_and_ranks_agree(runs):
    out = runs["workdir"] / "cli"
    with open(out / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    assert sorted(os.listdir(out / "checkpoints")) == ["1", "2"]
    clis = [rank["cli"] for rank in runs["ranks"]]
    for c in clis:
        assert c["step"] == 2 and c["tp"] == 2 and c["streamed"]
        assert c["optimizer"] == "OffloadedAdamW"
        assert c["metrics"]["loss"] == rows[-1]["loss"]
    assert np.isfinite(rows[-1]["loss"])


def test_divisibility_limit_and_the_raises_of_a10b_2():
    """What still raises under tp: heads, kv heads, the MLP and the
    vocabulary must divide by tp (the port pads nothing, C21), an int4
    row-parallel linear's groups may not straddle two ranks (C28), and a
    model is cut once. The serving paths that raised until A10b-2 build on
    a tp decoder (tests/test_torch_tp_serving.py runs them)."""
    cfg = tconfig.tiny_test_vlm(distill=False).decoder
    T.check_divisible(cfg, 2)
    with pytest.raises(ValueError, match="num_kv_heads 2 does not divide by tp 4"):
        T.check_divisible(cfg, 4)
    for name, shipped in (("phi3", tconfig.PHI3_MINI_4K), ("llama3", tconfig.LLAMA3_8B),
                          ("vicuna", tconfig.VICUNA_7B)):
        for tp in (2, 4, 8):
            T.check_divisible(shipped, tp)
    from visper_lm_tpu_torch.models.decoder import Decoder, quantize_decoder
    from visper_lm_tpu_torch.serve.beam import BeamSearchDecoder
    from visper_lm_tpu_torch.serve.speculative import PromptLookupDecoder

    group = T.TensorParallel(None, 0, 2)
    with torch.device("meta"):
        dec = T.shard_model(Decoder(cfg), group)
    assert dec.blocks[0].q_proj.weight.shape == (cfg.num_heads * cfg.head_dim // 2,
                                                 cfg.hidden_size)
    BeamSearchDecoder(dec, num_beams=2)
    PromptLookupDecoder(dec)
    with pytest.raises(ValueError, match="C28"):
        quantize_decoder(dec, "int4")          # o_proj: one group of 64 over din 64
    T.check_int4_groups(86, 2)                 # Vicuna-7B's down_proj at tp 2 (11008 / 128)
    with pytest.raises(ValueError, match="86 int4 groups .* tp 4 .*C28"):
        T.check_int4_groups(86, 4)
    for shipped in (tconfig.PHI3_MINI_4K, tconfig.LLAMA3_8B):
        for tp in (2, 4, 8):
            for din in (shipped.num_heads * shipped.head_dim, shipped.mlp_dim):
                T.check_int4_groups(din // 128, tp)
    with pytest.raises(ValueError, match="already tensor parallel"):
        T.shard_model(dec, group)
