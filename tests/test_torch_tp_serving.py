"""Serving and LoRA under tensor parallelism in the port (the tp Engine,
speculative, prompt-lookup and beam decoding, chat / serve / ChatSession,
int8 / int4 / AWQ weights sliced to each rank, the LoRA stage and its merge,
and a MoE Generator routing over the global batch under data parallelism)
on four gloo ranks on the CPU at dp 2 x tp 2, against the JAX package's
one-device results (GSPMD runs the one-device program on sharded
parameters, tests/test_sharded_generate.py, so that is the spec).

One spawn of tests/_torch_tp_serving_worker.py (four processes from the
VISPER_* environment, a free port, its own timeout, one torch thread each)
runs every case while JAX computes its references here; f32 throughout:

  1. the Engine at tp 2 (tests/test_engine.py's prompts and modes: plain,
     the int8 cache, w8a16, chunked prefill, the speculative quantum,
     grouped admission, and a prefix-cache chain): tokens and the schedule
     counts equal JAX's `Engine`, the cache nkv / 2 heads;
  2. quantized weights: every rank's int8 / int4 / AWQ buffers of
     `quantize_decoder`, gathered, equal JAX's `quantize_linear_weights*`
     of the whole tree (int8 arrays bit for bit, scales rtol 1e-6:
     tests/test_torch_quant.py's rules), the Generator's greedy tokens with
     each equal JAX's; the tp calibration's act-RMS is the slice of JAX's
     (rtol 1e-5); `from_jax_params` cuts JAX's int4 tree into the same
     slices;
  3. `SpeculativeDecoder` (draft at tp and whole) and `PromptLookupDecoder`:
     tokens and acceptance counts of JAX's; sampling: the warped
     probabilities of JAX's (atol 1e-6), the tokens of a one-process run
     with the same seed; `BeamSearchDecoder` (2 and 3 beams): JAX's tokens
     and score (rtol 1e-5);
  4. chat / serve (also w8a16) / a three-turn ChatSession: JAX's strings
     (a tokenizer that does not depend on the hash seed, ROADMAP C2);
  5. the LoRA stage at dp 2 x tp 2, without remat and with save_qkv_mlp
     (the stashed linears' side path), against JAX's `make_train_step` on
     make_mesh(dp=2, tp=2): step-1 metrics rtol 1e-5, gradients atol 1e-4
     x the largest |grad| + rtol 1e-3, 3 updates (metrics rtol 1e-5,
     trainables atol 2e-5 / rtol 1e-4 where the gradient is above f32's
     noise: tests/test_torch_stages.py's rule); the factors (replicated)
     bit-identical on the two ranks of each tp group; a checkpoint written
     at tp restored in one process bit for bit; `apply_lora` on the tp
     model gathered equals JAX's merge (rtol 1e-6); at dp 1 x tp 4, where
     the model group is the default one, the step's gradients equal one
     process's (the gradients' tolerance above);
  6. C25's serving half: a MoE Generator at dp 2 (whole model) and dp 2 x
     tp 2, capacity binding, an eos that stops one data rank's rows
     first: each data rank's rows equal JAX's one-device Generator over
     the global batch;
  7. C28: an int4 row-parallel linear whose groups would straddle two ranks
     raises.

Every case's two tp ranks return the same tokens and strings.
"""

import dataclasses
import os
import pickle
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from visper_lm_tpu import api as japi
from visper_lm_tpu import config as jconfig
from visper_lm_tpu.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from visper_lm_tpu.data.collate import build_splice_plan as j_build_splice_plan
from visper_lm_tpu.data.collate import collate_plans
from visper_lm_tpu.models import lora as jlora
from visper_lm_tpu.models.decoder import decoder_forward, embed_tokens, init_decoder
from visper_lm_tpu.models.vlm import init_vlm as j_init_vlm
from visper_lm_tpu.parallel.mesh import make_mesh
from visper_lm_tpu.serve import calibrate as jcal
from visper_lm_tpu.serve import engine as jeng
from visper_lm_tpu.serve import speculative as jspec
from visper_lm_tpu.serve.beam import BeamSearchDecoder as JBeam
from visper_lm_tpu.serve.generate import GenerationConfig, Generator, left_pad_plans
from visper_lm_tpu.train import optimizer as jopt
from visper_lm_tpu.train import train_step as jts
from visper_lm_tpu.utils import param as jparam

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.parallel import tensor as T
from visper_lm_tpu_torch.train import optimizer as topt
from visper_lm_tpu_torch.train import train_step as tts
from visper_lm_tpu_torch.train.checkpoint import CheckpointManager
from visper_lm_tpu_torch.utils.param import jax_path, split_layer
from visper_lm_tpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_spawn as S  # noqa: E402
import _torch_tp_serving_worker as W  # noqa: E402

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SPAWN_TIMEOUT = 420
QUANT_NAMES = {"kernel_q8": "weight_q8", "kernel_q4p": "weight_q4p"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {jopt._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0] if v is not None}


def _port_view(name, flat):
    """The JAX leaf of port parameter `name` (its layer of a stacked leaf),
    in the port's layout."""
    path = jax_path(name)
    ref = flat[path]
    layer = split_layer(name)[1]
    if layer is not None:
        ref = ref[layer]
    return ref.T if path.endswith("/kernel") else ref


def _gen_batch(cfg, seed=0):
    """tests/test_sharded_generate.py's 4 prompts and images, left-padded to 64."""
    rng = np.random.default_rng(seed)
    d = cfg.distill
    plans = [j_build_splice_plan(
        [1, 2, 3, IMAGE_TOKEN_INDEX] + list(rng.integers(4, 400, size=5 + b)), None, 64,
        num_image_tokens=cfg.num_image_tokens, num_task_tokens=d.num_task_tokens if d else 0,
        num_tasks=3 if d else 0) for b in range(4)]
    batch = left_pad_plans(plans, 64)
    batch["images"] = rng.normal(size=(4, 28, 28, 3)).astype(np.float32)
    return batch


def _lora_batch(cfg, bsz=4, seq=48):
    rng = np.random.default_rng(0)
    plans = []
    for b in range(bsz):
        ids = [1, 2, 3, IMAGE_TOKEN_INDEX] + list(rng.integers(3, 400, size=8 + 3 * b))
        plans.append(j_build_splice_plan(ids, [IGNORE_INDEX] * 4 + ids[4:], seq,
                                         num_image_tokens=cfg.num_image_tokens))
    return collate_plans(plans, images=rng.normal(size=(bsz, 28, 28, 3)).astype(np.float32))


def _inputs(cfg_serve, cfg_wide, cfg_lora, cfg_moe):
    rng = np.random.default_rng(42)
    inp = {}
    for i, extra in enumerate([5, 40, 90, 130, 17]):
        inp[f"engine_ids{i}"] = np.array([1, 2, 3, IMAGE_TOKEN_INDEX]
                                         + rng.integers(4, 400, size=extra).tolist())
        inp[f"engine_image{i}"] = rng.normal(size=(1, 28, 28, 3)).astype(np.float32)
    rng = np.random.default_rng(9)
    inp["prefix_ids"] = np.array([1, 2, 3, IMAGE_TOKEN_INDEX] + rng.integers(4, 400, 21).tolist())
    inp["prefix_image"] = rng.normal(size=(1, 28, 28, 3)).astype(np.float32)
    for i, n in enumerate((7, 33, 150)):
        inp[f"suffix{i}"] = rng.integers(4, 400, size=n)
    inp["turn2"] = rng.integers(4, 400, size=14)
    inp.update({f"gen_{k}": v for k, v in _gen_batch(cfg_wide).items()})
    inp["calib"] = np.random.default_rng(5).normal(size=(2, 32, 64)).astype(np.float32)
    inp.update({f"lora_{k}": v for k, v in _lora_batch(cfg_lora).items()})
    inp.update({f"moe_{k}": v for k, v in _gen_batch(cfg_moe, seed=4).items()})
    return inp


def _spawn(workdir):
    return S.spawn("_torch_tp_serving_worker.py", [workdir], WORLD, workdir)


def _wait(procs, workdir):
    """Every rank's exit code 0 within SPAWN_TIMEOUT; a hang or a failure
    fails the test (and kills the ranks: tests/_torch_spawn.py)."""
    S.wait(procs, workdir, SPAWN_TIMEOUT)


def _moe_eos(tokens):
    """Ids that end rows 0-1 (data rank 0) early and never appear in rows
    2-3, so data rank 0 is done while data rank 1 still decodes."""
    later = {t for row in tokens[2:] for t in row}
    eos = [next(t for t in row[1:3] if t not in later) for row in tokens[:2]]
    return np.array(eos)


def _jax_engine(params, cfg, inp):
    ids = [inp[f"engine_ids{i}"].tolist() for i in range(5)]
    images = [inp[f"engine_image{i}"] for i in range(5)]
    out = {mode: W.serve_engine(jeng, j_build_splice_plan, params, cfg, ids, images, kw, mn)
           for mode, (kw, mn) in W.ENGINE_MODES.items()}
    out["prefix"] = W.prefix_chain(jeng, j_build_splice_plan, params, cfg, inp)
    return out


def _jax_quant(wide, cfg_w, rms, gen):
    out = {}
    for mode in W.QUANT_MODES:
        calib = rms if mode == "int4_awq" else None
        if mode == "int8":
            qdec = jparam.quantize_linear_weights(wide["decoder"])
        else:
            qdec = jparam.quantize_linear_weights_int4(wide["decoder"], act_rms=calib)
        tokens = Generator(wide, cfg_w, GenerationConfig(
            max_new_tokens=5, weight_quant=mode[:4], calibration=calib), 4, 64,
            cache_dtype=jnp.float32).generate(dict(gen))
        out[mode] = dict(tree=_flat(qdec), tokens=tokens)
    return out


def _jax_spec(target, tcj, draft, dcj):
    kw = dict(max_len=512, cache_dtype=jnp.float32)
    out = {"greedy": jspec.greedy_reference_ids(target, tcj, W.PROMPT,
                                                max_new_tokens=W.SPEC_TOKENS, **kw)}
    ids, st = jspec.SpeculativeDecoder(target, tcj, draft, dcj, k=4, **kw).generate(
        W.PROMPT, max_new_tokens=W.SPEC_TOKENS)
    out["spec"] = (ids, st.accepted, st.iterations)
    ids, st = jspec.PromptLookupDecoder(target, tcj, k=4, ngram=3, **kw).generate(
        W.REPEAT, max_new_tokens=W.SPEC_TOKENS)
    out["lookup"] = (ids, st.accepted, st.iterations)
    toks = jnp.asarray([W.PROMPT])
    logits = decoder_forward(target, tcj, embed_tokens(target, toks), use_pallas=False)["logits"]
    out["warped"] = np.asarray(jspec.warp_probs(logits[0, -1], W.SAMPLING["temperature"],
                                                W.SAMPLING["top_p"]))
    for beams in W.BEAMS:
        out[f"beam{beams}"] = JBeam(target, tcj, num_beams=beams, **kw).generate(
            W.PROMPT, max_new_tokens=6, eos_token_ids=(7,))
    return out


def _jax_chat(params, cfg):
    model = japi.VisperModel(cfg=cfg, params=params, tokenizer=W.StableTok(), context_len=256)
    images = [Image.fromarray(a) for a in W.chat_images()]
    out = dict(chat=model.chat(list(W.QUESTIONS), images, max_new_tokens=5),
               serve=model.serve(list(W.QUESTIONS), images, max_new_tokens=5, num_slots=2),
               chat_w8=model.chat(list(W.QUESTIONS), images, max_new_tokens=5,
                                  weight_quant=True))
    session = model.chat_session(images[0])
    out["session"] = [session.ask(q, max_new_tokens=3) for q in W.QUESTIONS]
    out["session_ids"] = list(session._ids)
    return out


def _jax_lora(params, cfg, batch):
    out = {}
    loss_fn = jts.make_loss_fn(cfg, use_pallas=False)
    (_, met), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    out["met"] = {k: float(v) for k, v in met.items()}
    out["grads"] = _flat(grads)
    mesh = make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    for policy in W.LORA_POLICIES:
        with mesh:
            step, state, _ = jts.make_train_step(cfg, jopt.OptimizerConfig(**W.OPT), params, mesh,
                                                 use_pallas=False, remat_policy=policy)
            dbatch = jts.shard_batch(batch, mesh)
            metrics = []
            for _ in range(W.STEPS):
                state, m = step(state, dbatch)
                metrics.append({k: float(v) for k, v in m.items()})
        out[policy] = dict(metrics=metrics, params=_flat(state.params))
    out["merged"] = _flat(jlora.merge_lora_into_decoder(params["decoder"], params["lora"],
                                                        cfg.lora))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (spawned first, so they run while JAX computes)
    and JAX's one-device references."""
    workdir = tmp_path_factory.mktemp("tp_serving")
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    cfg_w, cfg_l, cfg_m = (W.wide_config(jconfig), W.lora_config(jconfig),
                           W.moe_config(jconfig))
    tcj, dcj = W.spec_configs(jconfig)
    serve = j_init_vlm(jax.random.PRNGKey(7), cfg_j)
    wide = j_init_vlm(jax.random.PRNGKey(3), cfg_w)
    target, draft = init_decoder(jax.random.PRNGKey(0), tcj), init_decoder(
        jax.random.PRNGKey(1), dcj)
    lora = j_init_vlm(jax.random.PRNGKey(0), cfg_l)
    cfg_kv4 = dataclasses.replace(cfg_l, decoder=dataclasses.replace(cfg_l.decoder, num_kv_heads=4))
    lora_kv4 = j_init_vlm(jax.random.PRNGKey(5), cfg_kv4)
    rng = np.random.default_rng(1)       # a B that is not zero: the side path is live
    lora["lora"] = {k: {"a": ab["a"], "b": jnp.asarray(
        rng.normal(0, 0.05, ab["b"].shape).astype(np.float32))} for k, ab in lora["lora"].items()}
    moe = j_init_vlm(jax.random.PRNGKey(2), cfg_m)
    inp = _inputs(cfg_j, cfg_w, cfg_l, cfg_m)
    moe_batch = {k[4:]: v for k, v in inp.items() if k.startswith("moe_")}
    free = Generator(moe, cfg_m, GenerationConfig(max_new_tokens=W.MOE_NEW), 4, 64,
                     cache_dtype=jnp.float32).generate(dict(moe_batch))
    inp["moe_eos"] = _moe_eos(free)
    moe_ref = Generator(moe, cfg_m, GenerationConfig(
        max_new_tokens=W.MOE_NEW, decode_chunk=2,
        eos_token_ids=tuple(int(t) for t in inp["moe_eos"])), 4, 64,
        cache_dtype=jnp.float32).generate(dict(moe_batch))
    rms = jcal.decoder_act_rms(wide["decoder"], cfg_w.decoder, [jnp.asarray(inp["calib"])])
    lora_kv4["lora"] = {k: {"a": ab["a"], "b": jnp.asarray(
        rng.normal(0, 0.05, ab["b"].shape).astype(np.float32))}
        for k, ab in lora_kv4["lora"].items()}
    trees = dict(serve=serve, wide=wide, target=target, draft=draft, lora=lora, moe=moe,
                 lora_kv4=lora_kv4,
                 wide_int4={**wide, "decoder": jparam.quantize_linear_weights_int4(
                     wide["decoder"])}, wide_rms=rms)
    with open(workdir / "trees.pkl", "wb") as f:
        pickle.dump(_np_tree(trees), f)
    np.savez(workdir / "inputs.npz", **inp)
    procs = _spawn(workdir)
    try:
        gen = {k[4:]: v for k, v in inp.items() if k.startswith("gen_")}
        ref = dict(engine=_jax_engine(serve, cfg_j, inp), quant=_jax_quant(wide, cfg_w, rms, gen),
                   spec=_jax_spec(target, tcj, draft, dcj), chat=_jax_chat(serve, cfg_j),
                   lora=_jax_lora(lora, cfg_l, {k[5:]: v for k, v in inp.items()
                                                if k.startswith("lora_")}),
                   moe=dict(tokens=moe_ref, free=free), rms=_flat(rms))
    finally:
        _wait(procs, workdir)
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(ranks=ranks, ref=ref, workdir=workdir, host=_np_tree(lora), cfg_l=cfg_l)


def _serving(runs, case):
    """The case's two tp ranks' records (data coordinate 0 runs the engine
    and quant cases, 1 the spec and chat cases), checked equal."""
    first = 0 if case in ("engine", "quant") else 2
    a, b = runs["ranks"][first][case], runs["ranks"][first + 1][case]
    return a, b


def test_the_spawn_ran_on_the_mesh_within_its_budget(runs):
    ranks = runs["ranks"]
    assert [r["coords"] for r in ranks] == [{"data": d, "model": m} for d in (0, 1)
                                            for m in (0, 1)]
    assert max(r["seconds"]["total"] for r in ranks) < 60


@pytest.mark.parametrize("mode", sorted(W.ENGINE_MODES))
def test_tp_engine_tokens_and_schedule_equal_jax(runs, mode):
    a, b = _serving(runs, "engine")
    assert a[mode] == b[mode]
    assert a[mode] == runs["ref"]["engine"][mode]
    assert len(a[mode][0]) == len(W.ENGINE_MODES[mode][1])


def test_tp_engine_prefix_cache_chain_equals_jax(runs):
    a, b = _serving(runs, "engine")
    assert a["prefix"] == b["prefix"] == runs["ref"]["engine"]["prefix"]
    assert a["cache_heads"] == tconfig.tiny_test_vlm().decoder.num_kv_heads // 2


@pytest.mark.parametrize("mode", W.QUANT_MODES)
def test_tp_quantized_buffers_gather_to_jax_bit_for_bit(runs, mode):
    """Each rank holds its slice (half the column targets' dout, half the
    row targets' din: packed rows and int4 groups too); gathered, every
    buffer is JAX's quantized leaf."""
    a, b = _serving(runs, "quant")
    ref = runs["ref"]["quant"][mode]["tree"]
    got = a[mode]["buffers"]
    assert len(got) >= 29
    for name, t in got.items():
        assert torch.equal(t, b[mode]["buffers"][name]), name
        mname, leaf = ("decoder." + name).rsplit(".", 1)
        jleaf = {v: k for k, v in QUANT_NAMES.items()}.get(leaf, leaf)
        module = jax_path(mname + ".weight")[len("decoder/"):].rsplit("/", 1)[0]
        r = ref[f"{module}/{jleaf}"]
        layer = split_layer(mname + ".weight")[1]
        r = r if layer is None else r[layer]
        g = t.numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if r.dtype == np.int8:
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=0, err_msg=name)
    local = a[mode]["local"]
    key = "weight_q8" if mode == "int8" else "weight_q4p"
    assert local[f"blocks.0.o_proj.{key}"][0] * 2 == got[f"blocks.0.o_proj.{key}"].shape[0]
    assert local[f"blocks.0.q_proj.{key}"][1] * 2 == got[f"blocks.0.q_proj.{key}"].shape[1]
    if mode != "int8":
        assert local["blocks.0.down_proj.q4_scale"][0] == 1      # 2 groups of 128, one a rank


@pytest.mark.parametrize("mode", W.QUANT_MODES)
def test_tp_quantized_generator_tokens_equal_jax(runs, mode):
    for r in (0, 1):
        rank = runs["ranks"][r]["quant"]
        assert rank[mode]["tokens"] == runs["ref"]["quant"][mode]["tokens"][0:2]


def test_tp_calibration_is_the_slice_of_jax(runs):
    """decoder_act_rms on the tp decoder: the column targets' input RMS
    whole, the row targets' the rank's input channels (rtol 1e-5)."""
    for r in (0, 1):
        got = runs["ranks"][r]["quant"]["rms_tp"]
        for name, ref in runs["ref"]["rms"].items():
            ref = ref if name.split("/")[0] not in T.ROW_PARALLEL else np.split(ref, 2, -1)[r]
            np.testing.assert_allclose(got[name.split("/")[0]].numpy(), ref, rtol=1e-5,
                                       err_msg=name)


def test_from_jax_params_cuts_jax_int4_tree_into_the_ranks_slices(runs):
    a, _ = _serving(runs, "quant")
    loaded, ours = a["loaded_int4"], a["int4_local"]
    assert sorted(loaded) == sorted(ours)
    for n, t in loaded.items():
        if t.dtype == torch.int8:
            assert torch.equal(t, ours[n]), n
        else:
            np.testing.assert_allclose(t.numpy(), ours[n].numpy(), rtol=1e-6, err_msg=n)


@pytest.mark.parametrize("draft", ["tp", "whole"])
def test_tp_speculative_greedy_equals_jax(runs, draft):
    a, b = _serving(runs, "spec")
    ref = runs["ref"]["spec"]
    assert a[f"spec_{draft}"] == b[f"spec_{draft}"] == ref["spec"]
    assert a[f"spec_{draft}"][0] == a["greedy"] == ref["greedy"]


def test_tp_prompt_lookup_equals_jax(runs):
    a, b = _serving(runs, "spec")
    assert a["lookup"] == b["lookup"] == runs["ref"]["spec"]["lookup"]
    assert a["lookup"][1] > 0


def test_tp_speculative_sampling_warps_as_jax_and_draws_as_one_process(runs):
    a, b = _serving(runs, "spec")
    np.testing.assert_allclose(a["warped"].numpy(), runs["ref"]["spec"]["warped"], atol=1e-6)
    assert torch.equal(a["warped"], b["warped"])
    assert a["sampled_tp"] == b["sampled_tp"] == a["sampled_one"]
    assert len(a["sampled_tp"]) == W.SPEC_TOKENS


@pytest.mark.parametrize("beams", W.BEAMS)
def test_tp_beam_search_equals_jax(runs, beams):
    a, b = _serving(runs, "spec")
    tokens, score = runs["ref"]["spec"][f"beam{beams}"]
    assert a[f"beam{beams}"] == b[f"beam{beams}"]
    assert a[f"beam{beams}"][0] == list(tokens)
    np.testing.assert_allclose(a[f"beam{beams}"][1], float(score), rtol=1e-5)


@pytest.mark.parametrize("what", ["chat", "serve", "chat_w8", "session"])
def test_tp_chat_serve_and_session_strings_equal_jax(runs, what):
    a, b = _serving(runs, "chat")
    assert a[what] == b[what] == runs["ref"]["chat"][what]
    if what == "session":
        assert a["session_ids"] == runs["ref"]["chat"]["session_ids"]


@pytest.mark.parametrize("policy", W.LORA_POLICIES)
def test_tp_lora_stage_matches_jax_mesh_step(runs, policy):
    ref = runs["ref"]["lora"]
    lr2 = W.OPT["learning_rate"] / max(int(W.OPT["warmup_ratio"] * W.OPT["total_steps"]), 1)
    for rank in runs["ranks"]:
        got = rank["lora"][policy]
        for k, v in ref["met"].items():
            np.testing.assert_allclose(got["met"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        assert sorted(got["grads"]) == sorted(got["trainables"])
        assert any(n.startswith("lora.") for n in got["grads"])
        for n, g in got["grads"].items():
            r = _port_view(n, ref["grads"])
            np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * float(np.abs(r).max()) + 1e-12,
                                       rtol=1e-3, err_msg=n)
        for m_t, m_j in zip(got["metrics"], ref[policy]["metrics"]):
            for k in m_j:
                np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-5, atol=1e-7, err_msg=k)
        # Adam divides by |g|: where a gradient is at f32's rounding level
        # only the bound of one update holds (tests/test_torch_stages.py)
        for n, p in got["trainables"].items():
            g = got["grads"][n].abs().numpy()
            p, r = p.numpy(), _port_view(n, ref[policy]["params"])
            sure = (g == 0) | (g > 1e-5 * g.max())
            np.testing.assert_allclose(p[sure], r[sure], atol=2e-5, rtol=1e-4, err_msg=n)
            assert np.abs(p - r).max() <= 1.01 * lr2 + 2e-5, n


def test_tp_lora_factors_are_bit_identical_across_the_group(runs):
    ranks = runs["ranks"]
    for a, b in ((0, 1), (2, 3)):
        for policy in W.LORA_POLICIES:
            ta, tb = ranks[a]["lora"][policy]["trainables"], ranks[b]["lora"][policy]["trainables"]
            for n in ta:
                assert torch.equal(ta[n], tb[n]), (policy, n)
                assert torch.equal(ranks[a]["lora"][policy]["grads"][n],
                                   ranks[b]["lora"][policy]["grads"][n]), (policy, n)


def test_tp_lora_checkpoint_restores_in_one_process(runs):
    cfg = W.lora_config(tconfig)
    mgr = CheckpointManager(str(runs["workdir"] / "lora_ckpt"))
    assert mgr.steps() == [W.STEPS]
    step = tts.make_train_step(cfg, topt.OptimizerConfig(**W.OPT),
                               from_jax_params(runs["host"], cfg, device="cpu"))
    mgr.restore(step)
    saved, got = runs["ranks"][0]["lora"]["state"], step.state_tensors()
    assert step.step == W.STEPS and sorted(got) == sorted(saved)
    for k, v in saved.items():
        assert torch.equal(got[k].detach(), v), k


@pytest.mark.parametrize("policy", W.LORA_POLICIES)
def test_tp_lora_gradients_when_the_model_group_is_the_whole_world(runs, policy):
    """dp 1 x tp 4: the model group is the default process group; the
    stashed (save_qkv_mlp) and plain side paths give one process's
    gradients on every rank."""
    for rank in runs["ranks"]:
        grads = rank["lora_world"][policy]
        assert sorted(grads["tp4"]) == sorted(grads["one"])
        for n, g in grads["one"].items():
            np.testing.assert_allclose(grads["tp4"][n].numpy(), g.numpy(), rtol=1e-3,
                                       atol=1e-4 * float(g.abs().max()), err_msg=n)


def test_tp_lora_merge_is_the_slice_of_jax_merge(runs):
    ref = runs["ref"]["lora"]["merged"]
    for rank in runs["ranks"]:
        merged = rank["lora"]["merged"]
        assert any(n.endswith("o_proj.weight") for n in merged)
        for n, w in merged.items():
            np.testing.assert_allclose(w.numpy(), _port_view("decoder." + n, {
                "decoder/" + k: v for k, v in ref.items()}), rtol=1e-6, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("layout", ["dp2", "dp2_tp2"])
def test_moe_generator_under_dp_routes_over_the_global_batch(runs, layout):
    """C25: capacity binds (routes dropped over the global batch) and data
    rank 0's rows stop first; every data rank's rows are JAX's one-device
    Generator's over all four."""
    ref = runs["ref"]["moe"]["tokens"]
    for r, rank in enumerate(runs["ranks"]):
        d = rank["coords"]["data"]
        assert rank["moe"][layout]["tokens"] == ref[2 * d:2 * d + 2], (r, layout)
    assert max(len(t) for t in ref[:2]) < min(len(t) for t in ref[2:])
    assert runs["ranks"][0]["moe"]["dp2"]["dropped"] > 0
    # routing over the rank's own rows (no data group) gives other tokens
    assert any(rank["moe"]["dp2"]["local_tokens"] != rank["moe"]["dp2"]["tokens"]
               for rank in runs["ranks"])


def test_c28_int4_groups_may_not_straddle_two_ranks():
    """tiny_test_vlm's o_proj (din 64, one group of 64) cannot split over two
    ranks: cutting JAX's int4 tree and quantizing a tp decoder both raise."""
    cfg_j, cfg_t = jconfig.tiny_test_vlm(), tconfig.tiny_test_vlm()
    params = j_init_vlm(jax.random.PRNGKey(0), cfg_j)
    qtree = _np_tree({**params, "decoder": jparam.quantize_linear_weights_int4(params["decoder"])})
    group = T.TensorParallel(None, 0, 2)
    with pytest.raises(ValueError, match="C28"):
        from_jax_params(qtree, cfg_t, device="cpu", tp=group)
    from visper_lm_tpu_torch.models.decoder import Decoder, quantize_decoder

    with torch.device("meta"):
        dec = T.shard_model(Decoder(cfg_t.decoder), group)
    with pytest.raises(ValueError, match="C28"):
        quantize_decoder(dec, "int4")
