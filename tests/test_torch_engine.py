"""The continuous-batching Engine, port vs the JAX package on the CPU.

tiny_test_vlm(distill=True) with the JAX init_vlm weights carried over by
`weights.from_jax_params` (f32), and both engines' default bf16 KV cache; the
fixture's five multimodal prompts of tests/test_engine.py (prompt lengths
across a bucket boundary). For every mode the port's greedy tokens must be
identical to JAX's `Engine` on the same requests, and the scheduling counts
(engine steps, prefills, admission dispatches, group admissions, slot steps,
speculative proposals and acceptances) equal: plain (decode quantum 8), the
int8 cache, int8 cache + w8a16 weights, decode quantum 1, host-driven `spec_k`, `spec_quantum`, chunked
prefill, grouped admission and its compatibility rule, hysteresis, prefix
caching and handle chains, harvest, eos retirement, stop strings, and the
speculative fallback near capacity. The port's own properties: one host sync
per quantum, chunk advances interleaved with decode, the device history row.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from visper_lm_tpu import config as jconfig
from visper_lm_tpu.data.collate import build_splice_plan as j_build_splice_plan
from visper_lm_tpu.data.collate import pad_to_bucket as j_pad_to_bucket
from visper_lm_tpu.models.vlm import init_vlm as j_init_vlm
from visper_lm_tpu.serve import engine as jeng
from visper_lm_tpu.serve.generate import right_pad_plans as j_right_pad_plans

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.constants import IMAGE_TOKEN_INDEX, SEG_TEXT
from visper_lm_tpu_torch.data.collate import build_splice_plan, pad_to_bucket
from visper_lm_tpu_torch.serve import engine as teng
from visper_lm_tpu_torch.serve.generate import right_pad_plans
from visper_lm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

PKGS = {"jax": (jeng, j_build_splice_plan), "torch": (teng, build_splice_plan)}


@pytest.fixture(scope="module")
def setup():
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    params = j_init_vlm(jax.random.PRNGKey(7), cfg_j)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    rng = np.random.default_rng(42)
    ids, images = [], []
    for extra in [5, 40, 90, 130, 17]:
        ids.append([1, 2, 3, IMAGE_TOKEN_INDEX] + rng.integers(4, 400, size=extra).tolist())
        images.append(rng.normal(size=(1, 28, 28, 3)).astype(np.float32))
    return dict(jax=(params, cfg_j), torch=(model, cfg_t), ids=ids, images=images)


def _plan(pkg, cfg, ids, max_len=256):
    return PKGS[pkg][1](ids, None, max_len, num_image_tokens=cfg.num_image_tokens,
                        num_task_tokens=cfg.distill.num_task_tokens, num_tasks=3)


def _engine(setup, pkg, **kw):
    kw.setdefault("max_len", 512)
    weights, cfg = setup[pkg]
    mod = PKGS[pkg][0]
    extra = {"device": "cpu"} if pkg == "torch" else {}
    tokenizer = kw.pop("tokenizer", None)
    return mod.Engine(weights, cfg, mod.EngineConfig(**kw), tokenizer, **extra)


def _requests(setup, pkg, max_news, order=None, **kw):
    mod = PKGS[pkg][0]
    cfg = setup[pkg][1]
    order = order or list(range(len(max_news)))
    return [mod.Request(plan=_plan(pkg, cfg, setup["ids"][j]), images=setup["images"][j],
                        max_new_tokens=mn, uid=i, **kw)
            for i, (j, mn) in enumerate(zip(order, max_news))]


def _serve(setup, pkg, max_news, order=None, req_kw=None, **kw):
    eng = _engine(setup, pkg, **kw)
    done = eng.run(_requests(setup, pkg, max_news, order, **(req_kw or {})))
    return eng, {r.uid: r.output_ids for r in done}


STATS = ("steps", "decoded_tokens", "slot_steps", "prefills", "spec_proposed",
         "spec_accepted", "group_admissions", "admit_dispatches")

# name -> (EngineConfig kwargs, max_new_tokens per request, request order)
MODES = {
    "plain": (dict(num_slots=2), [6, 9, 4, 7, 5], None),
    "kv_quant": (dict(num_slots=2, kv_quant=True), [6, 9, 4, 7, 5], None),
    "w8a16": (dict(num_slots=2, kv_quant=True, weight_quant=True), [6, 9, 4, 7, 5], None),
    "quantum_1": (dict(num_slots=2, decode_quantum=1), [6, 9, 4, 7, 5], None),
    "spec_k": (dict(num_slots=2, spec_k=4, spec_ngram=3), [8, 6, 10, 7, 6], None),
    "spec_quantum": (dict(num_slots=2, spec_k=4, spec_ngram=3, spec_quantum=3),
                     [8, 6, 10, 7, 6], None),
    "chunked_prefill": (dict(num_slots=2, prefill_chunk=64, prompt_bucket=64),
                        [5, 4, 6, 5, 4], None),
    "grouped": (dict(num_slots=4), [6, 5, 8, 4, 7], None),
    "ungrouped": (dict(num_slots=4, admit_group=1), [6, 5, 8, 4, 7], None),
    "grouped_spec_quantum": (dict(num_slots=4, spec_k=4, spec_ngram=3, spec_quantum=2),
                             [6, 5, 8, 4, 7], None),
    # staggered retirements: quantum 2 retires one slot per step
    "hysteresis": (dict(num_slots=4, decode_quantum=2, admit_defer=4),
                   [2, 4, 6, 8] + [3] * 8, [i % 4 for i in range(12)]),
    "eager_admission": (dict(num_slots=4, decode_quantum=2, admit_defer=0),
                        [2, 4, 6, 8] + [3] * 8, [i % 4 for i in range(12)]),
}


@pytest.fixture(scope="module")
def served(setup):
    """Each mode served by both packages: {mode: {pkg: (engine, tokens)}}."""
    return {name: {pkg: _serve(setup, pkg, mn, order, **kw) for pkg in PKGS}
            for name, (kw, mn, order) in MODES.items()}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_tokens_and_schedule_match_jax(served, mode):
    (e_j, ref), (e_t, got) = served[mode]["jax"], served[mode]["torch"]
    assert got == ref
    assert len(got) == len(MODES[mode][1])
    assert {k: e_t.stats[k] for k in STATS} == {k: e_j.stats.get(k, 0) for k in STATS}
    assert all(r is None for r in e_t.slot_req) and not e_t.queue


def test_modes_are_what_they_claim(served):
    """The counts that make each mode what it is (JAX's test_engine checks)."""
    s = {m: served[m]["torch"][0].stats for m in MODES}
    tokens = {m: served[m]["torch"][1] for m in MODES}
    assert s["plain"]["steps"] < sum(MODES["plain"][1]) and s["plain"]["prefills"] == 5
    assert tokens["quantum_1"] == tokens["plain"]
    assert s["plain"]["steps"] * 3 < s["quantum_1"]["steps"]
    assert s["spec_k"]["spec_accepted"] > 0
    assert s["spec_k"]["steps"] < s["spec_k"]["decoded_tokens"]
    assert s["spec_quantum"]["steps"] < s["spec_k"]["steps"]
    assert tokens["grouped"] == tokens["ungrouped"] == tokens["grouped_spec_quantum"]
    assert s["grouped"]["group_admissions"] >= 1 and s["ungrouped"]["group_admissions"] == 0
    assert tokens["hysteresis"] == tokens["eager_admission"]
    assert s["hysteresis"]["admit_dispatches"] < s["eager_admission"]["admit_dispatches"]
    assert s["hysteresis"]["prefills"] == s["eager_admission"]["prefills"]


def test_one_host_sync_per_quantum(served):
    """Without speculation and above quantum 1, admission reads nothing back:
    the engine syncs once per step (its quantum)."""
    for mode in ("plain", "kv_quant", "grouped", "hysteresis", "chunked_prefill"):
        st = served[mode]["torch"][0].stats
        assert st["host_syncs"] == st["steps"], (mode, st)


def test_prefix_caching_and_chains_match_jax(setup):
    rng = np.random.default_rng(9)
    prefix_ids = [1, 2, 3, IMAGE_TOKEN_INDEX] + rng.integers(4, 400, size=21).tolist()
    image = rng.normal(size=(1, 28, 28, 3)).astype(np.float32)
    suffixes = [rng.integers(4, 400, size=n).tolist() for n in (7, 33, 150)]
    turn2 = rng.integers(4, 400, size=14).tolist()
    got = {}
    for pkg in PKGS:
        mod, cfg = PKGS[pkg][0], setup[pkg][1]
        eng = _engine(setup, pkg, num_slots=2)
        handle = eng.prefill_prefix(_plan(pkg, cfg, prefix_ids, 128), images=image)
        h2 = eng.prefill_prefix(_plan(pkg, cfg, turn2, 64), prefix=handle)
        reqs = [mod.Request(plan=_plan(pkg, cfg, s), prefix=h, max_new_tokens=6, uid=(i, j))
                for i, s in enumerate(suffixes) for j, h in enumerate((handle, h2))]
        done = eng.run(reqs)
        got[pkg] = ({r.uid: r.output_ids for r in done}, eng.stats["prefills"])
    assert got["torch"] == got["jax"]
    # a handle's suffix decodes as a full-prompt prefill of prefix + suffix
    eng = _engine(setup, "torch", num_slots=1)
    plan = _plan("torch", setup["torch"][1], prefix_ids + suffixes[0])
    whole = eng.run([teng.Request(plan=plan, images=image, max_new_tokens=6, uid=0)])
    assert whole[0].output_ids == got["torch"][0][(0, 0)]


def test_harvest_matches_jax(setup):
    cont = [7, 8, 9]
    got = {}
    for pkg in PKGS:
        mod, cfg = PKGS[pkg][0], setup[pkg][1]
        eng = _engine(setup, pkg, num_slots=1)
        done = eng.run(_requests(setup, pkg, [6], order=[1]))[0]
        handle = eng.harvest(done)
        ids = [done.output_ids[-1]] + cont
        plan = _plan(pkg, cfg, ids, 64)
        plan = dataclasses.replace(plan, **{f: getattr(plan, f)[: len(ids)] for f in
                                            ("text_ids", "token_type", "src_index", "labels")},
                                   seq_length=len(ids))
        again = eng.run([mod.Request(plan=plan, prefix=handle, max_new_tokens=5, uid=1)])
        got[pkg] = (done.output_ids, done.final_kv_len, again[0].output_ids)
        # the slot is refilled: the handle's K/V is gone
        eng.run(_requests(setup, pkg, [2], order=[0]))
        assert eng.harvest(done) is None
    assert got["torch"] == got["jax"]


def test_eos_retires_and_recycles_the_slot_like_jax(setup):
    first = _serve(setup, "torch", [1], num_slots=1)[1][0][0]
    got = {}
    for pkg in PKGS:
        mod, cfg = PKGS[pkg][0], setup[pkg][1]
        eng = _engine(setup, pkg, num_slots=1)
        reqs = [mod.Request(plan=_plan(pkg, cfg, setup["ids"][0]), images=setup["images"][0],
                            max_new_tokens=8, eos_token_ids=(first,), uid="a"),
                mod.Request(plan=_plan(pkg, cfg, setup["ids"][1]), images=setup["images"][1],
                            max_new_tokens=3, uid="b")]
        got[pkg] = {r.uid: r.output_ids for r in eng.run(reqs)}
    assert got["torch"] == got["jax"]
    assert got["torch"]["a"] == [first] and len(got["torch"]["b"]) == 3


class _LetterTokenizer:
    """Token id -> one letter; enough for stop strings."""

    def decode(self, ids, skip_special_tokens=False):
        return "".join(chr(97 + i % 26) for i in ids)


def test_stop_strings_and_decode_texts_match_jax(setup, served):
    tok = _LetterTokenizer()
    stop = tok.decode(served["plain"]["torch"][1][1][2:4])
    got = {}
    for pkg in PKGS:
        eng = _engine(setup, pkg, num_slots=2, tokenizer=tok)
        reqs = _requests(setup, pkg, [6, 9, 4], stop_strings=(stop,))
        done = eng.run(reqs)
        got[pkg] = ({r.uid: r.output_ids for r in done}, eng.decode_texts(done))
    assert got["torch"] == got["jax"]
    assert stop not in got["torch"][1][1]


def test_text_only_requests_never_join_an_image_group(setup):
    """image / text / image / image admits as [img], [text], [img, img]."""
    got = {}
    for pkg in PKGS:
        mod, cfg = PKGS[pkg][0], setup[pkg][1]
        text = mod.Request(plan=_plan(pkg, cfg, [1, 5, 9, 11]), max_new_tokens=4, uid=1)
        imgs = _requests(setup, pkg, [4, 4, 4], order=[0, 1, 4])
        for r, uid in zip(imgs, (0, 2, 3)):
            r.uid = uid
        eng = _engine(setup, pkg, num_slots=4)
        done = eng.run([imgs[0], text, imgs[1], imgs[2]])
        got[pkg] = ({r.uid: r.output_ids for r in done}, eng.stats["group_admissions"])
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == 1 and all(len(v) == 4 for v in got["torch"][0].values())


def test_speculation_falls_back_near_capacity_like_jax(setup):
    kw = dict(num_slots=1, max_len=256)
    ref = _serve(setup, "jax", [200], order=[3], spec_k=4, **kw)[1]
    got = _serve(setup, "torch", [200], order=[3], spec_k=4, **kw)[1]
    plain = _serve(setup, "torch", [200], order=[3], **kw)[1]
    assert got == ref == plain


def test_chunk_advances_interleave_with_decode(setup, served):
    """One chunk advance (or the final fill) per engine step, each beside one
    decode token of the in-flight slot; the long request's tokens are the
    single-shot engine's."""
    eng = _engine(setup, "torch", num_slots=2, prefill_chunk=64, prompt_bucket=64,
                  decode_quantum=1)
    short, long_ = _requests(setup, "torch", [64, 4], order=[0, 3])
    eng.submit(short)
    eng.step()
    cfg = setup["torch"][1]
    n_chunks = (_plan("torch", cfg, setup["ids"][3]).seq_length - 1) // 64
    assert n_chunks >= 2
    eng.submit(long_)
    deltas = []
    while long_ in eng.queue:
        before = len(short.output_ids)
        eng.step()
        deltas.append(len(short.output_ids) - before)
    assert len(deltas) == n_chunks + 1 and all(d == 1 for d in deltas), deltas
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng.step()
    single = _serve(setup, "torch", [4], order=[3], num_slots=1)[1][0]
    assert long_.output_ids == single


def test_spec_history_row_holds_the_whole_chunked_prompt(setup):
    eng = _engine(setup, "torch", num_slots=1, prefill_chunk=64, prompt_bucket=64,
                  spec_k=4, spec_ngram=3, spec_quantum=2)
    (req,) = _requests(setup, "torch", [4], order=[3])
    eng.submit(req)
    for _ in range(32):
        if int(eng.hist_len[0]) > 0:
            break
        eng.step()
    plan = _plan("torch", setup["torch"][1], setup["ids"][3])
    tt = np.asarray(plan.token_type)[: plan.seq_length]
    ids = np.asarray(plan.text_ids)[: plan.seq_length][tt == SEG_TEXT]
    assert int(eng.hist_len[0]) >= len(ids) + 1
    np.testing.assert_array_equal(eng.hist[0, : len(ids)].numpy(), ids)


def test_engine_needs_a_device_and_greedy_speculation(setup, monkeypatch):
    model, cfg = setup["torch"]
    with pytest.raises(ValueError, match="greedy-only"):
        teng.Engine(model, cfg, teng.EngineConfig(spec_k=2, temperature=0.5), device="cpu")
    eng = teng.Engine(model, cfg, teng.EngineConfig(num_slots=2, max_len=256, weight_quant=True),
                      device="cpu")
    assert eng.decoder is not model.decoder
    assert isinstance(model.decoder.blocks[0].q_proj, torch.nn.Linear)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teng.Engine(model, cfg, teng.EngineConfig())


def test_right_pad_plans_and_pad_to_bucket_match_jax(setup):
    plans = {pkg: [_plan(pkg, setup[pkg][1], ids) for ids in setup["ids"]] for pkg in PKGS}
    ref = j_right_pad_plans(plans["jax"], 256)
    got = right_pad_plans(plans["torch"], 256)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    for n in (1, 63, 64, 65, 200, 999):
        assert pad_to_bucket(n, (256, 64, 128)) == j_pad_to_bucket(n, (256, 64, 128))
