"""The evaluation slice's model side (visper_lm_tpu_torch/eval) vs the JAX
package's on the CPU.

tiny_test_vlm(distill=True) with JAX's init_vlm weights carried over (f32,
`weights.from_jax_params`) and test_lmms_adapter.py's fake tokenizer, both
frameworks in one process (its ids follow Python's string hash, ROADMAP C2).
Images are seeded uint8 arrays (PIL images of the same arrays on the JAX
side). Held:
  * `VisperLmms.generate_until` answers identical to JAX's (greedy, f32), and
    a failing chat answers "" in both while the port keeps the failure;
  * `loglikelihood` sums at rtol 1e-4 with equal greedy flags, and
    `loglikelihood_rolling` sums at rtol 1e-4 (f32 log-softmax of f32 logits
    through two framework's decoders: the sums differ in the last digits);
  * `evaluate` / `simple_evaluate` result dicts equal to JAX's on
    test_harness.py's tasks, `run_cvbench` / `run_mmstar` equal;
  * `validate.main`'s report equal to JAX's on test_validate.py's dress
    rehearsal (scores and answer files; the parity gate's own diff at the
    gate's tolerance), and the gate without transformers as JAX's;
  * `run_probe_cos_sim` layer scores within 1e-5 of JAX's, and
    `render_gen_predictions`' PNGs equal to JAX's (PIL's LANCZOS + save) for
    the same generated images.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from visper_lm_tpu import api as japi
from visper_lm_tpu import config as jconfig
from visper_lm_tpu.eval import cvbench as jcv
from visper_lm_tpu.eval import harness as jh
from visper_lm_tpu.eval import lmms_adapter as jla
from visper_lm_tpu.eval import mmstar as jmm
from visper_lm_tpu.eval import probe as jprobe
from visper_lm_tpu.models.vlm import init_vlm as j_init_vlm

from visper_lm_tpu_torch import api as tapi
from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.data.image_io import read_png, write_png
from visper_lm_tpu_torch.eval import cvbench as tcv
from visper_lm_tpu_torch.eval import harness as th
from visper_lm_tpu_torch.eval import lmms_adapter as tla
from visper_lm_tpu_torch.eval import mmstar as tmm
from visper_lm_tpu_torch.eval import probe as tprobe
from visper_lm_tpu_torch.weights import from_jax_params

from test_data_pipeline import FakeTokenizer

torch.set_num_threads(2)
RTOL = 1e-4


class FakeTok(FakeTokenizer):
    eos_token_id = 2


@pytest.fixture(scope="module")
def models():
    cfg_j = jconfig.tiny_test_vlm(distill=True)
    cfg_t = tconfig.tiny_test_vlm(distill=True)
    params = j_init_vlm(jax.random.PRNGKey(0), cfg_j)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, params), cfg_t, device="cpu")
    tok = FakeTok()
    return (japi.VisperModel(cfg=cfg_j, params=params, tokenizer=tok, context_len=256),
            tapi.VisperModel(cfg=cfg_t, model=model, tokenizer=tok, context_len=256))


def _images(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]


class Instance:
    def __init__(self, args):
        self.args = args


def _requests(imgs, contexts, gen_or_cont):
    """Harness requests over `imgs`: the JAX side's visuals are PIL images of
    the port side's arrays."""
    def make(pil):
        return [Instance((c, g, (lambda _, im=im: [Image.fromarray(im) if pil else im]), i, "t", "val"))
                for i, (c, g, im) in enumerate(zip(contexts, gen_or_cont, imgs))]
    return make(True), make(False)


def test_generate_until_answers_equal_jax(models):
    jm, tm = models
    imgs = _images([(32, 32), (40, 24), (57, 21), (16, 48), (30, 30)])
    contexts = ["what is this?", "count the objects in the picture", "short",
                "which one is larger, the left or the right?", "colour"]
    gen = [{"max_new_tokens": 4}] * len(contexts)
    jreq, treq = _requests(imgs, contexts, gen)
    jl = jla.VisperLmms(jm, batch_size=2, max_new_tokens=4)
    tl = tla.VisperLmms(tm, batch_size=2, max_new_tokens=4)
    ref = jl.generate_until(jreq)
    out = tl.generate_until(treq)
    assert out == ref
    assert tl.errors == [] and all(len(t.split()) == 4 for t in out)


def test_generate_until_keeps_what_it_catches(models):
    """A chunk whose chat raises answers "" (JAX's behaviour) and the port
    keeps the failure in `errors`."""
    jm, tm = models

    class Failing:
        def __init__(self, inner):
            self.inner = inner

        def chat(self, questions, images, **kw):
            if len(questions) == 1:
                raise RuntimeError("kernel launch failed")
            return self.inner.chat(questions, images, **kw)

    imgs = _images([(32, 32)] * 3, seed=4)
    contexts = ["a b c", "d e", "f"]
    jreq, treq = _requests(imgs, contexts, [{"max_new_tokens": 3}] * 3)
    jl = jla.VisperLmms(Failing(jm), batch_size=2)
    tl = tla.VisperLmms(Failing(tm), batch_size=2)
    ref = jl.generate_until(jreq)
    out = tl.generate_until(treq)
    assert out == ref and out[2] == "" and out[0] != ""
    assert tl.errors == [(1, "RuntimeError('kernel launch failed')")]


def test_loglikelihood_equal_jax(models):
    jm, tm = models
    imgs = _images([(32, 32), (32, 32), (50, 20), (20, 50)], seed=1)
    contexts = ["is it red?", "is it red?", "what is the shape", "how many"]
    conts = [" yes", " absolutely positively maybe", " a round thing", " 3"]
    jreq, treq = _requests(imgs, contexts, conts)
    ref = jla.VisperLmms(jm).loglikelihood(jreq)
    tl = tla.VisperLmms(tm)
    out = tl.loglikelihood(treq)
    assert len(out) == len(ref) == 4
    for (lp, greedy), (rlp, rgreedy) in zip(out, ref):
        assert isinstance(greedy, bool) and greedy == rgreedy
        np.testing.assert_allclose(lp, rlp, rtol=RTOL)
    assert out[1][0] < out[0][0]
    per_token = tl.continuation_logprobs(treq)
    assert [len(lps) for lps, _ in per_token] == [1, 3, 3, 1]
    assert [float(np.sum(lps.astype(np.float32))) for lps, _ in per_token] == [lp for lp, _ in out]


def test_loglikelihood_rolling_equal_jax(models):
    jm, tm = models
    reqs = [jh.Instance(args=("hello there friend",)), jh.Instance(args=("hi",)),
            jh.Instance(args=(" ".join(f"w{i}" for i in range(150)),))]
    ref = jla.VisperLmms(jm).loglikelihood_rolling(reqs)
    out = tla.VisperLmms(tm).loglikelihood_rolling(
        [th.Instance(args=r.args) for r in reqs])
    np.testing.assert_allclose(out, ref, rtol=RTOL)
    assert all(np.isfinite(s) and s <= 0 for s in out)


def _harness_docs(pil):
    img = _images([(16, 16), (32, 32)], seed=2)
    im = [Image.fromarray(a) if pil else a for a in img]
    rw = [{"question": "What?\nA. cat\nB. dog", "answer": "a", "image": im[0]},
          {"question": "Pick.\nA. one\nB. two", "answer": "B", "image": im[1]}]
    ok = [{"question": "What is it?", "answers": ["thing"] * 10, "image": im[0],
           "question_id": 1}]
    cv = [{"image": im[1], "question": "Which is closer?\n(A) car (B) bus",
           "answer": "(A)", "task": "Depth", "source": "ADE20K"},
          {"image": im[1], "question": "How many?\n(A) 1 (B) 2",
           "answer": "(B)", "task": "Count", "source": "Omni3D"}]
    mm = [{"image": im[0], "question": "What is shown?\nA. cat\nB. dog",
           "answer": "A", "category": "coarse perception",
           "l2_category": "image scene and topic"}]
    return rw, ok, cv, mm


def test_simple_evaluate_equal_jax(models):
    jm, tm = models
    jrw, jok, jcvd, jmmd = _harness_docs(True)
    trw, tok, tcvd, tmmd = _harness_docs(False)
    ref = jh.simple_evaluate(jm, [jh.realworldqa_task(jrw), jh.ok_vqa_task(jok),
                                  jh.cvbench_task(jcvd), jh.mmstar_task(jmmd)], batch_size=2)
    out = th.simple_evaluate(tm, [th.realworldqa_task(trw), th.ok_vqa_task(tok),
                                  th.cvbench_task(tcvd), th.mmstar_task(tmmd)], batch_size=2)
    assert out == ref
    assert set(out["results"]) == {"realworldqa", "ok_vqa_val2014", "cvbench", "mmstar"}
    assert th.cvbench_overall(out["results"]["cvbench"]) == jh.cvbench_overall(ref["results"]["cvbench"])


def test_evaluate_through_the_adapter_and_image_paths(models, tmp_path):
    """evaluate() with the port's VisperLmms on docs whose images are PNG
    paths (read by image_io, PIL on the JAX side) equals JAX's."""
    jm, tm = models
    _, _, cv, mm = _harness_docs(False)
    for i, d in enumerate(cv + mm):
        path = str(tmp_path / f"im{i}.png")
        write_png(path, d["image"])
        d["image"] = path
    ref = jh.evaluate(jla.VisperLmms(jm, batch_size=2), [jh.cvbench_task(cv), jh.mmstar_task(mm)])
    lm = tla.VisperLmms(tm, batch_size=2)
    out = th.evaluate(lm, [th.cvbench_task(cv), th.mmstar_task(mm)])
    assert out == ref and lm.errors == []


def _benchmark_records(root, n=5, seed=3):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    cv, mm = [], []
    sources = ["ADE20K", "COCO", "Omni3D"]
    for i in range(n):
        path = os.path.join(root, f"r{i}.png")
        write_png(path, rng.integers(0, 256, (20 + 7 * i, 36 - 3 * i, 3), dtype=np.uint8))
        cv.append({"image": path, "question": f"q{i} which? (A) x (B) y" + tcv.PROMPT_SUFFIX,
                   "answer": "(A)", "task": "Count", "source": sources[i % 3]})
        mm.append({"image": path, "question": f"pick {i}\nA. x\nB. y" + tmm.PROMPT_SUFFIX,
                   "answer": "B", "category": "math", "l2_category": "geometry"})
    return cv, mm


def test_run_cvbench_and_mmstar_equal_jax(models, tmp_path):
    jm, tm = models
    cv, mm = _benchmark_records(str(tmp_path / "data"))
    for name, jrun, trun, data in (("cv", jcv.run_cvbench, tcv.run_cvbench, cv),
                                   ("mm", jmm.run_mmstar, tmm.run_mmstar, mm)):
        jp, tp = str(tmp_path / f"{name}_j.jsonl"), str(tmp_path / f"{name}_t.jsonl")
        ref = jrun(jm, data, batch_size=2, max_new_tokens=3, output_path=jp)
        out = trun(tm, data, batch_size=2, max_new_tokens=3, output_path=tp)
        assert out == ref
        assert open(tp).read() == open(jp).read()


def test_validate_dress_rehearsal_equal_jax(tmp_path):
    """test_validate.py's dress rehearsal through both CLIs: the same HF
    checkpoint (the JAX package's export), tokenizer and data. The port runs
    on the CPU (`--device cpu`); both load the weights in bf16."""
    from visper_lm_tpu.checkpoint.hf_export import save_hf_checkpoint
    from visper_lm_tpu.eval import validate as jv

    from visper_lm_tpu_torch.eval import validate as tv

    from test_validate import _tiny_tokenizer, _write_cvbench, _write_mmstar

    cfg = jconfig.tiny_test_vlm(distill=True)
    ckpt = str(tmp_path / "ckpt")
    save_hf_checkpoint(ckpt, j_init_vlm(jax.random.PRNGKey(0), cfg), cfg)
    _tiny_tokenizer(ckpt)
    _write_cvbench(str(tmp_path / "cvbench"))
    mmstar_jsonl = _write_mmstar(str(tmp_path / "mmstar"))
    reports = {}
    for name, mod, extra in (("jax", jv, []), ("port", tv, ["--device", "cpu"])):
        out = str(tmp_path / name / "scores.json")
        rc = mod.main([
            "--ckpt", ckpt, "--tasks", "cvbench,mmstar",
            "--cvbench-path", str(tmp_path / "cvbench"), "--mmstar-path", mmstar_jsonl,
            "--batch-size", "2", "--max-new-tokens", "4", "--hf-parity", "require",
            "--out", out, *extra])
        assert rc == 0
        with open(out) as f:
            reports[name] = json.load(f)
    ref, got = reports["jax"], reports["port"]
    assert sorted(got) == sorted(ref) == ["checkpoint", "cvbench", "logit_parity", "mmstar"]
    assert got["checkpoint"] == ref["checkpoint"]
    assert got["cvbench"] == ref["cvbench"] and got["mmstar"] == ref["mmstar"]
    # the gate ran on both sides against the same torch model
    assert got["logit_parity"]["logit_scale"] == ref["logit_parity"]["logit_scale"]
    assert got["logit_parity"]["max_abs_diff"] <= 0.12 * max(got["logit_parity"]["logit_scale"], 1)
    for task in ("cvbench", "mmstar"):
        with open(tmp_path / "port" / f"{task}_answers.jsonl") as f:
            got_answers = f.read()
        with open(tmp_path / "jax" / f"{task}_answers.jsonl") as f:
            assert got_answers == f.read()


@pytest.mark.parametrize("mode", ["auto", "require", "off"])
def test_parity_gate_without_transformers_as_jax(mode, monkeypatch, capsys):
    """Where transformers cannot be imported, "auto" prints its skip and
    returns None, "require" raises and "off" does nothing, in both packages."""
    from visper_lm_tpu.eval import validate as jv

    from visper_lm_tpu_torch.eval import validate as tv

    monkeypatch.setitem(sys.modules, "transformers", None)
    for mod in (jv, tv):
        if mode == "require":
            with pytest.raises(ImportError):
                mod.logit_parity_gate(None, "no_checkpoint", mode=mode)
        else:
            assert mod.logit_parity_gate(None, "no_checkpoint", mode=mode) is None
            assert ("parity gate skipped" in capsys.readouterr().err) == (mode == "auto")


def test_run_probe_cos_sim_equal_jax(models, tmp_path):
    jm, tm = models
    rng = np.random.default_rng(5)
    examples = []
    for i in range(2):
        path = str(tmp_path / f"p{i}.png")
        write_png(path, rng.integers(0, 256, (40, 30 + 10 * i, 3), dtype=np.uint8))
        examples.append({"image": path, "question": f"what is in picture {i}?"})
    d = tm.cfg.distill
    targets = {t.task: rng.standard_normal((1, t.head.num_tokens, t.head.output_dim)).astype(np.float32)
               for t in d.tasks}
    ref = jprobe.run_probe_cos_sim(jm, examples, lambda im: targets)
    seen = []
    out = tprobe.run_probe_cos_sim(tm, examples, lambda im: seen.append(im.shape) or targets,
                                   output_path=str(tmp_path / "scores.json"))
    assert seen == [(40, 30, 3), (40, 40, 3)]
    assert sorted(out) == sorted(ref) == sorted(targets)
    for task in ref:
        assert sorted(out[task]) == sorted(ref[task])
        np.testing.assert_allclose([out[task][k] for k in sorted(out[task])],
                                   [ref[task][k] for k in sorted(ref[task])], atol=1e-5)
    with open(tmp_path / "scores.json") as f:
        assert sorted(json.load(f)) == sorted(out)


def test_render_gen_predictions_equal_jax(models, tmp_path, monkeypatch):
    """The per-layer PNGs equal JAX's (PIL's LANCZOS to 256 and PNG) for the
    same generated images: both pipelines are replaced by one that returns
    a fixed image per embedding, so what is held is everything around it."""
    import visper_lm_tpu.models.genpipe as jgen

    import visper_lm_tpu_torch.models.genpipe as tgen

    jm, tm = models
    path = str(tmp_path / "in.png")
    write_png(path, _images([(40, 40)], seed=6)[0])
    examples = [{"image": path, "question": "what is it?"}]

    def fake(_pipe, _cfg, emb, **kw):
        rng = np.random.default_rng(int(abs(np.asarray(emb).sum()) * 1e3) % 2**32)
        return rng.uniform(0, 1, (1, 96, 80, 3)).astype(np.float32)

    monkeypatch.setattr(jgen, "generate_from_embeds", fake)
    monkeypatch.setattr(tgen, "generate_from_embeds", fake)
    ref = jprobe.render_gen_predictions(jm, examples, None, None, str(tmp_path / "jax"),
                                        num_inference_steps=2)
    out = tprobe.render_gen_predictions(tm, examples, None, None, str(tmp_path / "port"),
                                        num_inference_steps=2)
    assert [os.path.relpath(p, tmp_path / "port") for p in out] == \
        [os.path.relpath(p, tmp_path / "jax") for p in ref]
    assert len(out) == len(tm.cfg.distill.get_task("gen").layer_indices)
    for p, r in zip(out, ref):
        got = read_png(p)
        assert got.shape == (256, 256, 3)
        np.testing.assert_array_equal(got, np.asarray(Image.open(r).convert("RGB")))


def test_render_gen_predictions_through_the_tiny_pipeline(models, tmp_path):
    """The port's own unCLIP pipeline at a CPU size: one PNG per gen layer."""
    from visper_lm_tpu_torch.models import genpipe

    _, tm = models
    g = genpipe.tiny_genpipe_config()
    out_dim = tm.cfg.distill.get_task("gen").head.output_dim
    g = dataclasses.replace(g, embed_dim=out_dim, unet=dataclasses.replace(
        g.unet, projection_class_embeddings_input_dim=2 * out_dim))
    pipe = genpipe.init_genpipe(g, device="cpu", seed=0)
    path = str(tmp_path / "in.png")
    write_png(path, _images([(24, 24)], seed=7)[0])
    paths = tprobe.render_gen_predictions(tm, [{"image": path, "question": "q"}], pipe, g,
                                          str(tmp_path / "out"), num_inference_steps=2,
                                          image_size=32)
    assert len(paths) == len(tm.cfg.distill.get_task("gen").layer_indices)
    for p in paths:
        img = read_png(p)
        assert img.shape == (32, 32, 3) and img.dtype == np.uint8
