"""The evaluation slice's host side (visper_lm_tpu_torch/eval) vs the JAX
package's: every scorer, filter, prompt builder, `*_process_results` and
`*_aggregate_*` held EQUAL to its JAX twin (the host modules are copies),
one parametrised test per module, on the inputs of the JAX package's own
spec tests (test_eval_scorers.py, test_harness.py, test_lmms_tasks.py,
test_fork_tail_tasks.py, test_caption_metrics.py). Every task of
`lmms_tasks.task_builders()` also runs through both harnesses' `evaluate`
with scripted answers: the prompts, generation kwargs, visuals (the port
returns arrays where JAX returns PIL images: compared as arrays) and result
dicts must be equal. Functions that draw from Python's `random` are called
after the same `random.seed` on both sides.

The Pillow-exact paths of this slice are held against PIL itself: the
Lanczos resize (`data.mm_utils.resize_lanczos`) and the numpy rectangle of
the grounding visuals (`eval.grounding_tasks.draw_rectangle`), pixel for
pixel; `pan_to_sem` writes the same semantic maps as the JAX package.
"""

import json
import math
import os
import random
import types

import numpy as np
import pytest
from PIL import Image, ImageDraw

from visper_lm_tpu.eval import caption_metrics as j_cap
from visper_lm_tpu.eval import cmmmu as j_cm
from visper_lm_tpu.eval import cvbench as j_cv
from visper_lm_tpu.eval import grounding_tasks as j_gt
from visper_lm_tpu.eval import harness as j_h
from visper_lm_tpu.eval import lmms_tasks as j_lt
from visper_lm_tpu.eval import mmmu as j_mm
from visper_lm_tpu.eval import mmstar as j_ms
from visper_lm_tpu.eval import olympiad as j_oly
from visper_lm_tpu.eval import pan_to_sem as j_pan
from visper_lm_tpu.eval import probe as j_pr

from visper_lm_tpu_torch.data.image_io import read_png, write_png
from visper_lm_tpu_torch.data.mm_utils import resize_lanczos
from visper_lm_tpu_torch.eval import caption_metrics as t_cap
from visper_lm_tpu_torch.eval import cmmmu as t_cm
from visper_lm_tpu_torch.eval import cvbench as t_cv
from visper_lm_tpu_torch.eval import grounding_tasks as t_gt
from visper_lm_tpu_torch.eval import harness as t_h
from visper_lm_tpu_torch.eval import lmms_tasks as t_lt
from visper_lm_tpu_torch.eval import mmmu as t_mm
from visper_lm_tpu_torch.eval import mmstar as t_ms
from visper_lm_tpu_torch.eval import olympiad as t_oly
from visper_lm_tpu_torch.eval import pan_to_sem as t_pan
from visper_lm_tpu_torch.eval import probe as t_pr

from test_fork_tail_tasks import (BOX_RESPONSES, CMMMU_DOC_FILL, CMMMU_DOC_MC, CMMMU_DOC_TF,
                                  GT_BOXES)
from test_lmms_tasks import (ADVERSARIAL_ANSWERS, CASES as MMB_CASES, MME_DOCS, MME_PREDS,
                             MMMU_MC_RESPONSES, MMMU_OPEN_RESPONSES, OCR_DOCS, OCR_PREDS, POPE_DOCS,
                             POPE_PREDS, SEED_DOCS, SEED_PREDS, SQA_DOCS, SQA_PREDS, TEXTVQA_DOCS,
                             VIZWIZ_DOCS, VIZWIZ_PREDS)

JAX = types.SimpleNamespace(h=j_h, lt=j_lt, mm=j_mm, cm=j_cm, oly=j_oly, gt=j_gt, cap=j_cap,
                            cv=j_cv, ms=j_ms, pr=j_pr)
PORT = types.SimpleNamespace(h=t_h, lt=t_lt, mm=t_mm, cm=t_cm, oly=t_oly, gt=t_gt, cap=t_cap,
                             cv=t_cv, ms=t_ms, pr=t_pr)


def _plain(x):
    """Images as arrays, containers recursively, everything else as it is."""
    if isinstance(x, Image.Image):
        return np.asarray(x.convert("RGB"))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _assert_same(got, ref, where="result"):
    got, ref = _plain(got), _plain(ref)
    if isinstance(ref, np.ndarray) or isinstance(got, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), err_msg=where)
    elif isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), (where, list(got), list(ref))
        for k in ref:
            _assert_same(got[k], ref[k], f"{where}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), (where, got, ref)
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(ref, float) and math.isnan(ref):
        assert isinstance(got, float) and math.isnan(got), (where, got)
    else:
        assert type(got) is type(ref) and got == ref, (where, got, ref)


def _both(fn, seed=None):
    """fn(modules) on the JAX and the port side (after the same random.seed)."""
    out = []
    for mods in (JAX, PORT):
        if seed is not None:
            random.seed(seed)
        out.append(fn(mods))
    _assert_same(out[1], out[0])


# ------------------------------------------------------------- the harness


def _img(w=8, h=8, seed=0):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8))


class _ScriptedLM:
    """generate_until with canned answers by doc id; records each request's
    context, generation kwargs and visuals."""

    def __init__(self, responses):
        self.responses = list(responses)
        self.task_dict = {}
        self.seen = []

    def generate_until(self, instances):
        for inst in instances:
            context, gen_kwargs, doc_to_visual, doc_id, task, split = inst.args
            doc = self.task_dict[task][split][doc_id]
            self.seen.append((context, dict(gen_kwargs), doc_to_visual(doc)))
        return [self.responses[inst.args[3]] for inst in instances]


def _evaluate(mods, build, docs_fn, responses, **kw):
    lm = _ScriptedLM(responses)
    task = build(mods)(docs_fn(), **kw)
    res = mods.h.evaluate(lm, [task])
    return res, lm.seen, task.name, task.split


RW_DOC = {"question": "What color?\nA. red apple\nB. green pear\nC. blue fish"}
CHOICE_DOCS = [{"choices": ["red apple", "green pear", "blue fish"]},
               {"choices": ["Yes", "No"]}, {"choices": ["cat", "dog", "bird", "fish"]}]
VQA_STRINGS = ADVERSARIAL_ANSWERS + ["The Dog!", "Two", "isnt", "a dog.", "cat", "fish",
                                     "None.", "it's a dog", "1,000,000 dollars", "Mr. Smith's"]

HARNESS_CASES = {
    "number_words_filter": lambda m: m.h.number_words_filter(
        ["Two", "11", "B", "zero", "TEN", "eleven"], [{}] * 6),
    "multi_choice_regex_filter": lambda m: m.h.multi_choice_regex_filter(
        ["green pear.", "(A)", "red apple!", "nothing", "The answer is B.", "blue fish is it"],
        [RW_DOC] * 5 + [{"question": "no options"}]),
    "MultiChoiceRegexFilter_letters": lambda m: m.h.MultiChoiceRegexFilter(
        regex_pattern=r"(\([A-Z]\))", ignore_case=True, ignore_punctuation=True,
        regexes_to_ignore=[","])(
        ["(B) green", "I think: B", "Green Pear!", "none", "the bird, surely", "answer: C"],
        CHOICE_DOCS * 2),
    "MultiChoiceRegexFilter_default": lambda m: m.h.MultiChoiceRegexFilter()(
        ["#### 42", "#### -3.5", "no", "#### 1,000"], CHOICE_DOCS + CHOICE_DOCS[:1]),
    "realworldqa_process_results": lambda m: [
        m.h.realworldqa_process_results({"answer": a}, [r])
        for a, r in [("B", "b."), ("B", "c"), ("2", " 2. "), ("Left", "left")]],
    "vqa_normalize": lambda m: [m.h.vqa_normalize(s) for s in VQA_STRINGS],
    "vqa_word_tokenize": lambda m: [m.h.vqa_word_tokenize(s) for s in VQA_STRINGS],
    "vqa_process_punctuation": lambda m: [m.h.vqa_process_punctuation(s) for s in VQA_STRINGS],
    "vqa_process_digit_article": lambda m: [m.h.vqa_process_digit_article(s) for s in VQA_STRINGS],
    "ok_vqa_process_results": lambda m: [
        m.h.ok_vqa_process_results(doc, [r]) for doc, r in [
            ({"answers": ["dog"] * 6 + ["cat"] * 4}, "a dog."),
            ({"answers": ["dog"] * 6 + ["cat"] * 4}, "cat"),
            ({"answers": ["dog"] * 6 + ["cat"] * 4}, "fish"),
            ({"answers": ["none", "none", "0", "zero", "none", "nothing", "none", "0", "none",
                          "none"]}, "None."),
            ({"answers": []}, "x")]],
    "cvbench_overall": lambda m: [m.h.cvbench_overall(r) for r in [
        {"acc_ADE20K": 0.5, "acc_COCO": 1.0, "acc_Omni3D": 0.25}, {"acc_COCO": 1.0}, {}]],
    "realworldqa_task": lambda m: _evaluate(m, lambda m: m.h.realworldqa_task, lambda: [
        {"question": "Pick.\nA. one\nB. two", "answer": "B", "image": _img()},
        {"question": "Pick.\nA. one\nB. two", "answer": "A", "image": _img(seed=1)},
        {"question": "How many?", "answer": "2", "image": _img(seed=2)}],
        ["The answer is B.", "(B)", "Two"]),
    "ok_vqa_task": lambda m: _evaluate(m, lambda m: m.h.ok_vqa_task, lambda: [
        {"question": " What is it? ", "answers": ["thing"] * 10, "image": _img(), "question_id": 1},
        {"question": "Which?", "answers": ["a dog"] * 4 + ["dog"] * 6, "image": _img(seed=3),
         "question_id": 2}], ["Thing.", "the dog"]),
    "cvbench_task": lambda m: _evaluate(m, lambda m: m.h.cvbench_task, lambda: [
        {"image": _img(), "question": "Which is closer?\n(A) car (B) bus", "answer": "(A)",
         "task": "Depth", "source": "ADE20K"},
        {"image": _img(seed=1), "question": "How many?\n(A) 1 (B) 2", "answer": "(B)",
         "task": "Count", "source": "Omni3D"},
        {"image": _img(seed=2), "question": "q", "answer": "(C)", "task": "Relation",
         "source": "COCO"}], ["(A) car", "A", "C"]),
    "mmstar_task": lambda m: _evaluate(m, lambda m: m.h.mmstar_task, lambda: [
        {"image": _img(), "question": "What?\nA. cat\nB. dog", "answer": "A",
         "category": "coarse perception", "l2_category": "image scene and topic"},
        {"image": _img(seed=1), "question": "q", "answer": "B", "category": "math",
         "l2_category": "geometry"}], ["(A)", "the answer is C"]),
}


@pytest.mark.parametrize("name", list(HARNESS_CASES))
def test_harness_equal_jax(name):
    _both(HARNESS_CASES[name])


def test_harness_image_paths_load_without_pil(tmp_path):
    """A doc's image path: the port reads it with image_io (an array), JAX
    with PIL (an image of the same pixels)."""
    path = str(tmp_path / "a.png")
    arr = np.random.default_rng(0).integers(0, 256, (9, 7, 3), np.uint8)
    write_png(path, arr)
    for build in ("cvbench_task", "mmstar_task"):
        doc = {"image": path}
        got = getattr(t_h, build)([doc]).doc_to_visual(doc)
        ref = getattr(j_h, build)([doc]).doc_to_visual(doc)
        assert isinstance(got[0], np.ndarray)
        _assert_same(got, ref)


# ------------------------------------------------- CV-Bench, MMStar, probe


CV_ANSWERS = [
    {"prediction": "(A)", "answer": "(A)", "task": "Count", "source": "ADE20K"},
    {"prediction": "(B)", "answer": "(A)", "task": "Depth", "source": "COCO"},
    {"prediction": "(C)", "answer": "(C)", "task": "Distance", "source": "Omni3D"},
    {"prediction": "The answer is (B).", "answer": "(B)", "task": "Relation", "source": "COCO"},
    {"prediction": "A) x", "answer": "(A)", "task": "Depth", "source": "Omni3D"},
]
MM_ANSWERS = [
    {"prediction": "A", "answer": "A", "category": "math", "l2_category": "geometry"},
    {"prediction": "B", "answer": "A", "category": "math", "l2_category": "geometry"},
    {"prediction": "option C", "answer": "C", "category": "logical reasoning",
     "l2_category": "diagram reasoning"},
    {"prediction": "", "answer": "A", "category": "coarse perception",
     "l2_category": "image emotion"},
]

BENCH_CASES = {
    "cvbench.extract_choice": lambda m: [m.cv.extract_choice(p) for p in [
        "(A)", "The answer is (B).", "C", "A) something", "", "(x) (D)", "no letter ("]],
    "cvbench.score_cvbench": lambda m: m.cv.score_cvbench(CV_ANSWERS),
    "cvbench.get_chunk": lambda m: [m.cv.get_chunk(list(range(10)), n, i)
                                    for n, i in [(3, 0), (3, 2), (4, 1), (1, 0)]],
    "mmstar._prediction_matches": lambda m: [m.ms._prediction_matches(a, p) for a, p in [
        ("A", "A"), ("a", "(A) because"), ("b", "option B"), ("c", "the answer is C"),
        ("a", "B"), ("a", ""), ("a", "("), ("a", "option "), ("a\n", "\na")]],
    "mmstar.score_mmstar": lambda m: m.ms.score_mmstar(MM_ANSWERS),
    "probe.cosine_similarity": lambda m: [m.pr.cosine_similarity(a, b) for a, b in [
        (np.array([[1.0, 0.0], [0.0, 2.0]]), np.array([[1.0, 0.0], [0.0, 2.0]])),
        (np.array([[1.0, 0.0], [0.0, 2.0]]), np.array([[0.0, 1.0], [2.0, 0.0]])),
        (np.random.default_rng(0).normal(size=(3, 4, 5)),
         np.random.default_rng(1).normal(size=(3, 4, 5))),
        (np.zeros((2, 3)), np.ones((2, 3)))]],
    "probe.accumulate_layer_scores": lambda m: m.pr.accumulate_layer_scores(
        [{"depth": {1: 0.5}}, {"depth": {1: 0.7, 3: 0.9}, "seg": {"2": 0.1}}]),
    "probe.da2k_accuracy": lambda m: [m.pr.da2k_accuracy(np.array([[1.0, 0.2], [0.5, 0.9]]), p)
                                      for p in [[((0, 0), (0, 1), "point1"),
                                                 ((1, 0), (1, 1), "point1")],
                                                [((0, 0), (0, 0), "point2")], []]],
    "probe.MeanIoU": lambda m: _miou(m),
}


def _miou(m):
    out = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        miou = m.pr.MeanIoU(num_classes=5)
        for _ in range(3):
            gt = rng.integers(0, 6, (7, 9))
            gt[gt == 5] = 255
            miou.update(rng.integers(0, 5, (7, 9)), gt)
        out.append(miou.compute())
    return out


@pytest.mark.parametrize("name", list(BENCH_CASES))
def test_cvbench_mmstar_probe_equal_jax(name):
    _both(BENCH_CASES[name])


@pytest.mark.parametrize("mod", ["cvbench", "mmstar"])
def test_score_files_main_equal_jax(mod, tmp_path, monkeypatch, capsys):
    answers = CV_ANSWERS if mod == "cvbench" else MM_ANSWERS
    outs = []
    for name, module in (("jax", {"cvbench": j_cv, "mmstar": j_ms}[mod]),
                         ("port", {"cvbench": t_cv, "mmstar": t_ms}[mod])):
        path = tmp_path / f"{name}.jsonl"
        # the merged-chunk format stores fields as one-element lists
        path.write_text("".join(json.dumps({k: [v] for k, v in a.items()}) + "\n"
                                for a in answers))
        monkeypatch.setattr("sys.argv", ["x", "--results-file", str(path)])
        module.main()
        outs.append((capsys.readouterr().out, (tmp_path / f"{name}_score.json").read_text()))
    assert outs[1] == outs[0]


def test_prepare_cvbench_and_load_jsonl_equal_jax(tmp_path):
    with open(tmp_path / "test.jsonl", "w") as f:
        for i in range(3):
            f.write(json.dumps({"filename": f"img/{i}.png", "prompt": f"q{i}", "answer": "(A)",
                                "task": "Count", "source": "COCO"}) + "\n\n")
    _both(lambda m: m.cv.prepare_cvbench(str(tmp_path)))
    _both(lambda m: m.cv.load_jsonl(str(tmp_path / "test.jsonl")))


# ---------------------------------------------------------- lmms_tasks


MMB_DOCS = lambda: [  # noqa: E731
    {"index": base + k * 1_000_000, "question": f"pick x ({base})",
     "hint": float("nan") if base else "a hint", "answer": "AB"[(["x", "y"] if k == 0 else
                                                                 ["y", "x"]).index("x")],
     "A": ["x", "y"][k], "B": ["y", "x"][k], "category": "synthetic",
     "L2-category": "synthetic", "image": _img(seed=base)}
    for base in range(3) for k in range(2)]
CAPTION_DOCS = lambda: [  # noqa: E731
    {"image": _img(), "answer": ["a cat sits on the mat", "there is a cat on a mat"],
     "image_id": 42},
    {"image": _img(seed=1), "answer": ["a man rides a red bicycle", "the man is riding"],
     "image_id": 43}]
CAPTION_PREDS = ["A cat sits on a mat.", "a man rides a bicycle down the street"]
NB_DOCS = lambda: [  # noqa: E731
    {"Index": i, "Image": _img(seed=i), "Question": f"Is it thing {i // 2}?",
     "Question_Type": "yes_no" if i < 4 else "multiple_choice"} for i in range(8)]
NB_PREDS = ["Yes", "no.", "No", "yes", "A", "B", "B", "maybe"]
SEED2_DOCS = lambda: [  # noqa: E731
    {"question": "What is shown?", "choice_a": "cat", "choice_b": "dog", "choice_c": "x.jpg",
     "choice_d": "bird", "answer": "A", "data_type": "Single Image", "data_id": ["a"],
     "question_id": 1, "image": [_img()]},
    {"question": "Pick the image", "choice_a": "p.png", "choice_b": "q.png", "choice_c": "r.png",
     "choice_d": "s.png", "answer": "C", "data_type": "Image Generation",
     "data_id": ["a", "b", "c", "d", "e", "f"], "question_id": 2,
     "image": [_img(seed=s) for s in range(2)]}]
MMMU_DOCS = lambda: [  # noqa: E731
    {"id": "validation_Art_1", "question_type": "multiple-choice",
     "options": "['red', 'blue', 'green']", "answer": "B", "question": "What color? <image 1>",
     "image_1": _img()},
    {"id": "validation_Art_2", "question_type": "multiple-choice", "options": "['cat', 'dog']",
     "answer": "A", "question": "Which animal? <image 1> and <image 2>", "image_1": _img(),
     "image_2": _img(seed=5)},
    {"id": "validation_Math_3", "question_type": "open", "options": "[]", "answer": "42",
     "question": "Compute. <image 1>", "image_1": _img(seed=2)},
    {"id": "validation_Physics_4", "question_type": "open", "options": "[]",
     "answer": ["9.8", "9.81"], "question": "g? <image 1>", "image_1": _img(seed=3)}]
MMMU_PREDS = ["The answer is B.", "the animal shown in the picture is a dog", "so we get 42",
              "about 3.7"]
OLY_DOCS = lambda: [  # noqa: E731
    {"question": "Compute x.", "subfield": "Algebra", "images": [_img()],
     "final_answer": ["42"], "answer_type": "Numerical", "error": None, "source": "OE_MM",
     "is_multiple_answer": False},
    {"question": "Find the roots.", "subfield": "Algebra", "images": [],
     "final_answer": ["1,2"], "answer_type": "Expression", "error": "1e-3", "source": "OE_TO",
     "is_multiple_answer": True},
    {"question": "Prove it.", "subfield": "Geometry", "images": [],
     "final_answer": [""], "answer_type": "Need_human_evaluate", "error": None,
     "source": "TP_TO", "is_multiple_answer": False}]
OLY_PREDS = ["So the final answer is \\boxed{42}.", "So the final answer is \\boxed{2,1}",
             "a proof"]
REC_DOCS = lambda: [  # noqa: E731
    {"image": _img(100, 100), "bbox": [10, 20, 50, 60], "answer": ["the left thing"],
     "question_id": 0},
    {"image": _img(100, 80, seed=1), "bbox": [0, 0, 30, 30], "answer": ["top corner", "corner"],
     "question_id": 1}]
REC_PREDS = ["[0.1, 0.2, 0.6, 0.8]", "no idea", "[0.0, 0.0, 0.4, 0.35]"]
SS_DOCS = lambda: [  # noqa: E731
    {"image": _img(64, 48, seed=s), "instruction": f"tap save {s}",
     "bbox": [0.1 * s, 0.1, 0.4 + 0.1 * s, 0.4], "file_name": f"{s}.png",
     "data_type": ["text", "icon"][s % 2], "data_source": ["ios", "windows", "shop"][s % 3]}
    for s in range(3)]
SS_PREDS = ["[0.1, 0.1, 0.4, 0.4]", "[0.0, 0.0, 0.2, 0.2]", "none"]
SEG_DOCS = lambda: [  # noqa: E731
    {"image": _img(40, 30), "segmentation": [2, 3, 30, 4, 20, 25], "bbox": [2, 3, 28, 22],
     "answer": ["a triangle"], "question_id": 0}]

TASK_DOCS = {
    # name: (docs, scripted answers); the harness's four tasks are in HARNESS_CASES
    "pope": (lambda: [dict(d, image=_img(seed=i)) for i, d in enumerate(POPE_DOCS)], POPE_PREDS),
    "gqa": (lambda: [{"question": "what color?", "answer": "Blue.", "image": _img()},
                     {"question": "which side?", "answer": "left", "image": _img(seed=1)}],
            ["blue", "Right."]),
    "textvqa_val": (lambda: [dict(d, image=_img(), ocr_tokens=["stop", "sign"])
                             for d in TEXTVQA_DOCS], ["Stop", "2 items"]),
    "vqav2_val": (lambda: [{"question_id": i, "question": "q?", "image": _img(),
                            "answers": a} for i, a in enumerate(
                                [["blue"] * 10, ["two"] * 5 + ["2"] * 5,
                                 ["a dog"] * 6 + ["dog"] * 4])], ["Blue.", "Two.", "the dog"]),
    "mme": (lambda: [dict(d, image=_img()) for d in MME_DOCS], MME_PREDS),
    "docvqa_val": (lambda: [{"question": "total?", "answers": ["Total: $45.50", "45.50"],
                             "image": _img(), "questionId": 1},
                            {"question": "day?", "answers": ["monday"], "image": _img(),
                             "questionId": 2}], ["$45.50", "Monday"]),
    "chartqa": (lambda: [{"question": "value?", "answer": t, "type": ty, "image": _img()}
                         for t, ty in [("40", "human_test"), ("0.1", "augmented_test"),
                                       ("blue", "human_test")]], ["42", "10%", "Blue"]),
    "scienceqa_img": (lambda: [dict(d, image=_img()) for d in SQA_DOCS], SQA_PREDS),
    "ai2d": (lambda: [{"question": "What is shown?", "options": ["root", "stem", "leaf"],
                       "answer": "2", "image": _img()},
                      {"question": "Which?", "options": ["a", "b"], "answer": 0,
                       "image": _img()}], ["c.", "B"]),
    "seedbench": (lambda: [dict(d, image=[_img()]) for d in SEED_DOCS], SEED_PREDS),
    "ocrbench": (lambda: [dict(d, image=_img()) for d in OCR_DOCS], OCR_PREDS),
    "infovqa_val": (lambda: [{"question": "title?", "answers": ["Infographic title", "the title"],
                              "image": _img(), "questionId": 1},
                             {"question": "pct?", "answers": ["42%"], "image": _img(),
                              "questionId": 2}], ["infographic title", "42 %"]),
    "vizwiz_vqa_val": (lambda: [dict(d, image=_img(), answers=list(d["answers"]))
                                for d in VIZWIZ_DOCS], VIZWIZ_PREDS),
    "mmmu_val": (MMMU_DOCS, MMMU_PREDS),
    "mmbench_en_dev": (MMB_DOCS, ["A", "(B).", "B.", "A", "x", "A"]),
    "multidocvqa_val": (lambda: [{"question": "what?", "answers": "['a', 'b']", "questionId": 3,
                                  "image_1": _img(), "image_2": None, "image_3": _img(seed=4)},
                                 {"question": "who?", "answers": ["The Answer"], "questionId": 4,
                                  "image_1": _img()}], ["b", "the answer"]),
    "iconqa_val": (lambda: [{"question": "which is bigger", "ques_type": "choose_img",
                             "query_image": _img(), "choice_image_0": _img(seed=1),
                             "choice_image_1": _img(seed=2), "answer": "0"},
                            {"question": "what shape", "ques_type": "choose_txt",
                             "choices": "circle,square,star", "query_image": _img(),
                             "answer": "square"},
                            {"question": "how many dots", "ques_type": "fill_in_blank",
                             "query_image": _img(), "answer": "3"}], ["A", "square", "3"]),
    "websrc_val": (lambda: [{"question": "which store?", "answer": a, "domain": d,
                             "image": _img()} for a, d in [("JB Hi-Fi store", "auto"),
                                                           ("42", "book"), ("open 9am", "auto")]],
                   ["jb hi-fi", "42.", "closed"]),
    "coco2017_cap_val": (CAPTION_DOCS, CAPTION_PREDS),
    "flickr30k_test": (CAPTION_DOCS, CAPTION_PREDS),
    "nocaps_val": (CAPTION_DOCS, CAPTION_PREDS),
    "textcaps_val": (CAPTION_DOCS, CAPTION_PREDS),
    "naturalbench": (NB_DOCS, NB_PREDS),
    "seedbench-2": (SEED2_DOCS, ["A. cat", "b"]),
    "cmmmu_val": (lambda: [dict(CMMMU_DOC_MC, image_1=_img()), dict(CMMMU_DOC_TF),
                           dict(CMMMU_DOC_FILL)], ["正确答案是(B)", "这个说法是错的", "所以答案是4"]),
    "olympiadbench_test_en": (OLY_DOCS, OLY_PREDS),
    "olympiadbench_test_cn": (OLY_DOCS, ["所以最终答案是\\boxed{42}", "所以最终答案是2,1", "证明"]),
    "refcoco_bbox_rec_val": (REC_DOCS, REC_PREDS),
    "refcoco+_bbox_rec_val": (REC_DOCS, REC_PREDS),
    "refcocog_bbox_rec_val": (REC_DOCS, REC_PREDS),
    "refcoco_bbox_val": (REC_DOCS, ["the left thing", "word"]),
    "refcoco_seg_val": (SEG_DOCS, ["a triangle"]),
    "screenspot_rec_test": (SS_DOCS, SS_PREDS),
    "screenspot_reg_test": (SS_DOCS, ["tap save 0", "save", ""]),
}


def _task_case(name):
    docs, answers = TASK_DOCS[name]

    def run(m):
        res, seen, task_name, split = _evaluate(m, lambda m: m.lt.task_builders()[name], docs,
                                                answers)
        extra = {}
        if name == "naturalbench":
            extra = m.lt.naturalbench_aggregate_results.last_scores
        if name == "screenspot_rec_test":
            extra = dict(m.gt.screenspot_rec_aggregate.last_buckets)
        return res, seen, task_name, split, extra
    return run


def _stvqa(m, tmp):
    path = str(tmp / f"sub_{'port' if m is PORT else 'jax'}.json")
    res, seen, _, _ = _evaluate(m, lambda m: m.lt.stvqa_task, lambda: [
        {"question_id": 1, "question": "what?", "image": _img()},
        {"question_id": 2, "question": "which?", "image": _img()}], ["red", "blue"],
        submission_path=path)
    with open(path) as f:
        return res, seen, json.load(f)


LMMS_CASES = {
    "eval_ai_process": lambda m: [
        (m.lt.eval_ai_process(s), m.lt.process_punctuation(s), m.lt.process_digit_article(s))
        for s in ADVERSARIAL_ANSWERS],
    "pope_process_and_aggregate": lambda m: _pope(m),
    "textvqa_process_results": lambda m: [m.lt.textvqa_process_results(dict(d), [p])
                                          for d, p in zip(TEXTVQA_DOCS, ["Stop", "2 items"])],
    "vqav2_process_results": lambda m: [
        m.lt.vqav2_process_results({"question_id": 0, "answers": a}, [p]) for a, p in [
            (["blue"] * 10, "Blue."), (["blue"] * 10, "blue?"),
            (["two"] * 5 + ["2"] * 5, "Two."), (["a dog"] * 6 + ["dog"] * 4, "the dog")]],
    "levenshtein_anls": lambda m: [
        (m.lt.levenshtein(r[0], p), m.lt.anls_score(r, p), m.lt.docvqa_process_results(
            {"answers": r}, [p])) for r, p in [
            (["Total: $45.50", "45.50"], "$45.50"), (["monday"], "Monday"),
            (["12 March 2020", "march 12"], "12 march  2020"), ([""], "anything"),
            (["abc"], ""), (["the   quick brown fox"], "the quick brown fox")]],
    "relaxed_correctness": lambda m: [
        (m.lt.relaxed_correctness(p, t), m.lt.chartqa_process_results(
            {"type": ty, "answer": t}, [p]))
        for p, t in [("42", "40"), ("42.1", "40"), ("10%", "0.1"), ("Blue", "blue"),
                     ("0", "0"), ("five", "5")] for ty in ("human_test", "augmented_test")],
    "mme": lambda m: ([m.lt.mme_process_results(d, [p]) for d, p in zip(MME_DOCS, MME_PREDS)],
                      [m.lt.mme_parse_pred(s) for s in ["yess", "No, it is not", "maybe", "YES."]]),
    "mme_aggregate_results": lambda m: m.lt.mme_aggregate_results(
        [v for d, p in zip(MME_DOCS, MME_PREDS) for v in m.lt.mme_process_results(d, [p]).values()]),
    "scienceqa": lambda m: [(m.lt.sqa_doc_to_text(d), m.lt.sqa_doc_to_target(d),
                             m.lt.sqa_process_results(d, [p]))
                            for d, p in zip(SQA_DOCS, SQA_PREDS)] + [
        m.lt.sqa_process_results({"question": "q", "hint": "", "choices": ["x", "y"],
                                  "answer": 1, "image": None}, [p])
        for p in ["B. y", "b. y", "B", "y"]],
    "ai2d": lambda m: [(m.lt.ai2d_doc_to_text(d), m.lt.ai2d_process_results(d, [p]))
                       for d in [{"question": "What is shown?", "options": ["root", "stem", "leaf"],
                                  "answer": "2"}] for p in ["C", "c.", "B", "leaf"]],
    "seedbench": lambda m: ([m.lt.seed_process_results(d, [p]) for d, p in zip(SEED_DOCS, SEED_PREDS)],
                            m.lt.seed_doc_to_text(SEED_DOCS[0]),
                            m.lt.seed_aggregate([m.lt.seed_process_results(d, [p])["seed_all"]
                                                 for d, p in zip(SEED_DOCS, SEED_PREDS)])),
    "ocrbench": lambda m: (lambda recs: (recs, m.lt.ocrbench_aggregate_accuracy(recs)))(
        [m.lt.ocrbench_process_results(d, [p])["ocrbench_accuracy"]
         for d, p in zip(OCR_DOCS, OCR_PREDS)]),
    "infovqa_process_results": lambda m: [
        m.lt.infovqa_process_results({"answers": r, "image": None}, [p]) for r, p in [
            (["Infographic title", "the title"], "infographic title"), (["42%"], "42 %"),
            (["unanswerable"], "cannot tell")]],
    "vizwiz": lambda m: ([m.lt.vizwiz_process_results({**d, "answers": list(d["answers"])}, [p])
                          for d, p in zip(VIZWIZ_DOCS, VIZWIZ_PREDS)],
                         m.lt.vizwiz_doc_to_text(VIZWIZ_DOCS[0])),
    "mmbench_infer": lambda m: [m.lt.mmbench_infer(a, dict(c)) for a, c in MMB_CASES] + [
        m.lt.mmbench_infer_option(a) for a, _ in MMB_CASES] + [
        m.lt.mmbench_infer_text(a, dict(c)) for a, c in MMB_CASES],
    "mmbench_doc_to_text_and_options": lambda m: [
        (m.lt.mmbench_doc_to_text(d), m.lt.mmbench_options(d)) for d in MMB_DOCS()],
    "mmbench_circular": lambda m: _mmbench_records(m),
    "multidocvqa": lambda m: [
        (m.lt.multidocvqa_anls(g, p), m.lt.multidocvqa_accuracy(g, p))
        for g, p in [(["The Answer"], "the answer"), (["answer", "reply"], "replyy"),
                     (["long ground truth"], "short"), (["x"], "none"), (["abc"], ""),
                     (["Mixed Case  "], "  mixed case"), (["95.6%"], "95.6")]] + [
        m.lt.multidocvqa_process_results({"answers": "['a', 'b']", "questionId": 3}, ["b"])],
    "iconqa_doc_to_text": lambda m: [m.lt.iconqa_doc_to_text(d) for d in [
        {"question": "which is bigger", "ques_type": "choose_img"},
        {"question": "what shape", "ques_type": "choose_txt", "choices": "circle,square,star"},
        {"question": "how many dots", "ques_type": "fill_in_blank"}]],
    "websrc": lambda m: ([m.lt.websrc_f1(a, p) for a, p in [
        ("The Answer", "the answer"), ("JB Hi-Fi store", "jb hi-fi"), ("42", "42."),
        ("open 9am", "closed"), ("", "anything"), ("word word word", "word")]],
        m.lt.websrc_aggregate([{"f1": m.lt.websrc_f1(a, p), "domain": d} for a, p, d in [
            ("a b", "a b", "auto"), ("a b", "a", "auto"), ("x", "y", "book")]])),
    "naturalbench": lambda m: _naturalbench(m),
    "seedbench2": lambda m: [(m.lt.seedbench2_doc_to_text(d), m.lt.seedbench2_process_results(d, [p]))
                             for d, p in zip(SEED2_DOCS(), ["A. cat", "b"])],
    "stvqa_task": _stvqa,
}
for _name in TASK_DOCS:
    LMMS_CASES[f"task:{_name}"] = _task_case(_name)


def _pope(m):
    recs = {}
    for doc, pred in zip(POPE_DOCS, POPE_PREDS):
        for k, v in m.lt.pope_process_results(doc, [pred]).items():
            recs.setdefault(k, []).append(v)
    return (recs, m.lt.pope_aggregate_accuracy(recs["pope_accuracy"]),
            m.lt.pope_aggregate_precision(recs["pope_precision"]),
            m.lt.pope_aggregate_recall(recs["pope_recall"]),
            m.lt.pope_aggregate_f1(recs["pope_f1_score"]),
            m.lt.pope_aggregate_yes_ratio(recs["pope_yes_ratio"]))


def _mmbench_records(m):
    rng = np.random.default_rng(0)
    opts = ["red", "blue", "green", "grey"]
    records = []
    for base in range(12):
        n_rot, correct = int(rng.integers(2, 5)), int(rng.integers(0, 4))
        for k in range(n_rot):
            rot = [opts[(j + k) % 4] for j in range(4)]
            ans = "ABCD"[rot.index(opts[correct])]
            right = base % 2 == 0 or k != 1
            pred = ans if right else "ABCD"[(rot.index(opts[correct]) + 1) % 4]
            form = [pred, f"({pred}).", f"{pred}.", "nonsense"][(k + base) % 4]
            records.append(m.lt.mmbench_process_results(
                {"index": base + k * 1_000_000, "question": f"q{base}", "answer": ans,
                 "category": "cat", "L2-category": "l2", "A": rot[0], "B": rot[1], "C": rot[2],
                 "D": rot[3]}, [form]))
    flat = [r for rec in records for r in rec.values()]
    groups = m.lt._mmbench_groups(flat)
    return (records, {b: m.lt._mmbench_hit(rows) for b, rows in groups.items()},
            m.lt.mmbench_aggregate_circular(flat), m.lt.mmbench_aggregate_unresolved(flat))


def _naturalbench(m):
    outs = ["Yes", "no.", "Yes, but also no", "nothing to see", "A", "B",
            "I would say  NO  here", "maybe yes?", "The answer is (B)"]
    rng = np.random.default_rng(0)
    quartets = {i: {k: float(rng.integers(-1, 2)) for k in ("q0_i0", "q0_i1", "q1_i0", "q1_i1")}
                for i in range(16)}
    return ([(m.lt.naturalbench_extract_answer(o, "yes_no"),
              m.lt.naturalbench_extract_answer(o, "multiple_choice")) for o in outs],
            m.lt.naturalbench_get_scores(quartets))


@pytest.mark.parametrize("name", list(LMMS_CASES))
def test_lmms_tasks_equal_jax(name, tmp_path):
    fn = LMMS_CASES[name]
    if name == "stvqa_task":
        _both(lambda m: fn(m, tmp_path))
    else:
        _both(fn, seed=0)


def test_task_registry_equal_jax():
    assert list(t_lt.task_builders()) == list(j_lt.task_builders())
    # the harness's four run in HARNESS_CASES, stvqa (a submission file) in LMMS_CASES
    covered = set(TASK_DOCS) | {"realworldqa", "ok_vqa_val2014", "cvbench", "mmstar", "stvqa"}
    assert covered == set(t_lt.task_builders())


# ------------------------------------------------------------ MMMU / CMMMU


MMMU_CASES = {
    "parse_multi_choice_response": lambda m: [
        m.mm.parse_multi_choice_response(r, ["A", "B", "C", "D"], dict(zip(
            "ABCD", ["Eiffel Tower", "Big Ben", "pyramid of Giza", "Colosseum"])))
        for r in MMMU_MC_RESPONSES + ["xyz", "", "(E)"]],
    "parse_open_response": lambda m: [m.mm.parse_open_response(r) for r in MMMU_OPEN_RESPONSES],
    "normalize_str_extract_numbers": lambda m: [
        (m.mm.normalize_str(s), m.mm.extract_numbers(s))
        for s in ["1,234", "3.14", "-2e5", "0.5%", "apple", "B", " x ", "12,345,678.9"]],
    "eval_multi_choice_and_open": lambda m: [
        m.mm.eval_multi_choice("B", "B"), m.mm.eval_multi_choice(["A", "B"], "C"),
        m.mm.eval_open("42", [42.0]), m.mm.eval_open(["9.8", "9.81"], [9.81]),
        m.mm.eval_open("mitosis", ["meiosis"]), m.mm.eval_open("the cell", ["cell"])],
    "doc_to_text_options_visual": lambda m: [
        (m.mm.mmmu_doc_to_text(d), m.mm.doc_options(d), m.mm.mmmu_doc_to_visual(d))
        for d in MMMU_DOCS()],
    "process_and_aggregate": lambda m: (lambda recs: (
        recs, m.mm.mmmu_aggregate_results(recs), m.mm.mmmu_domain_scores(recs)))(
        [m.mm.mmmu_process_results(d, [p])["mmmu_acc"] for d, p in zip(MMMU_DOCS(), MMMU_PREDS)]),
}


@pytest.mark.parametrize("name", list(MMMU_CASES))
def test_mmmu_equal_jax(name):
    _both(MMMU_CASES[name], seed=7)


CMMMU_OPTIONS = [CMMMU_DOC_MC[f"option{i}"] for i in range(1, 5)]
CMMMU_CASES = {
    "construct_prompt": lambda m: [m.cm.construct_prompt(dict(d))
                                   for d in (CMMMU_DOC_MC, CMMMU_DOC_TF, CMMMU_DOC_FILL)],
    "multi_choice": lambda m: [
        m.cm.get_multi_choice_prediction(r, *reversed(m.cm.get_multi_choice_info(CMMMU_OPTIONS)))
        for r in ["(B)", "答案是B", "线粒体是正确的", "A和B都对", "无法判断", "正确答案：(C) 叶绿体"]],
    "fill_blank": lambda m: [m.cm.get_fill_blank_prediction(r, "4") for r in
                             ["所以答案是4。", "计算结果为 4.0", "答案是2，000", "x = 4", "没有答案"]],
    "tf": lambda m: [m.cm.get_tf_prediction(r) for r in
                     ["这个说法是错误的。", "判断：对", "陈述正确", "无法确定"]],
    "numbers": lambda m: [(m.cm.extract_numbers(s), m.cm.normalize_str(s, "4"))
                          for s in ["2,000", "4.0", "-3e2", "四", " x "]],
    "process_and_aggregate": lambda m: (lambda recs: (
        recs, m.cm.cmmmu_aggregate_results([dict(r) for r in recs])))(
        [m.cm.cmmmu_process_results(d, [r])["cmmmu_acc"] for d, r in zip(
            [CMMMU_DOC_MC, CMMMU_DOC_TF, CMMMU_DOC_FILL], ["正确答案是(B)", "这个说法是错的", "所以答案是4"])]),
    "eval_cmmmu": lambda m: m.cm.eval_cmmmu([
        {"id": "1", "question_type": "选择", "answer": "B", "parsed_pred": "B"},
        {"id": "2", "question_type": "判断", "answer": "错", "parsed_pred": ["这个说法是错的"]},
        {"id": "3", "question_type": "判断", "answer": "对", "parsed_pred": ["是否正确"]},
        {"id": "4", "question_type": "填空", "answer": "4", "parsed_pred": [4.0, "x"]},
        {"id": "5", "question_type": "填空", "answer": "猫", "parsed_pred": ["一只猫"]}]),
}


@pytest.mark.parametrize("name", list(CMMMU_CASES))
def test_cmmmu_equal_jax(name):
    _both(CMMMU_CASES[name], seed=13)


# ------------------------------------------------------------- OlympiadBench


def _judge(m, a, b, prec):
    return m.oly.OlympiadBenchEvaluator().judge(a, b, prec)


OLY_CASES = {
    "split_and_pm": lambda m: [
        (m.oly.OlympiadBenchEvaluator().split_by_comma(e),
         m.oly.OlympiadBenchEvaluator().trans_plus_minus_sign(
             m.oly.OlympiadBenchEvaluator().split_by_comma(e)))
        for e in ["1, 2, (3, 4), [5, 6], f(x, y), 7", "a\\pm b, 3", "(1, 2]"]],
    "preprocess": lambda m: [m.oly.OlympiadBenchEvaluator().preprocess(a, b) for a, b in [
        ("So the final answer is \\boxed{42}.", "42"), ("text $\\frac{1}{2}$ more", "1/2"),
        ("\\boxed{1,2} and \\boxed{3}", "x"), ("answer \\left(1, 2\\right]$", "y"),
        ("100\\%", "100")]],
    "judge": lambda m: [_judge(m, a, b, p) for a, b, p in [
        ("\\boxed{42}", "42", 1e-8), ("\\boxed{42}", "42.000001", 1e-3),
        ("\\boxed{42}", "43", 1e-3), ("\\boxed{0.5}", "50", 1e-8), ("\\boxed{1,2}", "2,1", 1e-8),
        ("\\boxed{1,2}", "1,3", 1e-8), ("\\boxed{\\frac{1}{2}}", "0.5", 1e-8),
        ("\\boxed{2\\pi}", "6.2832", 1e-3), ("\\boxed{\\sqrt{2}}", "1.41421", 1e-4),
        ("\\boxed{(0, \\frac{1}{2}]}", "(0,0.5]", 1e-8),
        ("\\boxed{(0, \\frac{1}{2}]}", "(0,0.5)", 1e-8), ("\\boxed{x^{2}+1}", "1+x^2", 1e-8),
        ("\\boxed{1\\pm 2}", "3,-1", 1e-8)]],
    "latex_to_sympy": lambda m: [str(m.oly.latex_to_sympy(e)) for e in [
        "\\frac{1}{2}", "2\\pi", "\\sqrt{2}", "x^{2}+1", "\\frac{\\sqrt{2}}{2}", "3\\cdot 4"]],
    "doc_to_text_and_process": lambda m: [
        (m.oly.olympiadbench_doc_to_text(d, lang), m.oly.olympiadbench_process_results(d, [p], lang))
        for lang in ("en", "cn") for d, p in zip(OLY_DOCS(), OLY_PREDS)],
}


@pytest.mark.parametrize("name", list(OLY_CASES))
def test_olympiad_equal_jax(name):
    _both(OLY_CASES[name])


# ------------------------------------------------------------- grounding


def _rec_results(m, extra=False):
    sources = ["ios", "windows_screens", "web_forum", "android", "macos_x", "shop_site"]
    types_ = ["text", "icon", "text", "icon", "text", "icon"]
    out = []
    for b, r, s, t in zip(GT_BOXES, BOX_RESPONSES, sources, types_):
        rec = {"bbox": b, "pred": m.gt.parse_float_sequence_within(r)}
        if extra:
            rec.update(data_source=s, data_type=t)
        out.append(rec)
    return out


GROUNDING_CASES = {
    "parse_float_sequence_within": lambda m: [m.gt.parse_float_sequence_within(s)
                                              for s in BOX_RESPONSES],
    "compute_iou_center": lambda m: [(m.gt.compute_iou(a, b), m.gt.compute_center_accuracy(a, b))
                                     for a in GT_BOXES for b in GT_BOXES[:3]],
    "rec_aggregate": lambda m: [m.gt.rec_aggregate(_rec_results(m), metric)
                                for metric in m.gt.REC_METRICS],
    "screenspot_rec_aggregate": lambda m: [
        (m.gt.screenspot_rec_aggregate(_rec_results(m, True), metric),
         dict(m.gt.screenspot_rec_aggregate.last_buckets)) for metric in m.gt.REC_METRICS],
    "rec_preprocess_docs": lambda m: m.gt.rec_preprocess_docs(REC_DOCS()),
    "draw_bbox": lambda m: m.gt._draw_bbox({"image": _img(50, 40), "bbox": [3.7, 5.2, 30.1, 20]}),
    "draw_seg": lambda m: m.gt._draw_seg(SEG_DOCS()[0]),
}


@pytest.mark.parametrize("name", list(GROUNDING_CASES))
def test_grounding_equal_jax(name):
    _both(GROUNDING_CASES[name])


def test_grounding_visuals_of_arrays_equal_pil():
    """A doc holding an array gets the same pixels as one holding the PIL
    image (the card's path: no PIL)."""
    pil = _img(60, 45, seed=9)
    arr = np.asarray(pil)
    doc = {"bbox": [5, 6, 30, 20]}
    got = t_gt._draw_bbox(dict(doc, image=arr))[0]
    np.testing.assert_array_equal(got, np.asarray(j_gt._draw_bbox(dict(doc, image=pil))[0]))
    np.testing.assert_array_equal(arr, np.asarray(pil))         # the doc is untouched
    ss = t_lt.task_builders()["screenspot_reg_test"]
    ss_j = j_lt.task_builders()["screenspot_reg_test"]
    d = {"image": arr, "bbox": [1.5, 2.0, 40.2, 30.9], "instruction": "x"}
    np.testing.assert_array_equal(ss([d]).doc_to_visual(d)[0],
                                  np.asarray(ss_j([dict(d, image=pil)]).doc_to_visual(
                                      dict(d, image=pil))[0]))


@pytest.mark.parametrize("width", [0, 1, 3])
@pytest.mark.parametrize("seed", range(4))
def test_draw_rectangle_pixel_equal_pil(width, seed):
    """Boxes inside, across and outside the image, fractional and reversed
    ones (PIL refuses those, and so does the port)."""
    rng = np.random.default_rng(seed)
    for _ in range(150):
        h, w = (int(v) for v in rng.integers(1, 30, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        xy = [float(v) for v in rng.uniform(-8, 40, 4)]
        if rng.random() < 0.7:
            xy = [min(xy[0], xy[2]), min(xy[1], xy[3]), max(xy[0], xy[2]), max(xy[1], xy[3])]
        if rng.random() < 0.3:
            xy = [float(round(v)) for v in xy]
        pil = Image.fromarray(img)
        try:
            ImageDraw.Draw(pil).rectangle(xy, outline="red", width=width)
        except ValueError:
            with pytest.raises(ValueError):
                t_gt.draw_rectangle(img, xy, width=width)
            continue
        np.testing.assert_array_equal(t_gt.draw_rectangle(img, xy, width=width), np.asarray(pil),
                                      err_msg=f"{xy} width {width}")


# -------------------------------------------------------- caption metrics


CAP_GTS = {0: ["a cat sits on the mat", "there is a cat on a mat"],
           1: ["a man rides a red bicycle down the street", "the man is riding a bicycle"],
           2: ["two dogs play with a ball in the park", "dogs are playing with a ball"]}
CAP_RES = {0: ["a cat sits on a mat"], 1: ["a man rides a bicycle down the street"],
           2: ["two dogs play with a ball in a park"]}
PTB_RAW = ["A man's bike.", "Don't stop; it's fun!", "A well-known dog -- running...",
           "Two dogs' toys, 1,000 balls.", 'He said "hi" loudly.',
           "They'll we're I'm you've she'd", "a cat (on a mat)", "line\nbreaks stay spaces"]

CAPTION_CASES = {
    "ptb_tokenize_caption": lambda m: [m.cap.ptb_tokenize_caption(s) for s in PTB_RAW],
    "ptb_tokenize": lambda m: m.cap.ptb_tokenize({1: ["A cat.", "The cat!"], 2: ["Dogs run."]}),
    "bleu_score": lambda m: [m.cap.bleu_score(CAP_GTS, CAP_RES, n=4),
                             m.cap.bleu_score({0: ["a b c d e f"], 1: ["g h i j k l"]},
                                              {0: ["a b c d"], 1: ["g h i j"]})],
    "rouge_l": lambda m: [m.cap.rouge_l(CAP_GTS, CAP_RES),
                          m.cap.rouge_l({0: ["a b c d", "a b x"], 1: ["e f"]},
                                        {0: ["a b c"], 1: ["e f"]})],
    "cider_d": lambda m: [m.cap.cider_d(CAP_GTS, CAP_RES),
                          m.cap.cider_d({0: ["a b c"], 1: ["d e f"]}, {0: ["a a b"], 1: ["d e f"]}),
                          m.cap.cider_d({0: ["a b c d e"], 1: ["x y"]}, {0: ["a b"], 1: ["x y"]})],
    "compute_caption_metric": lambda m: [m.cap.compute_caption_metric(name, CAP_GTS, CAP_RES)
                                         for name in ("Bleu_4", "Bleu_3", "Bleu_2", "Bleu_1",
                                                      "ROUGE_L", "CIDEr")],
}


@pytest.mark.parametrize("name", list(CAPTION_CASES))
def test_caption_metrics_equal_jax(name):
    _both(CAPTION_CASES[name])


# ---------------------------------------------------------- pan_to_sem


def test_pan_to_sem_equal_jax(tmp_path):
    """The port's converter (image_io, no PIL) writes the JAX converter's
    semantic maps, pixel for pixel, from the same panoptic PNGs."""
    rng = np.random.default_rng(0)
    cats = [{"id": 1}, {"id": 7}, {"id": 90}]
    anns = []
    os.makedirs(tmp_path / "pan")
    for i in range(3):
        ids = rng.choice([0, 5, 300, 70000, 123456], size=(12, 17))
        rgb = np.stack([ids % 256, (ids // 256) % 256, ids // 65536], -1).astype(np.uint8)
        Image.fromarray(rgb).save(tmp_path / "pan" / f"{i}.png")
        anns.append({"file_name": f"{i}.png", "segments_info": [
            {"id": 5, "category_id": 7}, {"id": 300, "category_id": 1},
            {"id": 70000, "category_id": 90}, {"id": 123456, "category_id": 4}]})
    with open(tmp_path / "pan.json", "w") as f:
        json.dump({"categories": cats, "annotations": anns}, f)
    np.testing.assert_array_equal(t_pan.rgb2id(np.asarray(Image.open(tmp_path / "pan" / "0.png"))),
                                  j_pan.rgb2id(np.asarray(Image.open(tmp_path / "pan" / "0.png"))))
    assert t_pan.build_category_train_ids(cats) == j_pan.build_category_train_ids(cats)
    for name, mod in (("jax", j_pan), ("port", t_pan)):
        assert mod.convert_dataset(str(tmp_path / "pan.json"), str(tmp_path / "pan"),
                                   str(tmp_path / name), limit=None) == 3
    for i in range(3):
        got = read_png(str(tmp_path / "port" / f"{i}.png"))
        ref = np.asarray(Image.open(tmp_path / "jax" / f"{i}.png"))
        np.testing.assert_array_equal(got[..., 0], ref)
        assert set(np.unique(ref)) <= {0, 1, 2, 255}


# ---------------------------------------------------------------- Lanczos


@pytest.mark.parametrize("src,dst", [((768, 768), (256, 256)), ((64, 48), (256, 256)),
                                     ((100, 37), (211, 29)), ((7, 5), (300, 3)),
                                     ((300, 300), (301, 299)), ((1, 1), (5, 5))])
def test_resize_lanczos_byte_equal_pil(src, dst):
    img = np.random.default_rng(sum(src)).integers(0, 256, src + (3,), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(img).resize(dst, Image.LANCZOS))
    np.testing.assert_array_equal(resize_lanczos(img, dst), ref)

