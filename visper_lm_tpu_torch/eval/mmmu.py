"""MMMU (val) task: rule-based response parsing + per-domain accuracy rollup (a copy of
visper_lm_tpu/eval/mmmu.py, its imports pointed at the port).

Re-derivation of the reference fork's MMMU evaluation
(the reference's lmms-eval/lmms_eval/tasks/mmmu/utils.py, itself vendored from
the official MMMU repo's eval_utils.py) with every parsing quirk preserved:

  * multi-choice parsing cascade "(A)" -> "A " -> "A." -> option-content
    substring (only when the response is longer than 5 words), with a RANDOM
    choice as the final fallback (reference utils.py:294-295 — kept for score
    parity; seed `random` for reproducibility);
  * multi-candidate disambiguation takes the LAST occurrence by rfind — and
    the space-delimited stage searches " X " with a LEADING space, so a
    candidate at position 0 rfinds -1 and loses ties (utils.py:305-311);
  * open-response key extraction lowercases BEFORE splitting on
    r"\\.\\s(?=[A-Z])|\\n", so the uppercase lookahead never fires and the
    split is effectively newline-only (utils.py:393-395);
  * "=" counts as an answer indicator only in the LAST sub-response;
  * numeric normalization: comma-stripped float rounded to 2 decimals;
    single-char strings match only with a flanking space (anti-trivial);
  * accuracy aggregates per MMMU subdomain, then instance-weighted across
    the 6 official domains; the headline is the overall instance accuracy.

All scoring is parity-tested side-by-side against the reference module in
tests/test_lmms_tasks.py.
"""

from __future__ import annotations

import ast
import random
import re
from collections import defaultdict
from typing import Any, Dict, List, Sequence, Tuple, Union

from visper_lm_tpu_torch.data.mm_utils import to_rgb_array
from visper_lm_tpu_torch.eval.harness import TaskConfig

MULTI_CHOICE_PROMPT = "Answer with the option letter from the given choices directly."
OPEN_ENDED_PROMPT = "Answer the question using a single word or phrase."

# Official MMMU domain -> subject table (data spec, utils.py:151-184)
DOMAIN_SUBJECTS: Dict[str, Tuple[str, ...]] = {
    "Art and Design": ("Art", "Art_Theory", "Design", "Music"),
    "Business": ("Accounting", "Economics", "Finance", "Manage", "Marketing"),
    "Science": ("Biology", "Chemistry", "Geography", "Math", "Physics"),
    "Health and Medicine": (
        "Basic_Medical_Science", "Clinical_Medicine",
        "Diagnostics_and_Laboratory_Medicine", "Pharmacy", "Public_Health",
    ),
    "Humanities and Social Science": (
        "History", "Literature", "Sociology", "Psychology",
    ),
    "Tech and Engineering": (
        "Agriculture", "Architecture_and_Engineering", "Computer_Science",
        "Electronics", "Energy_and_Power", "Materials",
        "Mechanical_Engineering",
    ),
}


# ------------------------------------------------------------------ prompts


def doc_options(doc: dict) -> List[str]:
    # the HF dataset stores options as a python-literal STRING (utils.py:37)
    return list(ast.literal_eval(doc["options"]))


def mmmu_doc_to_text(doc: dict) -> str:
    q = _construct_prompt(doc)
    # "<image 1>".."<image 7>" -> the generic "<image>" splice marker
    return re.sub(r"<image [1-7]>", "<image>", q)


def _construct_prompt(doc: dict) -> str:
    question = doc["question"]
    if doc["question_type"] == "multiple-choice":
        opts = doc_options(doc)
        letters = [chr(ord("A") + i) for i in range(len(opts))]
        options_str = "\n".join(f"{l}. {o}" for l, o in zip(letters, opts))
        return f"{question}\n{options_str}\n{MULTI_CHOICE_PROMPT}"
    return f"{question}\n{OPEN_ENDED_PROMPT}"


def mmmu_doc_to_visual(doc: dict) -> List[Any]:
    """Images referenced by the prompt, in order: '<image 3>' -> doc['image_3']
    (utils.py:50-56)."""
    prompt = _construct_prompt(doc)
    keys = [t.strip("<>").replace(" ", "_")
            for t in re.findall(r"<image \d+>", prompt)]
    return [to_rgb_array(doc[k]) for k in keys]


# ------------------------------------------------------------------ parsing


def parse_multi_choice_response(
    response: str, all_choices: Sequence[str], index2ans: Dict[str, str]
) -> str:
    """The official MMMU cascade (utils.py:259-317)."""
    for ch in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(ch)
    response = f" {response} "

    candidates: List[str] = []
    index_ans = True     # candidates are letters (vs option contents)
    with_bracket = False
    for c in all_choices:
        if f"({c})" in response:
            candidates.append(c)
            with_bracket = True
    if not candidates:
        for c in all_choices:
            if f"{c} " in response:
                candidates.append(c)
    if not candidates:
        for c in all_choices:
            if f"{c}." in response:
                candidates.append(c)
    if not candidates and len(response.split()) > 5:
        for idx, ans in index2ans.items():
            if ans.lower() in response.lower():
                candidates.append(idx)
                index_ans = False

    if not candidates:
        # official fallback: a RANDOM choice (utils.py:294-295). Seed `random`
        # for reproducible scores.
        return random.choice(list(all_choices))
    if len(candidates) == 1:
        return candidates[0]
    # several mentions: keep the LAST one in the response. NOTE the
    # space-delimited probe is " X " with a leading space, so a match at
    # position 0 yields rfind == -1 (reference quirk, utils.py:305-311).
    if index_ans:
        probe = (lambda c: f"({c})") if with_bracket else (lambda c: f" {c} ")
        positions = [response.rfind(probe(c)) for c in candidates]
    else:
        positions = [response.lower().rfind(index2ans[c].lower())
                     for c in candidates]
    return candidates[max(range(len(candidates)), key=positions.__getitem__)]


_NUM_COMMAS = re.compile(r"-?\b\d{1,3}(?:,\d{3})+\b")
_NUM_SCI = re.compile(r"-?\d+(?:\.\d+)?[eE][+-]?\d+")
_NUM_SIMPLE = re.compile(r"-?(?:\d+\.\d+|\.\d+|\d+\b)(?![eE][+-]?\d+)(?![,\d])")


def extract_numbers(s: str) -> List[str]:
    """All number forms, comma-grouped first (regexes are the spec,
    utils.py:320-341)."""
    return _NUM_COMMAS.findall(s) + _NUM_SCI.findall(s) + _NUM_SIMPLE.findall(s)


def _is_number(s: str) -> bool:
    try:
        float(s.replace(",", ""))
        return True
    except ValueError:
        return False


def normalize_str(s: str) -> List[Union[str, float]]:
    """utils.py:357-380: numbers -> round(float, 2); strings -> lowercase,
    single chars get flanking-space guards against trivial substring hits."""
    s = s.strip()
    if _is_number(s):
        return [round(float(s.replace(",", "")), 2)]
    s = s.lower()
    if len(s) == 1:
        return [f" {s}", f"{s} "]
    return [s]


def parse_open_response(response: str) -> List[Union[str, float]]:
    """utils.py:383-452: pull indicator-tailed key sentences, then their
    numbers, then normalize and dedup."""
    indicators = ["could be ", "so ", "is ", "thus ", "therefore ", "final ",
                  "answer ", "result "]
    text = response.strip().strip(".").lower()
    # the reference lowercases FIRST, so the (?=[A-Z]) lookahead is dead and
    # this splits on newlines only — preserved for parity
    subs = re.split(r"\.\s(?=[A-Z])|\n", text)
    keys: List[str] = []
    for i, sub in enumerate(subs):
        inds = indicators + ["="] if i == len(subs) - 1 else indicators
        shortest = None
        for ind in inds:
            if ind in sub:
                tail = sub.split(ind)[-1].strip()
                if shortest is None or len(tail) < len(shortest):
                    shortest = tail
        if shortest and shortest.strip() not in (":", ",", ".", "!", "?", ";",
                                                 "'"):
            keys.append(shortest)
    if not keys:
        keys = [text]

    preds: List[str] = list(keys)
    for k in keys:
        preds.extend(extract_numbers(k))
    out: List[Union[str, float]] = []
    for p in preds:
        out.extend(normalize_str(p))
    return list(set(out))


# ------------------------------------------------------------------ scoring


def eval_multi_choice(gold: Union[str, List[str]], pred: str) -> bool:
    golds = gold if isinstance(gold, list) else [gold]
    return any(g == pred for g in golds)


def eval_open(gold: Union[str, List[str]],
              preds: List[Union[str, float]]) -> bool:
    norm_golds: List[Union[str, float]] = []
    for g in gold if isinstance(gold, list) else [gold]:
        norm_golds.extend(normalize_str(g))
    for p in preds:
        if isinstance(p, str):
            if any(isinstance(g, str) and g in p for g in norm_golds):
                return True
        elif p in norm_golds:
            return True
    return False


def _subset_name(doc_id: str) -> str:
    """'validation_Art_Theory_12' -> 'Art_Theory' (utils.py:76-85)."""
    split = doc_id.split("_")[0]
    m = re.search(rf"^{split}_(.+?)_\d+$", doc_id)
    if m is None:
        raise ValueError(f"no subset in {doc_id!r}")
    return m.group(1)


def mmmu_process_results(doc: dict, results: List[str]) -> Dict[str, Any]:
    pred = results[0]
    if doc["question_type"] == "multiple-choice":
        opts = doc_options(doc)
        letters = [chr(ord("A") + i) for i in range(len(opts))]
        parsed: Any = parse_multi_choice_response(
            pred, letters, dict(zip(letters, opts))
        )
    else:
        parsed = parse_open_response(pred)
    return {
        "mmmu_acc": {
            "id": doc["id"],
            "subdomain": _subset_name(doc["id"]),
            "question_type": doc["question_type"],
            "answer": doc["answer"],
            "parsed_pred": parsed,
        }
    }


def _judge(rec: dict) -> bool:
    if rec["question_type"] == "multiple-choice":
        return eval_multi_choice(rec["answer"], rec["parsed_pred"])
    return eval_open(rec["answer"], rec["parsed_pred"])


def mmmu_aggregate_results(results: List[dict]) -> float:
    """Per-subdomain accuracy, instance-weighted domain + overall rollup;
    the returned headline matches printable_results['Overall']['acc']
    (round-3 like the reference, utils.py:94-135)."""
    by_subset: Dict[str, List[dict]] = defaultdict(list)
    for r in results:
        by_subset[r["subdomain"]].append(r)
    acc_num = {
        s: (sum(_judge(r) for r in recs) / len(recs), len(recs))
        for s, recs in by_subset.items()
    }
    total = sum(n for _, n in acc_num.values())
    if total == 0:
        return 0.0
    overall = sum(a * n for a, n in acc_num.values()) / total
    return round(overall, 3)


def mmmu_domain_scores(results: List[dict]) -> Dict[str, float]:
    """Per-domain instance accuracies ('Overall-Art and Design' style rows)."""
    by_subset: Dict[str, List[dict]] = defaultdict(list)
    for r in results:
        by_subset[r["subdomain"]].append(r)
    out = {}
    for domain, subjects in DOMAIN_SUBJECTS.items():
        recs = [r for s in subjects for r in by_subset.get(s, [])]
        if recs:
            out[domain] = round(sum(_judge(r) for r in recs) / len(recs), 3)
    return out


def mmmu_task(docs: Sequence[dict]) -> TaskConfig:
    """docs: MMMU val rows — {id, question, options(str), answer,
    question_type, image_1..image_7(PIL)} (tasks/mmmu/mmmu_val.yaml)."""
    return TaskConfig(
        name="mmmu_val",
        docs=docs,
        doc_to_visual=mmmu_doc_to_visual,
        doc_to_text=mmmu_doc_to_text,
        process_results=mmmu_process_results,
        generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                           "do_sample": False},
        metric_aggregation={"mmmu_acc": mmmu_aggregate_results},
        split="validation",
    )
