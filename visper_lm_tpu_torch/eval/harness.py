"""Minimal executable lmms-eval-compatible harness (the port's counterpart of
visper_lm_tpu/eval/harness.py: the same tasks, filters and scores; a path in
a doc is read by `data.image_io.load_image`, not PIL).

The reference vendors a ~280-file lmms-eval fork; only a thin slice of it is
exercised by the shipped evals (docs/Evaluation.md:37): build per-doc
generate_until Instances, batch them through the model, run the task's filter
pipeline, score with process_results, aggregate. This module implements exactly
that slice (the `simple_evaluate`/`evaluate` flow of
lmms-eval/lmms_eval/evaluator.py:33-156) plus the two shipped task definitions:

  * realworldqa (tasks/realworldqa/realworldqa.yaml): 16 new tokens, greedy;
    NumberWordsToDigits + MultiChoiceRegex filters; exact_match vs 'answer';
  * ok_vqa (tasks/ok_vqa/*): VQA-style normalization (EvalAI processor) and the
    min(#matching/3, 1) consensus accuracy over annotator answers.

VisperLmms (eval/lmms_adapter.py) is the model interface; an external, full
lmms-eval installation remains drop-in compatible since Instance.args matches
its contract.
"""

from __future__ import annotations

import dataclasses
import re
import statistics
from typing import Any, Callable, Dict, List, Optional, Sequence

from visper_lm_tpu_torch.data.image_io import load_image

# ---------------------------------------------------------------- instances


@dataclasses.dataclass
class Instance:
    """generate_until request; .args matches lmms-eval api/instance.py."""

    args: tuple  # (context, gen_kwargs, doc_to_visual, doc_id, task, split)


@dataclasses.dataclass
class TaskConfig:
    name: str
    docs: Sequence[dict]
    doc_to_visual: Callable[[dict], Any]
    doc_to_text: Callable[[dict], str]
    process_results: Callable[[dict, List[str]], Dict[str, float]]
    generation_kwargs: Dict[str, Any]
    filters: Sequence[Callable[[List[str], Sequence[dict]], List[str]]] = ()
    metric_aggregation: Dict[str, Callable[[List[float]], float]] = dataclasses.field(
        default_factory=dict
    )
    split: str = "test"


def evaluate(lm, tasks: Sequence[TaskConfig], limit: Optional[int] = None) -> Dict[str, Dict[str, float]]:
    """Run every task through lm.generate_until; returns {task: {metric: value}}."""
    results: Dict[str, Dict[str, float]] = {}
    for task in tasks:
        docs = list(task.docs)[: limit or None]
        lm.task_dict = {task.name: {task.split: {i: d for i, d in enumerate(docs)}}}
        instances = [
            Instance(
                args=(
                    task.doc_to_text(doc),
                    dict(task.generation_kwargs),
                    task.doc_to_visual,
                    i,
                    task.name,
                    task.split,
                )
            )
            for i, doc in enumerate(docs)
        ]
        resps = lm.generate_until(instances)
        for f in task.filters:
            resps = f(resps, docs)
        metric_values: Dict[str, List[Any]] = {}
        for doc, resp in zip(docs, resps):
            scored = task.process_results(doc, [resp])
            for metric, value in scored.items():
                metric_values.setdefault(metric, []).append(value)
        agg = {}
        for metric, values in metric_values.items():
            fn = task.metric_aggregation.get(metric)
            if fn is not None:
                # custom aggregation sees the raw per-doc values (may be dict
                # records — POPE/MME style, lmms-eval aggregation contract)
                agg[metric] = fn(values)
                continue
            numeric = [v for v in values if isinstance(v, (int, float))]
            if len(numeric) == len(values):
                agg[metric] = sum(float(v) for v in numeric) / max(len(values), 1)
            # non-numeric metrics without an aggregator (e.g. 'submission'
            # records) are collected artifacts, not scores — dropped here
        results[task.name] = agg
    return results


def simple_evaluate(model, tasks: Sequence[TaskConfig], limit: Optional[int] = None,
                    batch_size: int = 8) -> Dict[str, Any]:
    """evaluator.simple_evaluate-shaped entry: wraps a VisperModel and evaluates."""
    from visper_lm_tpu_torch.eval.lmms_adapter import VisperLmms

    lm = model if hasattr(model, "generate_until") else VisperLmms(model, batch_size=batch_size)
    return {"results": evaluate(lm, tasks, limit=limit)}


# ------------------------------------------------------------- RWQA filters


_NUM_WORDS = {
    "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4", "five": "5",
    "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
}


def number_words_filter(resps: List[str], docs: Sequence[dict]) -> List[str]:
    """tasks/realworldqa/utils.py NumberWordsToDigitsFilter semantics."""
    return [_NUM_WORDS.get(r.lower(), r) for r in resps]


def multi_choice_regex_filter(resps: List[str], docs: Sequence[dict]) -> List[str]:
    """tasks/realworldqa/utils.py MultiChoiceRegexFilter semantics (the filter the
    RWQA yaml actually binds, realworldqa.yaml:22): parse the question's
    'A. choice' options; if the cleaned response contains a choice's text, map it
    back to its letter; otherwise return the cleaned response. The GENERIC
    harness filter with the full fallback chain is MultiChoiceRegexFilter below."""
    choices_re = re.compile(r"\b([A-Z])\.\s+([^\n]*)")
    out = []
    for resp, doc in zip(resps, docs):
        matches = choices_re.findall(doc.get("question", ""))
        choice_to_alpha = {}
        alpha = "A"
        for _, text in matches:
            choice_to_alpha[text.strip()] = alpha
            alpha = chr(ord(alpha) + 1)
        cleaned = re.sub(r"[^\w\s]", "", resp).strip()
        if choice_to_alpha:
            pat = re.compile("|".join(re.escape(t) for t in choice_to_alpha))
            m = pat.search(cleaned)
            if m and m.group() in choice_to_alpha:
                out.append(choice_to_alpha[m.group()])
                continue
        out.append(cleaned)
    return out


class MultiChoiceRegexFilter:
    """The generic lmms-eval multiple-choice extraction filter
    (lmms-eval/lmms_eval/filters/extraction.py:73-170), full fallback chain:

      1. findall the configured regex (e.g. ``(\\([A-Z]\\))``) and take
         group_select (tuple matches keep the first non-empty group);
      2. else: clean the response per ignore_case / ignore_punctuation /
         regexes_to_ignore and search for each of ``doc['choices']``'s cleaned
         text, mapping a hit back to its ``(letter)``;
      3. else: search ``:[\\s]*(A|B|...)`` and parenthesize the letter;
      4. else: the fallback string ('[invalid]').

    Operates per-doc on a list of responses (flat List[str] here, one response
    per doc, matching the harness evaluate() filter contract).
    """

    def __init__(
        self,
        regex_pattern: str = r"#### (\-?[0-9\.\,]+)",
        group_select: int = 0,
        fallback: str = "[invalid]",
        ignore_case: bool = False,
        ignore_punctuation: bool = False,
        regexes_to_ignore=None,
    ):
        import sys as _sys
        import unicodedata as _ud

        self.regex = re.compile(regex_pattern)
        self.group_select = group_select
        self.fallback = fallback
        self.ignore_case = ignore_case
        self.ignore_punctuation = ignore_punctuation
        self.regexes_to_ignore = regexes_to_ignore
        self._punct_tbl = dict.fromkeys(
            i for i in range(_sys.maxunicode)
            if _ud.category(chr(i)).startswith("P")
        )

    def _filter_ignores(self, st: str) -> str:
        if self.regexes_to_ignore is not None:
            for s in self.regexes_to_ignore:
                st = re.sub(s, "", st)
        if self.ignore_case:
            st = st.lower()
        if self.ignore_punctuation:
            st = st.translate(self._punct_tbl)
        return st

    def _find_match(self, regex, resp: str, convert_dict=None):
        match = regex.findall(resp)
        if match:
            m = match[self.group_select]
            if isinstance(m, tuple):
                m = [x for x in m if x][0]
            m = m.strip()
            if m and convert_dict and m in convert_dict:
                m = convert_dict[m]
            return m
        return None

    def __call__(self, resps: List[str], docs: Sequence[dict]) -> List[str]:
        out = []
        for resp, doc in zip(resps, docs):
            fallback_regexes = []
            choice_to_alpha = {}
            without_paren_regexes = []
            without_paren_to_target = {}
            next_alpha = "A"
            for c in doc.get("choices", []):
                m = self._filter_ignores(c.strip())
                fallback_regexes.append(re.escape(m))
                choice_to_alpha[m] = f"({next_alpha})"
                without_paren_regexes.append(next_alpha)
                without_paren_to_target[next_alpha] = f"({next_alpha})"
                next_alpha = chr(ord(next_alpha) + 1)
            fallback_regex = re.compile("|".join(fallback_regexes))
            without_paren_regex = re.compile(
                r":[\s]*(" + "|".join(without_paren_regexes) + ")"
            )
            match = self._find_match(self.regex, resp)
            if not match:
                match = self._find_match(
                    fallback_regex, self._filter_ignores(resp), choice_to_alpha
                )
                if not match:
                    match = self._find_match(
                        without_paren_regex, resp, without_paren_to_target
                    )
            if not match:
                match = self.fallback
            out.append(match)
        return out


def realworldqa_process_results(doc: dict, results: List[str]) -> Dict[str, float]:
    pred = results[0].lower().strip().rstrip(".")
    gt = doc["answer"].lower().strip()
    return {"exact_match": 1.0 if pred == gt else 0.0}


def realworldqa_task(docs: Sequence[dict]) -> TaskConfig:
    """docs: [{question, answer, image(PIL)}]."""
    return TaskConfig(
        name="realworldqa",
        docs=docs,
        doc_to_visual=lambda d: [d["image"]],
        doc_to_text=lambda d: d["question"].strip(),
        process_results=realworldqa_process_results,
        generation_kwargs={
            "max_new_tokens": 16, "temperature": 0, "do_sample": False,
        },
        filters=(number_words_filter, multi_choice_regex_filter),
    )


# ------------------------------------------------------------------ OK-VQA


_VQA_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
    "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll", "whyre": "why're",
    "whys": "why's", "wont": "won't", "wouldve": "would've",
    "wouldnt": "wouldn't", "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've", "y'all'dve": "y'all'd've",
    "youd": "you'd", "youd've": "you'd've", "you'dve": "you'd've",
    "youll": "you'll", "youre": "you're", "youve": "you've",
}
_VQA_ARTICLES = {"a", "an", "the"}
_VQA_PUNCT = [";", "/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
              "-", ">", "<", "@", "`", ",", "?", "!"]
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")
# EvalAI's NUMBER_MAP adds "none" -> "0" on top of the RWQA word map
# (vqa_eval_metric.py:134-147); RWQA's NumberWordsToDigitsFilter does not.
_EVALAI_NUM_MAP = {"none": "0", **_NUM_WORDS}


def vqa_word_tokenize(word: str) -> str:
    """EvalAIAnswerProcessor.word_tokenize (vqa_eval_metric.py:178-181)."""
    word = word.lower()
    word = word.replace(",", "").replace("?", "").replace("'s", " 's")
    return word.strip()


def vqa_process_punctuation(in_text: str) -> str:
    """EvalAIAnswerProcessor.process_punctuation (vqa_eval_metric.py:183-191)."""
    out = in_text
    for p in _VQA_PUNCT:
        if (p + " " in in_text or " " + p in in_text) or (
            _COMMA_STRIP.search(in_text) is not None
        ):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_STRIP.sub("", out)


def vqa_process_digit_article(in_text: str) -> str:
    """EvalAIAnswerProcessor.process_digit_article (vqa_eval_metric.py:193-206)."""
    words = []
    for word in in_text.lower().split():
        word = _EVALAI_NUM_MAP.get(word, word)
        if word not in _VQA_ARTICLES:
            words.append(word)
    for i, word in enumerate(words):
        if word in _VQA_CONTRACTIONS:
            words[i] = _VQA_CONTRACTIONS[word]
    return " ".join(words)


def vqa_normalize(text: str) -> str:
    """EvalAI answer normalization, the full __call__ pipeline
    (tasks/_task_utils/vqa_eval_metric.py:208-213): word_tokenize →
    whitespace fold → punctuation → digit/article/contractions."""
    t = vqa_word_tokenize(text)
    t = t.replace("\n", " ").replace("\t", " ").strip()
    t = vqa_process_punctuation(t)
    return vqa_process_digit_article(t)


def ok_vqa_process_results(doc: dict, results: List[str]) -> Dict[str, Any]:
    """tasks/ok_vqa/utils.py:20-48: leave-one-out consensus over annotators."""
    res = vqa_normalize(results[0])
    answers = [vqa_normalize(a) for a in (doc.get("answers") or [])]
    accuracy = 0.0
    if answers:
        gt_acc = []
        for i in range(len(answers)):
            others = [answers[j] for j in range(len(answers)) if j != i]
            matching = [a for a in others if a == res]
            gt_acc.append(min(1.0, len(matching) / 3))
        accuracy = statistics.mean(gt_acc)
    return {"exact_match": accuracy}


OK_VQA_POST_PROMPT = (
    "\nWhen the provided information is insufficient, respond with 'Unanswerable'."
    "\nAnswer the question using a single word or phrase."
)


def ok_vqa_task(docs: Sequence[dict]) -> TaskConfig:
    """docs: [{question, answers: [str x10], image(PIL), question_id}]."""
    return TaskConfig(
        name="ok_vqa_val2014",
        docs=docs,
        doc_to_visual=lambda d: [d["image"]],
        doc_to_text=lambda d: d["question"].strip() + OK_VQA_POST_PROMPT,
        process_results=ok_vqa_process_results,
        generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                           "until": ["ASSISTANT:"]},
        split="val2014",
    )


# ------------------------------------------------- CV-Bench / MMStar tasks


def cvbench_task(docs: Sequence[dict]) -> TaskConfig:
    """CV-Bench as a harness task (docs: prepare_cvbench records with 'image'
    as an array, a PIL image or a path). Per-source exact_match metrics; combine with
    cvbench_overall() for the reference's (mean(ADE20K,COCO)+Omni3D)/2."""
    from visper_lm_tpu_torch.eval.cvbench import extract_choice

    def process(doc: dict, results: List[str]) -> Dict[str, float]:
        ok = 1.0 if extract_choice(results[0]) == doc["answer"] else 0.0
        return {"exact_match": ok, f"acc_{doc['source']}": ok}

    def visual(doc):
        img = doc["image"]
        if isinstance(img, str):
            img = load_image(img)
        return [img]

    return TaskConfig(
        name="cvbench",
        docs=docs,
        doc_to_visual=visual,
        doc_to_text=lambda d: d["question"],
        process_results=process,
        generation_kwargs={"max_new_tokens": 128, "temperature": 0},
    )


def cvbench_overall(task_results: Dict[str, float]) -> float:
    """Reference accuracy formula over cvbench_task results
    (eval_cv_bench.py:26-78)."""
    acc_2d = (
        task_results.get("acc_ADE20K", 0.0) + task_results.get("acc_COCO", 0.0)
    ) / 2
    acc_3d = task_results.get("acc_Omni3D", 0.0)
    return (acc_2d + acc_3d) / 2


def mmstar_task(docs: Sequence[dict]) -> TaskConfig:
    """MMStar as a harness task (docs: prepare_mmstar records). exact_match is
    the letter-match with the reference's fallbacks (mmstar/evaluate)."""
    from visper_lm_tpu_torch.eval.mmstar import _prediction_matches

    def process(doc: dict, results: List[str]) -> Dict[str, float]:
        ok = 1.0 if _prediction_matches(str(doc["answer"]), results[0]) else 0.0
        return {"exact_match": ok}

    def visual(doc):
        img = doc["image"]
        if isinstance(img, str):
            img = load_image(img)
        return [img]

    return TaskConfig(
        name="mmstar",
        docs=docs,
        doc_to_visual=visual,
        doc_to_text=lambda d: d["question"],
        process_results=process,
        generation_kwargs={"max_new_tokens": 128, "temperature": 0},
        split="val",
    )
