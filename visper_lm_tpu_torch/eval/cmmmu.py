"""CMMMU (Chinese MMMU) native scorer + task config (a copy of
visper_lm_tpu/eval/cmmmu.py, its imports pointed at the port).

Port of the reference fork's rule-based evaluation
(the reference's lmms-eval/lmms_eval/tasks/cmmmu/utils.py) — the Chinese
counterpart of eval/mmmu.py with its own prompt templates, answer-extraction
cascades and keyword tables:

  * three question types: 选择 (multiple choice), 判断 (true/false),
    填空 (fill-in-the-blank), each with its Chinese task instruction and
    example format (utils.py:12-52);
  * multiple choice: occurrence-counting cascade "(A)" -> bare letter ->
    option text, most-frequent candidates joined in ABCD order, RANDOM
    choice when nothing parses (utils.py:222-261);
  * fill-in-blank: key-sentence extraction by Chinese indicator words,
    number extraction incl. Chinese-comma thousands + scientific notation,
    round-2 normalization, substring match against normalized answers
    (utils.py:282-365,318-383);
  * true/false: positive/negative keyword voting with ambiguous-phrase
    filtering and a random tie-break (utils.py:178-205);
  * aggregation: per-subcategory accuracy rolled into the six Chinese
    domains, instance-level overall (utils.py:137-144,200-218,404-421).

Parity is pinned against the fork's own utils in
tests/test_fork_tail_tasks.py (random fallbacks exercised under a fixed
seed on both sides).
"""

from __future__ import annotations

import random
import re
from collections import Counter, defaultdict
from typing import Any, Dict, List, Sequence

from visper_lm_tpu_torch.data.mm_utils import to_rgb_array
from visper_lm_tpu_torch.eval.harness import TaskConfig

TASK_INSTRUCTIONS = [
    "请回答以下多项选择题，并选出正确选项。这些题目可能包括单选和多选题型。如果所提供的信息不足以确定一个明确的答案，那么请根据可用的数据和你的判断来选择最可能正确的选项。",
    "请回答以下判断题，并根据题目描述和所给的信息来判断问题中陈述的对错。如果信息不完整或不足以作出绝对判断，请运用你的逻辑推理和现有信息来做出最可能的判断。",
    "请回答以下填空题，并根据题目的要求和所提供的信息来给出最恰当的答案。如果信息不足以确切回答，那么请依据现有的数据和你的推理能力来填写最合理的答案。",
]
MULTI_CHOICE_FORMAT = "问题：{}\n选项：\n{}\n正确答案：\n"
TF_FORMAT = "问题：{}\n正确答案：\n"
SHORT_ANS_FORMAT = "问题：{}\n正确答案：\n"

DOMAIN_CAT2SUB_CAT = {
    "艺术与设计": ["艺术", "艺术理论", "设计", "音乐"],
    "商业": ["会计", "经济", "金融", "管理", "营销"],
    "科学": ["生物", "化学", "地理", "数学", "物理"],
    "健康与医学": ["基础医学", "临床医学", "诊断学与实验室医学", "制药", "公共卫生"],
    "人文社会科学": ["历史", "文献学", "社会学", "心理学"],
    "技术与工程": ["农业", "建筑学", "计算机科学", "电子学", "能源和电力", "材料", "机械工程"],
}


def construct_prompt(sample: dict) -> str:
    """utils.py:24-52 — instruction + per-type example format, then image
    filename tags rewritten to <图片 i> placeholders."""
    question = sample["question"]
    if sample["type"] == "选择":
        options = ""
        for i in range(1, 5):
            options += f"({chr(ord('A') + i - 1)}) {sample[f'option{i}']}\n"
        prompt = TASK_INSTRUCTIONS[0] + "\n\n" + MULTI_CHOICE_FORMAT.format(
            question, options
        )
    elif sample["type"] == "判断":
        prompt = TASK_INSTRUCTIONS[1] + "\n\n" + TF_FORMAT.format(question)
    else:
        prompt = TASK_INSTRUCTIONS[2] + "\n\n" + SHORT_ANS_FORMAT.format(question)
    for i in range(1, 6):
        prompt = prompt.replace(
            f'<img="{sample[f"image_{i}_filename"]}">', f"<图片 {i}>"
        )
    return prompt


def doc_to_visual(doc: dict) -> List[Any]:
    prompt = construct_prompt(doc)
    tokens = re.findall(r"<图片 \d+>", prompt)
    keys = [t.strip("<>").replace(" ", "_").replace("图片", "image")
            for t in tokens]
    return [to_rgb_array(doc[k]) for k in keys]


def get_multi_choice_info(options: Sequence[str]):
    index2ans = {chr(ord("A") + i): o for i, o in enumerate(options)}
    return index2ans, list(index2ans.keys())


def get_multi_choice_prediction(response: str, all_choices, index2ans) -> str:
    """utils.py:222-261 — the occurrence-count cascade. NOTE the fork's
    second stage counts BARE-LETTER substrings anywhere in the response
    (response.count(f"{choice}")) — ports keep that quirk verbatim."""
    for char in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(char)
    response = " " + response + " "

    candidates: List[str] = []
    for choice in all_choices:
        candidates.extend([choice] * response.count(f"({choice})"))
    if not candidates:
        for choice in all_choices:
            candidates.extend([choice] * response.count(f"{choice}"))
    if not candidates and len(response.split()) >= 1:
        for index, ans in index2ans.items():
            candidates.extend([index] * response.count(ans))
    if not candidates and len(response.split()) >= 1:
        for index, ans in index2ans.items():
            if ans in response:
                candidates.append(index)
    if not candidates:
        return random.choice(all_choices)
    counts = Counter(candidates)
    mx = max(counts.values())
    return "".join(c for c in all_choices if counts.get(c, 0) == mx)


def extract_numbers(string: str) -> List[str]:
    """utils.py:264-281 — Chinese-comma thousands, scientific notation,
    plain numbers."""
    pattern_commas = r"-?\d{1,3}(?:，\d{3})+"
    pattern_scientific = r"-?\d+(?:\.\d+)?[eE][+-]?\d+"
    pattern_simple = r"-?(?:\d+\.\d+|\.\d+|\d+)(?![eE][+-]?\d+)(?!，\d)"
    return (re.findall(pattern_commas, string)
            + re.findall(pattern_scientific, string)
            + re.findall(pattern_simple, string))


def _check_is_number(string: str) -> bool:
    try:
        float(string.replace(",", ""))
        return True
    except ValueError:
        return False


def _count_letters(string: str) -> int:
    return sum("a" <= c <= "z" or "A" <= c <= "Z" for c in string)


def normalize_str(string, answer) -> List[Any]:
    """utils.py:296-314: numbers round to 2 decimals; strings much longer
    than the answer are dropped."""
    if string is None:
        return [string]
    string = string.strip()
    if _check_is_number(string):
        return [round(float(string.replace(",", "")), 2)]
    if (len(string) > len(answer) + 20
            or _count_letters(string) > _count_letters(answer) + 2):
        return []
    return [string]


def _key_subresponses(response: str, indicators: List[str],
                      equation_tail: bool) -> List[str]:
    """Shared key-sentence extractor (utils.py:322-346,369-393): split on
    。/newline, take the shortest tail after any indicator word; the LAST
    sub-response may also split on '=' (fill-in-blank only)."""
    response = response.strip("。").strip()
    subs = re.split(r"。|\n", response)
    keys: List[str] = []
    for index, resp in enumerate(subs):
        inds = list(indicators)
        if equation_tail and index == len(subs) - 1:
            inds.append("=")
        shortest = None
        for ind in inds:
            if ind in resp:
                tail = resp.split(ind)[-1].strip()
                if shortest is None or len(tail) < len(shortest):
                    shortest = tail
        if shortest and shortest.strip() not in [
            ":", ",", ".", "!", "?", ";", ":", "'"
        ]:
            keys.append(shortest)
    return keys or [response]


FILL_INDICATORS = ["是", "为", "所以", "等于", "方案", "选择", "正确答案",
                   "因此", "最后", "答案", "结果"]
TF_INDICATORS = ["是", "为", "所以", "判断", "陈述", "说法", "表达", "答案",
                 "结果"]


def get_fill_blank_prediction(response: str, answer) -> List[Any]:
    keys = _key_subresponses(response, FILL_INDICATORS, equation_tail=True)
    pred_list = keys.copy()
    for resp in keys:
        pred_list.extend(extract_numbers(resp))
    out: List[Any] = []
    for p in pred_list:
        out.extend(normalize_str(p, answer))
    return list(set(out))


def get_tf_prediction(response: str) -> List[str]:
    return list(set(_key_subresponses(response, TF_INDICATORS,
                                      equation_tail=False)))


POSITIVE_KEYWORDS = ["正确", "对", "准确", "肯定", "对的"]
NEGATIVE_KEYWORDS = ["不对", "错误", "不正确", "不准确", "不合适", "否定",
                     "错的", "错"]
AMBIGUOUS_KEYWORDS = ["对错", "是否正确", "否正确", "或者", "是否", "正确性",
                      "对不"]


def eval_cmmmu(entries: List[dict]) -> Dict[str, Any]:
    """utils.py:147-218 — per-entry judging for the three types, returning
    {correct_num, entries_num, acc} and stamping entry['judge']."""
    correct_cnt = 0
    for entry in entries:
        parsed_pred = entry.get("parsed_pred", "")
        correct = False
        if entry.get("question_type") == "选择":
            if parsed_pred == entry["answer"]:
                correct_cnt += 1
                correct = True
        elif entry.get("question_type") == "填空":
            norm_answers = normalize_str(entry["answer"], entry["answer"])
            for pred in parsed_pred:
                if isinstance(pred, str):
                    for norm_ans in norm_answers:
                        if isinstance(norm_ans, str) and norm_ans in pred:
                            if not correct:
                                correct_cnt += 1
                                correct = True
                            break
                else:
                    if pred in norm_answers:
                        if not correct:
                            correct_cnt += 1
                            correct = True
                        break
        else:
            preds = [w for w in parsed_pred
                     if not any(a in w for a in AMBIGUOUS_KEYWORDS)]
            pos = sum(any(k in p for k in POSITIVE_KEYWORDS) for p in preds)
            neg = sum(
                (not any(k in p for k in POSITIVE_KEYWORDS))
                and any(k in p for k in NEGATIVE_KEYWORDS)
                for p in preds
            )
            if pos > neg:
                result = "对"
            elif neg > pos:
                result = "错"
            else:
                result = random.choice(["对", "错"])
            if result == entry["answer"]:
                correct_cnt += 1
                correct = True
        entry["judge"] = "正确" if correct else "错误"
    n = len(entries)
    if n == 0:
        return {"correct_num": 0, "entries_num": 0, "acc": 0}
    return {"correct_num": correct_cnt, "entries_num": n,
            "acc": correct_cnt / n}


def calculate_ins_level_acc(results: Dict[str, dict]) -> float:
    correct = sum(r["correct_num"] for r in results.values())
    total = sum(r["entries_num"] for r in results.values())
    return correct / total if total else 0


def cmmmu_process_results(doc: dict, results: List[str]) -> Dict[str, Any]:
    pred = results[0]
    if doc["type"] == "选择":
        index2ans, all_choices = get_multi_choice_info(
            [doc[f"option{i}"] for i in range(1, 5)]
        )
        parsed = get_multi_choice_prediction(pred, all_choices, index2ans)
    elif doc["type"] == "判断":
        parsed = get_tf_prediction(pred)
    else:
        parsed = get_fill_blank_prediction(pred, doc["answer"])
    return {"cmmmu_acc": {
        "id": doc["id"], "subdomain": doc["subcategory"],
        "question_type": doc["type"], "answer": doc["answer"],
        "parsed_pred": parsed,
    }}


def cmmmu_aggregate_results(results: List[dict]) -> float:
    """Per-subcategory -> six-domain rollup -> overall instance-level acc
    (utils.py:84-118); the printable per-domain table is attached to the
    function for callers that want it."""
    by_sub = defaultdict(list)
    for r in results:
        by_sub[r["subdomain"]].append(r)
    evaluation = {s: eval_cmmmu(rs) for s, rs in by_sub.items()}
    table: Dict[str, Dict[str, Any]] = {}
    for domain, cats in DOMAIN_CAT2SUB_CAT.items():
        in_domain = {c: evaluation[c] for c in cats if c in evaluation}
        table["Overall-" + domain] = {
            "num": sum(r["entries_num"] for r in in_domain.values()),
            "acc": round(calculate_ins_level_acc(in_domain), 3),
        }
        for c, r in in_domain.items():
            table[c] = {"num": int(r["entries_num"]),
                        "acc": round(r["acc"], 3)}
    overall = calculate_ins_level_acc(evaluation)
    table["Overall"] = {
        "num": sum(r["entries_num"] for r in evaluation.values()),
        "acc": round(overall, 3),
    }
    cmmmu_aggregate_results.last_table = table
    return table["Overall"]["acc"]


def cmmmu_task(docs: Sequence[dict], split: str = "val") -> TaskConfig:
    """cmmmu_val (tasks/cmmmu/cmmmu_val.yaml). docs: the lmms-lab/CMMMU rows
    (question/type/option1-4/answer/subcategory/id/image_1..5 +
    image_i_filename)."""
    return TaskConfig(
        name=f"cmmmu_{split}",
        docs=list(docs),
        doc_to_visual=doc_to_visual,
        doc_to_text=lambda d: construct_prompt(d),
        process_results=cmmmu_process_results,
        generation_kwargs={"max_new_tokens": 16, "temperature": 0,
                           "do_sample": False},
        metric_aggregation={"cmmmu_acc": cmmmu_aggregate_results},
        split=split,
    )
