"""MMStar evaluation: loader + batched decode + L2-category scorer (the
port's counterpart of visper_lm_tpu/eval/mmstar.py: images are read by
`data.image_io.load_image`).

Parity surface:
  * prompt construction (model_mmstar_loader.py:38-40): question + the literal
    "Answer with the option's letter..." suffix;
  * scoring (mmstar/evaluate/mmstar.py): letter match with the '(', 'option ',
    'the answer is ' fallbacks; per-L2-category table; category totals /250,
    final score /1500.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Dict, List, Optional, Sequence

from visper_lm_tpu_torch.data.image_io import load_image

PROMPT_SUFFIX = (
    "\nAnswer with the option's letter from the given choices directly, "
    "such as answer letter 'A' only. \n"
)

MMSTAR_L2 = {
    "coarse perception": [
        "image scene and topic", "image style & quality", "image emotion",
    ],
    "fine-grained perception": [
        "object counting", "recognition", "localization",
    ],
    "instance reasoning": [
        "single-instance reasoning",
        "cross-instance attribute reasoning",
        "cross-instance relation reasoning",
    ],
    "logical reasoning": [
        "code & sequence reasoning", "diagram reasoning", "common reasoning",
    ],
    "science & technology": [
        "biology & chemistry & physics",
        "electronics & energy & mechanical eng.",
        "geography & earth science & agriculture",
    ],
    "math": [
        "geometry", "numeric commonsense and calculation", "statistical reasoning",
    ],
}


def prepare_mmstar(path: str) -> List[dict]:
    """Load the MMStar val split via HF datasets and cache images to disk
    (model_mmstar_loader.py:30-50)."""
    from datasets import load_dataset

    os.makedirs(f"{path}/images", exist_ok=True)
    dataset = load_dataset(path, "val")["val"]
    data = []
    for i in range(len(dataset)):
        img_path = f"{path}/images/{i}.jpeg"
        if not os.path.exists(img_path):
            dataset[i]["image"].save(img_path)
        data.append(
            {
                "image": img_path,
                "question": dataset[i]["question"] + PROMPT_SUFFIX,
                "answer": dataset[i]["answer"],
                "category": dataset[i]["category"],
                "l2_category": dataset[i]["l2_category"],
            }
        )
    return data


def _prediction_matches(answer: str, predict: str) -> bool:
    answer = answer.lower().strip().replace("\n", " ")
    predict = predict.lower().strip().replace("\n", " ")
    try:
        if answer == predict[0]:
            return True
        if predict[0] == "(" and answer == predict[1]:
            return True
        if predict[0:7] == "option " and answer == predict[7]:
            return True
        if predict[0:14] == "the answer is " and answer == predict[14]:
            return True
    except IndexError:
        pass
    return False


def score_mmstar(answers: Sequence[dict]) -> Dict[str, float]:
    """answers: [{prediction, answer, category, l2_category}]."""
    score_l2 = {k: {l2: 0 for l2 in v} for k, v in MMSTAR_L2.items()}
    counter = copy.deepcopy(score_l2)
    for rec in answers:
        cat, l2 = str(rec["category"]), str(rec["l2_category"])
        counter[cat][l2] += 1
        if _prediction_matches(str(rec["answer"]), str(rec["prediction"])):
            score_l2[cat][l2] += 1

    scores: Dict[str, float] = {"final score": 0.0}
    total = 0.0
    for cat, l2s in score_l2.items():
        cat_total = 0
        for l2, v in l2s.items():
            scores[f"{cat}({l2})"] = float(v) / max(float(counter[cat][l2]), 1.0)
            cat_total += v
        total += cat_total
        scores[cat] = cat_total / 250.0
    scores["final score"] = total / 1500.0
    return scores


def run_mmstar(
    model,
    data: Sequence[dict],
    *,
    batch_size: int = 16,
    max_new_tokens: int = 128,
    output_path: Optional[str] = None,
) -> Dict[str, float]:
    answers = []
    for start in range(0, len(data), batch_size):
        chunk = list(data[start : start + batch_size])
        images = [load_image(r["image"]) for r in chunk]
        preds = model.chat(
            [r["question"] for r in chunk], images, max_new_tokens=max_new_tokens
        )
        for rec, pred in zip(chunk, preds):
            answers.append({**{k: rec[k] for k in ("answer", "category", "l2_category")},
                            "prediction": pred})
    if output_path:
        with open(output_path, "w") as f:
            for a in answers:
                f.write(json.dumps(a) + "\n")
    return score_mmstar(answers)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--results-file", required=True)
    args = parser.parse_args()
    answers = []
    with open(args.results_file) as f:
        for line in f:
            if line.strip():
                rec = json.loads(line)
                answers.append(
                    {k: (v[0] if isinstance(v, list) else v) for k, v in rec.items()}
                )
    scores = score_mmstar(answers)
    print(json.dumps(scores, indent=2))
    with open(args.results_file.replace(".jsonl", "_score.json"), "w") as f:
        json.dump(scores, f, indent=2)


if __name__ == "__main__":
    main()
