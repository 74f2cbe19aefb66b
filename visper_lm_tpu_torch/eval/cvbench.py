"""CV-Bench evaluation: loader + batched decode + scorer (the port's
counterpart of visper_lm_tpu/eval/cvbench.py: images are read by
`data.image_io.load_image`).

Parity surface:
  * prompt construction (model_cvbench_loader.py:37-49): question + the literal
    "Only answer the option..." suffix;
  * greedy decode, temperature 0 (scripts/eval/cv-bench.sh:12), max_new_tokens 128;
  * scoring (eval_cv_bench.py:26-78): '(X)' letter extraction, accuracy =
    (mean(ADE20K, COCO) + Omni3D) / 2 plus per-task accuracies.

The reference shards across GPUs with shell --num-chunks/--chunk-idx + file merge
(cv-bench.sh:8-27); here a single process batches the whole set through the compiled
decoder (chunk/merge helpers retained for multi-host runs).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
from typing import Dict, List, Optional, Sequence

from visper_lm_tpu_torch.data.image_io import load_image

PROMPT_SUFFIX = (
    "\nOnly answer the option as the output. For example, if your answer is the "
    "option A, answer (A)."
)


def load_jsonl(path: str) -> List[dict]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def prepare_cvbench(path: str) -> List[dict]:
    dataset = load_jsonl(os.path.join(path, "test.jsonl"))
    return [
        {
            "image": os.path.join(path, rec["filename"]),
            "question": rec["prompt"] + PROMPT_SUFFIX,
            "answer": rec["answer"],
            "task": rec["task"],
            "source": rec["source"],
        }
        for rec in dataset
    ]


def get_chunk(data: List[dict], num_chunks: int, chunk_idx: int) -> List[dict]:
    """Shell-fanout compatibility (model_cvbench_loader.py:19-27)."""
    chunk_size = math.ceil(len(data) / num_chunks)
    chunks = [data[i : i + chunk_size] for i in range(0, len(data), chunk_size)]
    return chunks[chunk_idx]


def extract_choice(prediction: str) -> str:
    """'(X)' extraction (eval_cv_bench.py:28-35)."""
    if "(" in prediction:
        match = re.search(r"\(([A-Z])\)", prediction)
        if match:
            return "(" + match.group(1) + ")"
    return "(" + (prediction[:1] or "?") + ")"


def score_cvbench(answers: Sequence[dict]) -> Dict[str, float]:
    """answers: [{prediction, answer, task, source}]. Reference accuracy formula."""
    results: Dict[str, List[bool]] = {}
    task_results: Dict[str, List[bool]] = {}
    for rec in answers:
        ok = extract_choice(rec["prediction"]) == rec["answer"]
        results.setdefault(rec["source"], []).append(ok)
        task_results.setdefault(rec["task"], []).append(ok)

    def mean(xs: List[bool]) -> float:
        return sum(xs) / max(len(xs), 1)

    acc_2d = (mean(results.get("ADE20K", [])) + mean(results.get("COCO", []))) / 2
    acc_3d = mean(results.get("Omni3D", []))
    scores: Dict[str, float] = {
        "Overall": (acc_2d + acc_3d) / 2,
        "3D": acc_3d,
        "2D": acc_2d,
    }
    for task in ("Count", "Depth", "Relation", "Distance"):
        if task in task_results:
            scores[task] = mean(task_results[task])
    return scores


def run_cvbench(
    model,
    data: Sequence[dict],
    *,
    batch_size: int = 16,
    max_new_tokens: int = 128,
    output_path: Optional[str] = None,
) -> Dict[str, float]:
    """Batched greedy decode over the benchmark with a VisperModel."""
    answers = []
    for start in range(0, len(data), batch_size):
        chunk = list(data[start : start + batch_size])
        images = [load_image(r["image"]) for r in chunk]
        questions = [r["question"] for r in chunk]
        preds = model.chat(questions, images, max_new_tokens=max_new_tokens)
        for rec, pred in zip(chunk, preds):
            answers.append(
                {
                    "question": rec["question"],
                    "prediction": pred,
                    "answer": rec["answer"],
                    "task": rec["task"],
                    "source": rec["source"],
                }
            )
    if output_path:
        with open(output_path, "w") as f:
            for a in answers:
                f.write(json.dumps(a) + "\n")
    return score_cvbench(answers)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--results-file", required=True)
    args = parser.parse_args()
    answers = load_jsonl(args.results_file)
    # merged chunk files store fields as single-element lists (reference format)
    norm = [
        {k: (v[0] if isinstance(v, list) else v) for k, v in a.items()} for a in answers
    ]
    scores = score_cvbench(norm)
    print(json.dumps(scores, indent=2))
    with open(args.results_file.replace(".jsonl", "_score.json"), "w") as f:
        json.dump(scores, f, indent=2)


if __name__ == "__main__":
    main()
