"""Referring-expression grounding tasks: RefCOCO/+/g and ScreenSpot (a copy
of visper_lm_tpu/eval/grounding_tasks.py, its imports pointed at the port).

Native ports of the reference fork's last rule-based task family
(the reference's lmms-eval/lmms_eval/tasks/{refcoco,refcoco+,refcocog,
screenspot}/):

  * REC (comprehension): the model emits a bounding box for a referring
    expression; scored with IoU, ACC@{0.1..0.9} IoU thresholds and
    Center_ACC (gt-box center containment) after extracting the FIRST
    `[x1, x2, x3, x4]` float sequence from the response
    (utils_rec.py:57-161). ScreenSpot additionally rolls scores up by
    platform x element type (mobile/desktop/web x text/icon,
    screenspot/utils_rec.py:128-188).
  * REG (generation): the model describes a highlighted region (bbox drawn
    in red / segmentation polygon); scored with the PTB-tokenized caption
    metrics over the answer set (refcoco/utils.py:37-103 — Bleu_1-4,
    ROUGE_L, CIDEr via eval/caption_metrics.py; ScreenSpot's yaml keeps
    CIDEr only, screenspot/utils.py:7).

Dataset-prep quirks reproduced in `rec_preprocess_docs` (the fork's
process_docs, utils_rec.py:10-43): COCO xywh -> normalized xyxy, and one row
per referring expression (answers exploded). Parity is pinned against the
fork's own utils modules in tests/test_fork_tail_tasks.py.

Images: a doc's image is a uint8 (H, W, 3) array or a PIL image; the
visuals are arrays. The red rectangles are drawn in numpy
(`draw_rectangle`, pixel for pixel PIL's `ImageDraw.rectangle(outline=
"red")`); only the segmentation polygon of `_draw_seg` goes through PIL,
imported inside the function.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from visper_lm_tpu_torch.data.mm_utils import to_rgb_array
from visper_lm_tpu_torch.eval.harness import TaskConfig

REC_METRICS = ["IoU", "ACC@0.1", "ACC@0.3", "ACC@0.5", "ACC@0.7", "ACC@0.9",
               "Center_ACC"]

_FLOAT4 = re.compile(
    r"\[\s*(-?\d+(?:\.\d+)?),\s*(-?\d+(?:\.\d+)?),"
    r"\s*(-?\d+(?:\.\d+)?),\s*(-?\d+(?:\.\d+)?)\s*\]"
)


def parse_float_sequence_within(s: str) -> List[float]:
    """First `[f, f, f, f]` in the response, else the null box
    (refcoco/utils_rec.py:57-78 — screenspot's copy is identical)."""
    m = _FLOAT4.search(s)
    if m:
        return [float(m.group(i)) for i in range(1, 5)]
    return [0, 0, 0, 0]


def compute_iou(box1, box2) -> float:
    x_left, y_top = max(box1[0], box2[0]), max(box1[1], box2[1])
    x_right, y_bottom = min(box1[2], box2[2]), min(box1[3], box2[3])
    inter = max(0, x_right - x_left) * max(0, y_bottom - y_top)
    a1 = (box1[2] - box1[0]) * (box1[3] - box1[1])
    a2 = (box2[2] - box2[0]) * (box2[3] - box2[1])
    return inter / (a1 + a2 - inter)


def compute_center_accuracy(box1, box2) -> bool:
    """True if box2's center lies inside box1 (the ground-truth box)."""
    cx, cy = (box2[0] + box2[2]) / 2, (box2[1] + box2[3]) / 2
    return box1[0] <= cx <= box1[2] and box1[1] <= cy <= box1[3]


_REC_SCORERS = {
    "IoU": compute_iou,
    "Center_ACC": compute_center_accuracy,
    **{f"ACC@{t}": (lambda t: (lambda g, p: compute_iou(g, p) >= t))(t)
       for t in (0.1, 0.3, 0.5, 0.7, 0.9)},
}


def rec_aggregate(results: List[dict], metric: str) -> float:
    """Mean of scorer(gt_bbox, pred) over results — shared by the refcoco
    family and screenspot (identical math, utils_rec.py:164-194)."""
    vals = [_REC_SCORERS[metric](r["bbox"], r["pred"]) for r in results]
    return sum(vals) / len(vals) if vals else 0.0


def rec_preprocess_docs(docs: Sequence[dict]) -> List[dict]:
    """The fork's refcoco_bbox_rec_preprocess_dataset: normalize COCO xywh
    pixel boxes to xyxy in [0,1] by image size, then explode the answer list
    to one row per referring expression (utils_rec.py:10-43)."""
    out = []
    for d in docs:
        w = d.get("image_width") or _width_height(d["image"])[0]
        h = d.get("image_height") or _width_height(d["image"])[1]
        x, y, bw, bh = d["bbox"]
        norm = [x / w, y / h, (x + bw) / w, (y + bh) / h]
        answers = d["answer"] if isinstance(d["answer"], list) else [d["answer"]]
        for a in answers:
            out.append({**d, "bbox": norm, "answer": a,
                        "image_width": w, "image_height": h})
    return out


REC_PROMPT = (
    "Bounding box coordinates are specified in the format (top-left x, "
    "top-left y, bottom-right x, bottom-right y). All values are floating "
    "point numbers bounded between 0 and 1. Please provide the bounding box "
    "coordinate of the region this sentence describes: "
)
# screenspot phrases the same contract around a COMMAND and pins the float
# precision in words (screenspot/utils_rec.py:17-18)
SCREENSPOT_REC_PROMPT = (
    "Bounding box coordinates are specified in the format (top-left x, "
    "top-left y, bottom-right x, bottom-right y). All values are floating "
    "point numbers bounded between 0 and 1 with two decimal places of "
    "precision (e.g., 0.15). Please provide the bounding box coordinates of "
    "the region that corresponds to the command: "
)


def refcoco_rec_task(
    docs: Sequence[dict], family: str = "refcoco", split: str = "val",
    preprocess: bool = True,
) -> TaskConfig:
    """refcoco/refcoco+/refcocog `*_bbox_rec_*` tasks. `family` sets the
    metric prefix like the three forks' yamls (refcoco_IoU / refcoco+_IoU /
    refcocog_IoU). docs: [{image(PIL), bbox xywh px, answer: [refs],
    question_id}]; preprocess=False accepts already-normalized exploded
    rows."""
    docs = rec_preprocess_docs(docs) if preprocess else list(docs)

    def process(doc: dict, results: List[str]) -> Dict[str, Any]:
        pred = parse_float_sequence_within(results[0] if results else "")
        rec = {"answer": doc["answer"], "pred": pred,
               "ann_id": doc.get("question_id"), "bbox": doc["bbox"]}
        return {f"{family}_{m}": rec for m in REC_METRICS}

    return TaskConfig(
        name=f"{family}_bbox_rec_{split}",
        docs=docs,
        doc_to_visual=lambda d: [d["image"]],
        doc_to_text=lambda d: REC_PROMPT + d["answer"],
        process_results=process,
        generation_kwargs={"max_new_tokens": 32, "temperature": 0,
                           "do_sample": False},
        metric_aggregation={
            f"{family}_{m}": (lambda m: lambda rs: rec_aggregate(rs, m))(m)
            for m in REC_METRICS
        },
        split=split,
    )


def _width_height(image) -> Tuple[int, int]:
    if isinstance(image, np.ndarray):
        return image.shape[1], image.shape[0]
    return image.width, image.height


RED = (255, 0, 0)


def draw_rectangle(image: np.ndarray, xy: Sequence[float], width: int = 1) -> np.ndarray:
    """A copy of the (H, W, 3) uint8 `image` with the red outline of the box
    xy = (x0, y0, x1, y1) drawn as PIL's ImageDraw.rectangle(xy,
    outline="red", width=width) draws it (libImaging/Draw.c: coordinates
    truncated toward zero, y0 <= y1; for each of the `width` rings two
    clipped horizontal lines, x0..x1 inclusive, and two vertical ones from
    y0 + width over y1 - 2 width + 1 - y0 points, one a step, the last
    excluded; width 0 draws nothing)."""
    if width == 0:
        return np.array(image, dtype=np.uint8, copy=True)
    if xy[2] < xy[0] or xy[3] < xy[1]:
        # PIL refuses such a box ("x1 must be greater than or equal to x0")
        raise ValueError(f"rectangle {list(xy)}: x1 < x0 or y1 < y0")
    out = np.array(image, dtype=np.uint8, copy=True)
    h, w = out.shape[:2]
    x0, y0, x1, y1 = (int(v) for v in xy)

    def hline(xa: int, y: int, xb: int) -> None:
        if 0 <= y < h and xa < w and xb >= 0:
            out[y, max(xa, 0):min(xb, w - 1) + 1] = RED

    def vline(x: int, ya: int, yb: int) -> None:
        step = 1 if yb >= ya else -1
        ys = ya + step * np.arange(abs(yb - ya))
        ys = ys[(ys >= 0) & (ys < h)]
        if 0 <= x < w:
            out[ys, x] = RED

    for i in range(width):
        hline(x0, y0 + i, x1)
        hline(x0, y1 - i, x1)
        vline(x1 - i, y0 + width, y1 - width + 1)
        vline(x0 + i, y0 + width, y1 - width + 1)
    return out


def _draw_bbox(doc: dict):
    """refcoco_bbox_doc_to_visual: red xyxy rectangle from the xywh bbox
    (refcoco/utils.py:13-20). Draws on a copy — docs stay pristine."""
    b = doc["bbox"]
    return [draw_rectangle(to_rgb_array(doc["image"]), [b[0], b[1], b[0] + b[2], b[1] + b[3]])]


def _draw_seg(doc: dict):
    """refcoco_seg_doc_to_visual: polygon outline (refcoco/utils.py:23-28),
    through PIL's ImageDraw (the one visual here that needs PIL)."""
    from PIL import Image, ImageDraw

    image = Image.fromarray(np.ascontiguousarray(to_rgb_array(doc["image"])))
    ImageDraw.Draw(image).polygon(doc["segmentation"])
    return [np.asarray(image)]


REG_CAPTION_METRICS = ("Bleu_4", "Bleu_3", "Bleu_2", "Bleu_1", "ROUGE_L",
                       "CIDEr")
# the fork also lists METEOR — external-jar boundary, same disposition as the
# caption families (docs/Evaluation.md)


def refcoco_reg_task(
    docs: Sequence[dict], family: str = "refcoco", split: str = "val",
    seg: bool = False,
) -> TaskConfig:
    """refcoco/+/g `*_bbox_*` / `*_seg_*` region-description tasks: caption
    the highlighted region; every metric aggregates over the whole result
    set with the answer LIST as references (refcoco/utils.py:37-103).
    docs: [{image(PIL), bbox xywh px | segmentation, answer: [refs],
    question_id}]."""

    def process(doc: dict, results: List[str]) -> Dict[str, Any]:
        rec = {"answer": list(doc["answer"]),
               "pred": results[0] if results else "",
               "ann_id": doc["question_id"]}
        return {f"{family}_{m}": rec for m in REG_CAPTION_METRICS}

    def aggregate(metric: str):
        def agg(results: List[dict]) -> float:
            from visper_lm_tpu_torch.eval.caption_metrics import compute_caption_metric

            gts = {i: r["answer"] for i, r in enumerate(results)}
            res = {i: [r["pred"]] for i, r in enumerate(results)}
            return compute_caption_metric(metric, gts, res)

        return agg

    kind = "seg" if seg else "bbox"
    return TaskConfig(
        name=f"{family}_{kind}_{split}",
        docs=list(docs),
        doc_to_visual=_draw_seg if seg else _draw_bbox,
        doc_to_text=lambda d: "Provide a short description for this region.",
        process_results=process,
        generation_kwargs={"max_new_tokens": 64, "temperature": 0,
                           "do_sample": False},
        metric_aggregation={
            f"{family}_{m}": aggregate(m) for m in REG_CAPTION_METRICS
        },
        split=split,
    )


# ------------------------------------------------------------- ScreenSpot


def _screenspot_bucket(r: dict) -> str:
    src, typ = r["data_source"], r["data_type"]
    if "ios" in src or "android" in src:
        plat = "mobile"
    elif "macos" in src or "windows" in src:
        plat = "desktop"
    else:
        plat = "web"
    return f"{plat}_{'text' if typ == 'text' else 'icon'}"


def screenspot_rec_aggregate(results: List[dict], metric: str) -> float:
    """Overall mean; per platform x element-type buckets are computed the
    fork's way (screenspot/utils_rec.py:128-188) and attached to the
    aggregator for callers that want the rollup."""
    buckets: Dict[str, List[float]] = {}
    for r in results:
        s = _REC_SCORERS[metric](r["bbox"], r["pred"])
        buckets.setdefault("overall", []).append(s)
        buckets.setdefault(_screenspot_bucket(r), []).append(s)
    screenspot_rec_aggregate.last_buckets = {
        k: sum(v) / len(v) for k, v in buckets.items()
    }
    v = buckets.get("overall", [])
    return sum(v) / len(v) if v else 0.0


def screenspot_rec_task(docs: Sequence[dict]) -> TaskConfig:
    """screenspot_rec_test (screenspot/screenspot_rec_test.yaml). docs:
    [{image(PIL), instruction, bbox xyxy normalized, file_name, data_type,
    data_source}] — the HF dataset ships normalized xyxy already (no
    process_docs in the yaml)."""

    def process(doc: dict, results: List[str]) -> Dict[str, Any]:
        pred = parse_float_sequence_within(results[0] if results else "")
        rec = {"instruction": doc["instruction"], "pred": pred,
               "ann_id": doc["file_name"], "bbox": doc["bbox"],
               "data_type": doc["data_type"],
               "data_source": doc["data_source"]}
        return {f"screenspot_{m}": rec for m in REC_METRICS}

    return TaskConfig(
        name="screenspot_rec_test",
        docs=list(docs),
        doc_to_visual=lambda d: [d["image"]],
        doc_to_text=lambda d: SCREENSPOT_REC_PROMPT + d["instruction"],
        process_results=process,
        generation_kwargs={"max_new_tokens": 32, "temperature": 0,
                           "do_sample": False},
        metric_aggregation={
            f"screenspot_{m}":
            (lambda m: lambda rs: screenspot_rec_aggregate(rs, m))(m)
            for m in REC_METRICS
        },
        split="test",
    )


def screenspot_reg_task(docs: Sequence[dict]) -> TaskConfig:
    """screenspot_reg_test: instruction generation for a highlighted region,
    CIDEr only (screenspot/utils.py:7 trims the metric list); the prompt
    embeds the box coordinates at 2 decimals (utils.py:37-38); the gt box is
    drawn in red width 3 (utils.py:14-20)."""

    def visual(doc: dict):
        return [draw_rectangle(to_rgb_array(doc["image"]), list(doc["bbox"]), width=3)]

    def to_text(doc: dict) -> str:
        b = doc["bbox"]
        return ("Direct a user to interact with the highlighted region "
                f"[{b[0]:.2f}, {b[1]:.2f}, {b[2]:.2f}, {b[3]:.2f}].")

    def process(doc: dict, results: List[str]) -> Dict[str, Any]:
        return {"screenspot_CIDEr": {
            "instruction": doc["instruction"],
            "pred": results[0] if results else "",
            "ann_id": doc["file_name"],
            "data_type": doc["data_type"],
            "data_source": doc["data_source"],
        }}

    def agg_cider(results: List[dict]) -> float:
        from visper_lm_tpu_torch.eval.caption_metrics import compute_caption_metric

        gts = {i: [r["instruction"]] for i, r in enumerate(results)}
        res = {i: [r["pred"]] for i, r in enumerate(results)}
        return compute_caption_metric("CIDEr", gts, res)

    return TaskConfig(
        name="screenspot_reg_test",
        docs=list(docs),
        doc_to_visual=visual,
        doc_to_text=to_text,
        process_results=process,
        generation_kwargs={"max_new_tokens": 64, "temperature": 0,
                           "do_sample": False},
        metric_aggregation={"screenspot_CIDEr": agg_cider},
        split="test",
    )
