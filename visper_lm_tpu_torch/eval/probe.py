"""Probing evaluation: per-layer cosine similarity + task-grounded metrics
(the port's counterpart of visper_lm_tpu/eval/probe.py: the metrics are a
copy; images are read by `data.image_io.load_image`, generated images go
through the port's unCLIP pipeline and Pillow's Lanczos resize in numpy,
`data.mm_utils.resize_lanczos`, and are written by `write_png`).

Parity surface:
  * cos-sim probe eval (eval_probe_dsg.py:200-225): per tapped layer,
    1 - CosineEmbeddingLoss == mean cosine similarity between predicted and teacher
    embeddings over COCO-val; per-layer averaging (get_probe_dsg_scores.py:29-48);
  * DA-2K closer-point accuracy (get_probe_task_scores.py:106-161): for each
    annotated point pair, check the predicted depth ordering;
  * semantic-segmentation mIoU vs COCO panoptic-derived GT
    (get_probe_task_scores.py:54-104);
  * FID for generation quality (vendored fid_score.py in the reference) — the
    canonical InceptionV3 extractor lives in eval/inception.py, the FID math in
    eval/fid.py, and render_gen_predictions below produces the per-layer images.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from visper_lm_tpu_torch.data.image_io import load_image, write_png
from visper_lm_tpu_torch.data.mm_utils import resize_lanczos


def cosine_similarity(pred: np.ndarray, target: np.ndarray) -> float:
    """Mean cosine similarity over the batch; inputs (B, ...) flattened per sample.

    Equals 1 - torch.nn.CosineEmbeddingLoss(target=1) as used by the reference.
    """
    p = pred.reshape(pred.shape[0], -1).astype(np.float64)
    t = target.reshape(target.shape[0], -1).astype(np.float64)
    p = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-12)
    t = t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    return float(np.mean(np.sum(p * t, axis=-1)))


def accumulate_layer_scores(
    records: Sequence[Mapping[str, Any]]
) -> Dict[str, Dict[int, float]]:
    """Average per-(task, layer) cosine sims across shards/records
    (merge_json.py + get_probe_dsg_scores.py behavior)."""
    sums: Dict[str, Dict[int, List[float]]] = {}
    for rec in records:
        for task, layers in rec.items():
            for layer, score in layers.items():
                sums.setdefault(task, {}).setdefault(int(layer), []).append(float(score))
    return {
        task: {layer: float(np.mean(vals)) for layer, vals in layers.items()}
        for task, layers in sums.items()
    }


def da2k_accuracy(
    depth_map: np.ndarray,
    point_pairs: Sequence[Tuple[Tuple[int, int], Tuple[int, int], str]],
) -> float:
    """DA-2K metric: fraction of point pairs whose predicted depth ordering matches.

    depth_map: (H, W) relative depth, LARGER = closer (DAv2 convention).
    point_pairs: [((y1, x1), (y2, x2), closer)] with closer in {"point1", "point2"}.
    """
    if not point_pairs:
        return 0.0
    correct = 0
    for (y1, x1), (y2, x2), closer in point_pairs:
        d1 = float(depth_map[y1, x1])
        d2 = float(depth_map[y2, x2])
        pred_closer = "point1" if d1 > d2 else "point2"
        correct += pred_closer == closer
    return correct / len(point_pairs)


class MeanIoU:
    """Streaming confusion-matrix mIoU (get_probe_task_scores.py:54-104 semantics:
    ignore label 255, IoU per class present in GT, mean over valid classes)."""

    def __init__(self, num_classes: int, ignore_label: int = 255):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.conf = np.zeros((num_classes, num_classes), dtype=np.int64)

    def update(self, pred: np.ndarray, gt: np.ndarray) -> None:
        valid = gt != self.ignore_label
        p = pred[valid].astype(np.int64)
        g = gt[valid].astype(np.int64)
        idx = g * self.num_classes + p
        binc = np.bincount(idx, minlength=self.num_classes ** 2)
        self.conf += binc.reshape(self.num_classes, self.num_classes)

    def compute(self) -> Dict[str, float]:
        inter = np.diag(self.conf).astype(np.float64)
        union = self.conf.sum(0) + self.conf.sum(1) - np.diag(self.conf)
        present = union > 0
        iou = np.zeros(self.num_classes)
        iou[present] = inter[present] / union[present]
        return {
            "mIoU": float(iou[present].mean()) if present.any() else 0.0,
            "pACC": float(inter.sum() / max(self.conf.sum(), 1)),
        }


def run_probe_cos_sim(
    model,
    examples: Sequence[dict],
    teacher_targets_fn,
    *,
    output_path: Optional[str] = None,
) -> Dict[str, Dict[int, float]]:
    """Probe eval loop: for each (image, caption) example compute per-layer
    predicted embeddings and cosine-compare against teacher targets.

    teacher_targets_fn(image) -> {task: np.ndarray target}, image a uint8
    (H, W, 3) array. The interpretations run on the model's device (the
    flash-attention kernel on CUDA).
    """
    records = []
    for rec in examples:
        image = load_image(rec["image"])
        interp = model.get_visual_interpretations(rec["question"], image)
        targets = teacher_targets_fn(image)
        scores: Dict[str, Dict[int, float]] = {}
        for task, layers in interp.items():
            if task not in targets:
                continue
            for layer, pred in layers.items():
                scores.setdefault(task, {})[int(layer)] = cosine_similarity(
                    np.asarray(pred), np.asarray(targets[task])
                )
        records.append(scores)
    merged = accumulate_layer_scores(records)
    if output_path:
        with open(output_path, "w") as f:
            json.dump(merged, f, indent=2)
    return merged


def render_gen_predictions(
    model,
    examples: Sequence[dict],
    pipe,
    genpipe_cfg,
    out_dir: str,
    *,
    num_inference_steps: int = 25,
    image_size: int = 256,
) -> List[str]:
    """Probe-task gen rendering (eval_probe_task.py:222-237): per tapped layer,
    decode the predicted 1x1024 embedding through the unCLIP pipeline (`pipe`,
    the port's `models.genpipe.GenPipe`, its draws seeded with 0) and save the
    image resized to 256x256 (Pillow's LANCZOS) under
    out_dir/gen/layer_{L}/{name}.png. Returns paths.
    """
    import os

    from visper_lm_tpu_torch.models.genpipe import generate_from_embeds

    paths = []
    for rec in examples:
        image = load_image(rec["image"])
        interp = model.get_visual_interpretations(rec["question"], image)
        fname = os.path.basename(rec["image"]).rsplit(".", 1)[0] + ".png"
        for layer, emb in interp.get("gen", {}).items():
            imgs = generate_from_embeds(
                pipe, genpipe_cfg,
                np.asarray(emb).reshape(1, -1),
                num_inference_steps=num_inference_steps,
            )
            img = resize_lanczos((imgs[0] * 255).astype(np.uint8), (image_size, image_size))
            d = os.path.join(out_dir, "gen", f"layer_{layer + 1}")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, fname)
            write_png(path, img)
            paths.append(path)
    return paths
