"""COCO panoptic -> semantic segmentation PNG converter (the port's
counterpart of visper_lm_tpu/eval/pan_to_sem.py: PNGs are read with
`data.image_io.load_image` and written with `write_png`, without PIL; the
semantic maps equal the JAX package's pixel for pixel).

Parity with the reference's detectron2-derived converter
(ola_vlm/eval/convert_pan_to_sem.py): panoptic PNGs encode segment ids as
R + G*256 + B*256^2; each segment maps to its category's contiguous train id;
unlabeled pixels get 255. Used to produce the GT for probe-task mIoU scoring
(get_probe_task_scores.py:54-104).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from visper_lm_tpu_torch.data.image_io import load_image, write_png


def rgb2id(color: np.ndarray) -> np.ndarray:
    """Panoptic COCO id encoding: id = R + G*256 + B*256^2."""
    color = color.astype(np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def build_category_train_ids(categories: List[dict]) -> Dict[int, int]:
    """category_id -> contiguous train id, ordered as in the categories list."""
    return {cat["id"]: i for i, cat in enumerate(categories)}


def panoptic_to_semantic(
    panoptic_png: np.ndarray,          # (H, W, 3) uint8
    segments_info: List[dict],         # [{id, category_id, ...}]
    cat_train_ids: Dict[int, int],
    ignore_label: int = 255,
) -> np.ndarray:
    """(H, W) uint8 semantic map with contiguous train ids, 255 = unlabeled."""
    seg_ids = rgb2id(panoptic_png)
    out = np.full(seg_ids.shape, ignore_label, dtype=np.uint8)
    for seg in segments_info:
        train_id = cat_train_ids.get(seg["category_id"])
        if train_id is not None:
            out[seg_ids == seg["id"]] = train_id
    return out


def convert_dataset(
    panoptic_json: str,
    panoptic_root: str,
    output_dir: str,
    limit: Optional[int] = None,
) -> int:
    """Convert a COCO panoptic annotation set to semantic PNGs. Returns count."""
    with open(panoptic_json) as f:
        data = json.load(f)
    cat_train_ids = build_category_train_ids(data["categories"])
    os.makedirs(output_dir, exist_ok=True)
    n = 0
    for ann in data["annotations"][: limit or len(data["annotations"])]:
        pan = load_image(os.path.join(panoptic_root, ann["file_name"]))
        sem = panoptic_to_semantic(pan, ann["segments_info"], cat_train_ids)
        write_png(os.path.join(output_dir, ann["file_name"]), sem)
        n += 1
    return n


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--panoptic-json", required=True)
    p.add_argument("--panoptic-root", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args()
    n = convert_dataset(args.panoptic_json, args.panoptic_root, args.output_dir, args.limit)
    print(f"converted {n} panoptic maps -> {args.output_dir}")


if __name__ == "__main__":
    main()
