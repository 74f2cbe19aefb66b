"""OCR-VQA dataset fetcher (counterpart of visper_lm_tpu/data/download_ocr_vqa.py;
the reference's datasets/ocr_vqa/loadDataset.py).

Fetches the images that the OCR-VQA dataset JSON names ({key: {"imageURL":
...}}) into --output-dir as <key><extension of the URL>, skipping those
already there. --verify-only fetches nothing: it counts what is present
and what is missing. A `file://` URL is read from the local disk, so a
mirror on disk needs no network:

    python -m visper_lm_tpu_torch.data.download_ocr_vqa --dataset-json dataset.json \\
        --output-dir images [--limit N] [--verify-only]
"""

from __future__ import annotations

import argparse
import json
import os
import urllib.request
from typing import Optional, Sequence, Tuple


def main(argv: Optional[Sequence[str]] = None) -> Tuple[int, int]:
    """The JAX package's CLI, the same arguments and output; returns (images
    present, images missing or failed)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset-json", required=True, help="OCR-VQA dataset.json")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--verify-only", action="store_true")
    args = p.parse_args(argv)

    with open(args.dataset_json) as f:
        data = json.load(f)
    os.makedirs(args.output_dir, exist_ok=True)
    n_ok, n_missing = 0, 0
    items = list(data.items())[: args.limit or len(data)]
    for key, rec in items:
        url = rec["imageURL"]
        ext = os.path.splitext(url)[1] or ".jpg"
        path = os.path.join(args.output_dir, key + ext)
        if os.path.exists(path):
            n_ok += 1
            continue
        if args.verify_only:
            n_missing += 1
            continue
        try:
            urllib.request.urlretrieve(url, path)
            n_ok += 1
        except Exception as e:  # noqa: BLE001 - report and continue, as the JAX script does
            print(f"failed {key}: {e}")
            n_missing += 1
    print(f"images present: {n_ok}, missing/failed: {n_missing}")
    return n_ok, n_missing


if __name__ == "__main__":
    main()
