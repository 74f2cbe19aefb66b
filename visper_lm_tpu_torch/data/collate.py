"""Static-shape splice plans (a copy of `build_splice_plan` and `collate_plans`
from visper_lm_tpu/data/collate.py).

For every example the token stream (text ids with IMAGE_TOKEN_INDEX sentinels)
is lowered into fixed-length arrays

    text_ids   (T,) int32 — token id at TEXT positions, 0 elsewhere
    token_type (T,) int32 — SEG_PAD / SEG_TEXT / SEG_IMAGE / SEG_TASK
    src_index  (T,) int32 — image-feature row or task-token-table row
    labels     (T,) int32 — NTP labels, IGNORE_INDEX on non-text and prompt spans
    seq_length ()   int32 — number of non-pad positions

and the model builds inputs_embeds with one gather-select
(models/vlm.py:splice_embeddings).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from visper_lm_tpu_torch.constants import (
    IGNORE_INDEX,
    IMAGE_TOKEN_INDEX,
    SEG_IMAGE,
    SEG_PAD,
    SEG_TASK,
    SEG_TEXT,
)


@dataclasses.dataclass
class SplicePlan:
    text_ids: np.ndarray
    token_type: np.ndarray
    src_index: np.ndarray
    labels: np.ndarray
    seq_length: int


def build_splice_plan(
    input_ids: Sequence[int],
    labels: Optional[Sequence[int]],
    max_len: int,
    *,
    num_image_tokens: int = 576,
    tokens_per_image: Optional[int] = None,
    num_task_tokens: int = 0,
    num_tasks: int = 0,
    image_feature_indices: Optional[Sequence[np.ndarray]] = None,
) -> SplicePlan:
    """Lower one example to a fixed-length splice plan.

    Args:
      input_ids: token ids, IMAGE_TOKEN_INDEX (-200) marks each image.
      labels: per-token labels aligned with input_ids, or None (inference).
      max_len: static sequence length (pad/truncate target).
      num_image_tokens: image feature tokens spliced per image.
      num_task_tokens/num_tasks: task tokens appended after EACH image span.
      image_feature_indices: per-image explicit feature-buffer indices;
        overrides the sequential layout.
    """
    if labels is None:
        labels = [IGNORE_INDEX] * len(input_ids)
    tokens_per_image = tokens_per_image or num_image_tokens
    task_total = num_task_tokens * num_tasks

    text_ids = np.zeros((max_len,), dtype=np.int32)
    token_type = np.full((max_len,), SEG_PAD, dtype=np.int32)
    src_index = np.zeros((max_len,), dtype=np.int32)
    out_labels = np.full((max_len,), IGNORE_INDEX, dtype=np.int32)

    pos = 0
    image_ordinal = 0

    def emit_text(tok: int, lab: int) -> None:
        nonlocal pos
        if pos >= max_len:
            return
        text_ids[pos] = tok
        token_type[pos] = SEG_TEXT
        out_labels[pos] = lab
        pos += 1

    def emit_image() -> None:
        nonlocal pos, image_ordinal
        if image_feature_indices is not None:
            indices = np.asarray(image_feature_indices[image_ordinal], dtype=np.int32)
        else:
            base = image_ordinal * tokens_per_image
            indices = base + np.arange(tokens_per_image, dtype=np.int32)
        for j in indices:
            if pos >= max_len:
                break
            token_type[pos] = SEG_IMAGE
            src_index[pos] = j
            pos += 1
        image_ordinal += 1
        for j in range(task_total):
            if pos >= max_len:
                break
            token_type[pos] = SEG_TASK
            src_index[pos] = j
            pos += 1

    for tok, lab in zip(input_ids, labels):
        if tok == IMAGE_TOKEN_INDEX:
            emit_image()
        else:
            emit_text(int(tok), int(lab))
        if pos >= max_len:
            break

    return SplicePlan(
        text_ids=text_ids,
        token_type=token_type,
        src_index=src_index,
        labels=out_labels,
        seq_length=pos,
    )


def collate_plans(
    plans: Sequence[SplicePlan],
    images: Optional[np.ndarray] = None,
    extra: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """Stack per-example (right-padded) plans into a batch dict."""
    batch = {
        "text_ids": np.stack([p.text_ids for p in plans]),
        "token_type": np.stack([p.token_type for p in plans]),
        "src_index": np.stack([p.src_index for p in plans]),
        "labels": np.stack([p.labels for p in plans]),
        "seq_lengths": np.asarray([p.seq_length for p in plans], dtype=np.int32),
    }
    if images is not None:
        batch["images"] = images
    if extra:
        batch.update(extra)
    return batch
