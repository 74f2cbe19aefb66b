"""Supervised datasets and modality-grouped batching (counterpart of
visper_lm_tpu/data/dataset.py).

  * lazy JSON / JSONL conversations, each with an optional image;
  * images decoded into uint8 (H, W, 3) arrays by `image_io.load_image` (the
    port's PNG and .npy readers; PIL only for other formats, imported there);
  * tower pixels by `mm_utils.process_images` per aspect-ratio mode ('square' |
    'pad' | 'anyres'); the decoded arrays ride each batch under the host-only
    key RAW_IMAGES (None for a text-only sample), for the teachers' pixels;
  * per-task masks (1 = real image, 0 = text-only);
  * modality-grouped length bucketing (`modality_grouped_order`) as a
    deterministic shuffled-megabatch sampler;
  * batches lowered to splice plans (data/collate.py) at bucketed lengths.

`BatchIterator` fans the per-sample decode over a thread pool
(`num_workers`, order kept), skips the leading `skip_batches` of an epoch
without decoding them (resume), and strides whole batches over
`process_count` processes from one shared order.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from visper_lm_tpu_torch.config import VLMConfig
from visper_lm_tpu_torch.constants import IMAGE_TOKEN_INDEX
from visper_lm_tpu_torch.data import mm_utils
from visper_lm_tpu_torch.data.collate import build_splice_plan, collate_plans, pad_to_bucket
from visper_lm_tpu_torch.data.image_io import load_image
from visper_lm_tpu_torch.data.preprocess import preprocess, preprocess_multimodal

# the batch key of the decoded uint8 images (host only: the trainer drops it)
RAW_IMAGES = "raw_images"


def prepare_coco_probe_records(coco_caption_json: str, image_prefix: str = "train2017/") -> List[dict]:
    """Probe-training conversations from COCO captions: one 'Describe the
    image in two lines.' turn per image with a placeholder answer (NTP is
    unused in probe training)."""
    with open(coco_caption_json) as f:
        data = json.load(f)
    id_to_file = {im["id"]: im["file_name"] for im in data["images"]}
    seen = set()
    out = []
    for ann in data["annotations"]:
        image_id = ann["image_id"]
        if image_id in seen:
            continue
        seen.add(image_id)
        out.append({
            "conversations": [
                {"from": "human", "value": "Describe the image in two lines.\n<image>"},
                {"from": "gpt", "value": "n"},
            ],
            "image": image_prefix + id_to_file[image_id],
        })
    return out


def read_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


@dataclasses.dataclass
class DataConfig:
    data_path: str
    image_folder: Optional[str] = None
    image_aspect_ratio: str = "square"       # square | pad | anyres
    image_size: int = 336
    model_max_length: int = 4096
    grid_pinpoints: Optional[str] = None     # for anyres, e.g. "[[336,672],...]"
    group_by_modality_length: bool = False


class SupervisedDataset:
    """Lazy conversations + image dataset."""

    def __init__(self, cfg: DataConfig, tokenizer, vlm_cfg: VLMConfig):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.vlm_cfg = vlm_cfg
        if cfg.data_path.endswith(".jsonl"):
            self.records = read_jsonl(cfg.data_path)
        else:
            with open(cfg.data_path) as f:
                self.records = json.load(f)

    def __len__(self) -> int:
        return len(self.records)

    @property
    def modality_lengths(self) -> List[int]:
        """Signed whitespace lengths: positive = has an image."""
        out = []
        for sample in self.records:
            n = sum(len(c["value"].split()) for c in sample["conversations"])
            out.append(n if "image" in sample else -n)
        return out

    def _load_image(self, rec: dict) -> Optional[np.ndarray]:
        if "image" not in rec:
            return None
        path = rec["image"]
        if self.cfg.image_folder:
            path = os.path.join(self.cfg.image_folder, path)
        return load_image(path)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        rec = self.records[i]
        has_image = "image" in rec
        image = self._load_image(rec)
        sources = copy.deepcopy([rec["conversations"]])
        if has_image:
            sources = preprocess_multimodal(sources)
        ex = preprocess(
            sources, self.tokenizer, self.vlm_cfg.conv_template, has_image=has_image,
            model_max_length=self.cfg.model_max_length,
        )[0]
        out: Dict[str, Any] = {
            "input_ids": ex.input_ids,
            "labels": ex.labels,
            "has_image": has_image,
            "raw_image": image,
        }
        if image is not None:
            pixels = mm_utils.process_images(
                [image], image_aspect_ratio=self.cfg.image_aspect_ratio,
                image_size=self.cfg.image_size, grid_pinpoints=self.cfg.grid_pinpoints,
            )
            out["pixels"] = pixels[0]
        else:
            out["pixels"] = np.zeros((self.cfg.image_size, self.cfg.image_size, 3), np.float32)
        return out


def modality_grouped_order(
    modality_lengths: Sequence[int], batch_size: int, seed: int
) -> List[int]:
    """Shuffle within each modality, cut megabatches of 50 batches sorted by
    length into batches, and shuffle the batches (JAX's order, from the same
    numpy generator)."""
    rng = np.random.default_rng(seed)
    mm = [i for i, n in enumerate(modality_lengths) if n > 0]
    txt = [i for i, n in enumerate(modality_lengths) if n <= 0]

    def megabatches(indices: List[int]) -> List[List[int]]:
        if not indices:
            return []
        idx = np.array(indices)
        rng.shuffle(idx)
        mega = batch_size * 50
        out = []
        for k in range(0, len(idx), mega):
            chunk = idx[k:k + mega]
            lens = np.abs(np.array([modality_lengths[i] for i in chunk]))
            order = np.argsort(-lens)
            out.extend(list(chunk[order][j:j + batch_size]) for j in range(0, len(chunk), batch_size))
        return out

    batches = megabatches(mm) + megabatches(txt)
    rng.shuffle(batches)
    return [int(i) for b in batches for i in b]


class BatchIterator:
    """Splice-plan batches at bucketed static lengths, numpy on the host."""

    def __init__(
        self,
        dataset: SupervisedDataset,
        batch_size: int,
        *,
        seq_buckets: Sequence[int] = (512, 1024, 2048, 4096),
        seed: int = 0,
        drop_last: bool = True,
        distill_tasks: Sequence[str] = (),
        process_index: int = 0,
        process_count: int = 1,
        num_workers: int = 0,
        skip_batches: int = 0,
    ):
        """batch_size is per process: with process_count > 1 every process
        computes the same order from the shared seed and takes a disjoint
        strided share of its batches. num_workers > 0 decodes the samples
        of a batch on a thread pool (order kept); skip_batches > 0 skips that
        many leading batches of the epoch without decoding them."""
        if not 0 <= process_index < process_count:
            raise ValueError(f"process {process_index} of {process_count}")
        self.ds = dataset
        self.batch_size = batch_size
        self.seq_buckets = seq_buckets
        self.seed = seed
        self.drop_last = drop_last
        self.distill_tasks = tuple(distill_tasks)
        self.process_index = process_index
        self.process_count = process_count
        self.num_workers = num_workers
        self.skip_batches = skip_batches

    def order(self) -> List[int]:
        """This process's example order for the epoch."""
        if self.ds.cfg.group_by_modality_length:
            order = modality_grouped_order(self.ds.modality_lengths, self.batch_size, self.seed)
        else:
            order = list(np.random.default_rng(self.seed).permutation(len(self.ds)))
        if self.process_count > 1:
            # whole per-process batches stay contiguous in the shared order (the
            # modality grouping survives), then batches are strided over the
            # processes; every process gets the same number of batches
            bs = self.batch_size
            n_global = (len(order) // (bs * self.process_count)) * self.process_count
            batches = [order[k * bs:(k + 1) * bs] for k in range(n_global)]
            order = [i for b in batches[self.process_index::self.process_count] for i in b]
        return order

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = self.order()
        pool = None
        if self.num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            yield from self._batches(order, pool)
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

    def _batches(self, order: List[int], pool) -> Iterator[Dict[str, Any]]:
        vlm = self.ds.vlm_cfg
        d = vlm.distill
        ntt = d.num_task_tokens if d else 0
        n_tasks = len(d.task_order()) if d else 0
        n, bs = len(order), self.batch_size
        for start in range(self.skip_batches * bs, n - (bs - 1 if self.drop_last else 0), bs):
            idxs = order[start:start + bs]
            if pool is not None:
                examples = list(pool.map(self.ds.__getitem__, idxs))
            else:
                examples = [self.ds[i] for i in idxs]
            spliced = [
                len(ex["input_ids"])
                + sum(t == IMAGE_TOKEN_INDEX for t in ex["input_ids"])
                * (vlm.num_image_tokens + ntt * n_tasks - 1)
                for ex in examples
            ]
            if self.process_count > 1:
                # processes agree on the static length without talking: the top bucket
                max_len = self.seq_buckets[-1]
            else:
                max_len = pad_to_bucket(max(spliced), self.seq_buckets)
            plans = [
                build_splice_plan(
                    ex["input_ids"], ex["labels"], max_len,
                    num_image_tokens=vlm.num_image_tokens, num_task_tokens=ntt,
                    num_tasks=n_tasks,
                )
                for ex in examples
            ]
            images = np.stack([ex["pixels"] for ex in examples]).astype(np.float32)
            has_img = np.array([1.0 if ex["has_image"] else 0.0 for ex in examples], np.float32)
            batch = collate_plans(plans, images=images,
                                  extra={f"{t}_mask": has_img for t in self.distill_tasks})
            batch[RAW_IMAGES] = [ex["raw_image"] for ex in examples]
            yield batch
