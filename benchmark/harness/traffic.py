"""The one traffic generator. It reads a traffic file's parameters and draws
everything from the run's seed: token ids, images, the order of requests.
The sizes (text lengths, answer lengths) are drawn from the file's fixed
`shape_seed`, so every seed runs the same multiset of sizes in another order.

Training traffic is a stream of optimizer steps, each a list of
micro-batches of splice plans (right-padded to the step's length bucket,
as the port's collate pads a batch) with the images the step reads. Serving
traffic is a list of requests (prompt ids, image index, answer length)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
SEG_PAD, SEG_TEXT, SEG_IMAGE, SEG_TASK = 0, 1, 2, 3


@dataclasses.dataclass
class Plan:
    text_ids: np.ndarray
    token_type: np.ndarray
    src_index: np.ndarray
    labels: np.ndarray
    seq_length: int


def splice_plan(ids: Sequence[int], labels: Optional[Sequence[int]], max_len: int,
                num_image_tokens: int, task_total: int) -> Plan:
    """One example's fixed-length splice plan (LLaVA's layout): each image
    token becomes num_image_tokens image rows and then task_total task rows;
    text keeps its id and label; the rest is padding."""
    labels = [IGNORE_INDEX] * len(ids) if labels is None else labels
    text = np.zeros(max_len, np.int32)
    typ = np.full(max_len, SEG_PAD, np.int32)
    src = np.zeros(max_len, np.int32)
    lab = np.full(max_len, IGNORE_INDEX, np.int32)
    pos, image = 0, 0
    for tok, lb in zip(ids, labels):
        if pos >= max_len:
            break
        if tok == IMAGE_TOKEN_INDEX:
            for j in range(num_image_tokens):
                if pos < max_len:
                    typ[pos], src[pos] = SEG_IMAGE, image * num_image_tokens + j
                    pos += 1
            for j in range(task_total):
                if pos < max_len:
                    typ[pos], src[pos] = SEG_TASK, j
                    pos += 1
            image += 1
        else:
            text[pos], typ[pos], lab[pos] = tok, SEG_TEXT, lb
            pos += 1
    return Plan(text, typ, src, lab, pos)


def draw_lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    if spec["dist"] == "uniform":
        return rng.integers(spec["low"], spec["high"] + 1, size=n)
    if spec["dist"] == "lognormal":
        x = rng.lognormal(np.log(spec["median"]), spec["sigma"], size=n)
        return np.clip(np.round(x), spec["low"], spec["high"]).astype(np.int64)
    raise ValueError(f"traffic: no length distribution {spec['dist']!r}")


def bucket(n: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)


def task_tokens(model: dict) -> int:
    d = model.get("distill")
    return d["num_task_tokens"] * len(d["tasks"]) if d else 0


def image_pool(n: int, size: int, seed: int, device) -> np.ndarray:
    """n distinct normalised images (H = W = size), drawn on the device from
    the seed and brought to host memory in one copy."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed) & ((1 << 63) - 1))
    return torch.randn((n, size, size, 3), generator=gen, device=device).cpu().numpy()


class TrainTraffic:
    """Optimizer steps of `per_device_batch` rows as `micro_batch`-row
    micro-batches. The checked steps (`check_steps`) read distinct images;
    later steps draw the pool's images in a seeded order."""

    def __init__(self, model: dict, traffic: dict, seed: int, device):
        self.m, self.t, self.seed = model, traffic, int(seed)
        self.rows = traffic["per_device_batch"]
        self.micro = traffic["micro_batch"]
        self.vocab = model["decoder"]["vocab_size"]
        self.ns = model["num_sys_tokens"]
        self.ni = model["num_image_tokens"]
        self.tt = task_tokens(model)
        rng = np.random.default_rng([self.seed, 1])
        self.sys_ids = rng.integers(3, self.vocab - 10, size=self.ns)
        n_pool = traffic["check_steps"] * self.rows
        self.pools: Dict[str, np.ndarray] = {}
        sizes = {"images": model["tower"]["image_size"]}
        if traffic.get("teachers"):
            t = model["teachers"]
            sizes.update(depth_images=t["dinov2"]["image_size"], gen_images=t["clip_h"]["image_size"],
                         seg_images=t["swin"]["image_size"])
        for i, (key, size) in enumerate(sorted(sizes.items())):
            self.pools[key] = image_pool(n_pool, size, hash((self.seed, 7, i)), device)

    def lengths(self, step: int) -> np.ndarray:
        """The step's text lengths: the same for every seed, rows shuffled by it."""
        ln = draw_lengths(self.t["text_tokens"], self.rows,
                          np.random.default_rng([self.t["shape_seed"], step]))
        return np.random.default_rng([self.seed, 2, step]).permutation(ln)

    def spliced(self, step: int) -> np.ndarray:
        """Each row's positions once its image and task tokens are spliced in."""
        return self.lengths(step) + self.ns + self.ni + self.tt

    def padded(self, step: int) -> int:
        """The step's length: its longest row's bucket."""
        return bucket(int(self.spliced(step).max()), self.t["seq_buckets"])

    def step(self, step: int) -> List[Dict[str, np.ndarray]]:
        rng = np.random.default_rng([self.seed, 3, step])
        lens = self.lengths(step)
        t_pad = self.padded(step)
        plans = []
        for n in lens:
            text = list(rng.integers(3, self.vocab - 10, size=int(n)))
            ids = list(self.sys_ids) + [IMAGE_TOKEN_INDEX] + text
            labels = [IGNORE_INDEX] * (self.ns + 1) + text
            plans.append(splice_plan(ids, labels, t_pad, self.ni, self.tt))
        n_pool = len(next(iter(self.pools.values())))
        if step < self.t["check_steps"]:
            idx = np.arange(step * self.rows, (step + 1) * self.rows)
        else:
            idx = rng.permutation(n_pool)[: self.rows]
        out = []
        for a in range(0, self.rows, self.micro):
            ps = plans[a:a + self.micro]
            mb = {"text_ids": np.stack([p.text_ids for p in ps]),
                  "token_type": np.stack([p.token_type for p in ps]),
                  "src_index": np.stack([p.src_index for p in ps]),
                  "labels": np.stack([p.labels for p in ps]),
                  "seq_lengths": np.asarray([p.seq_length for p in ps], np.int32)}
            for key, pool in self.pools.items():
                mb[key] = pool[idx[a:a + self.micro]]
            if self.t.get("teachers"):
                for task in self.m["distill"]["tasks"]:
                    mb[f"{task['task']}_mask"] = np.ones(len(ps), np.float32)
            out.append(mb)
        return out


@dataclasses.dataclass
class Request:
    plan: Plan
    image: int
    max_new_tokens: int


class ServeTraffic:
    """A sequence of image questions: the system ids, one image from a pool, a
    question of the file's length distribution, an answer cap. The schedule
    (question and answer lengths, which pool image, arrival gaps) comes from
    the file's shape_seed and is the same for every seed; the token ids and
    the images' pixels come from the run's seed."""

    def __init__(self, model: dict, traffic: dict, seed: int, device):
        self.m, self.t, self.seed = model, traffic, int(seed)
        self.vocab = model["decoder"]["vocab_size"]
        rng = np.random.default_rng([self.seed, 1])
        self.sys_ids = rng.integers(3, self.vocab - 10, size=model["num_sys_tokens"])
        self.images = image_pool(traffic["image_pool"], model["tower"]["image_size"],
                                 hash((self.seed, 11)), device)
        n = traffic["requests"]
        shape_rng = np.random.default_rng([traffic["shape_seed"], 0])
        q = draw_lengths(traffic["question_tokens"], n, shape_rng)
        mx = traffic["max_new_tokens"]
        short = shape_rng.random(n) < mx["short_share"]
        new = np.where(short, shape_rng.integers(mx["short"][0], mx["short"][1] + 1, size=n),
                       shape_rng.integers(mx["long"][0], mx["long"][1] + 1, size=n))
        self.q_len, self.new = q, new
        self.image_index = shape_rng.integers(traffic["image_pool"], size=n)
        self.rng = np.random.default_rng([self.seed, 3])
        self.count = 0

    def gaps(self, rate: float) -> np.ndarray:
        """Exponential arrival gaps of mean 1 / rate (from the file's shape_seed)."""
        return np.random.default_rng([self.t["shape_seed"], 5]).exponential(1.0 / rate, size=4096)

    def next(self) -> Request:
        i = self.count % len(self.q_len)
        self.count += 1
        text = list(self.rng.integers(3, self.vocab - 10, size=int(self.q_len[i])))
        ids = list(self.sys_ids) + [IMAGE_TOKEN_INDEX] + text
        n = len(ids) - 1 + self.m["num_image_tokens"] + task_tokens(self.m)
        plan = splice_plan(ids, None, n, self.m["num_image_tokens"], task_tokens(self.m))
        return Request(plan, int(self.image_index[i]), int(self.new[i]))
