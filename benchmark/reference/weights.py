"""Seeded weights, drawn on the device in one call per group of leaves.

Every parameter name belongs to a group (a decoder block, a tower block, a
head, ...). A group's leaves, sorted by name, take consecutive slices of one
standard-normal draw from a `torch.Generator` seeded by (run seed, model
tag, group name); each leaf is then `mean + std * z`, its mean and std fixed
by its name and shape (`leaf_init`). The benchmark fills the program's
parameters with these numbers (rounded to the served dtype) and the
reference draws the same numbers again, group by group, in float32.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import torch

_BLOCK = re.compile(r"^(.*?\.(?:blocks|layers)\.\d+)\.")


def group_of(name: str) -> str:
    """The group a leaf is drawn with: through its block index where it has
    one (`decoder.blocks.7`, `swin.stages.2.blocks.11`), else its first two
    components (`decoder.embed_tokens`, `heads.seg`)."""
    m = _BLOCK.match(name)
    if m:
        return m.group(1)
    parts = name.split(".")
    return ".".join(parts[:2]) if len(parts) > 2 else parts[0]


def leaf_init(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """(mean, std) of a leaf: norm scales about 1, biases and embeddings
    N(0, 0.02), layer scales N(0, 0.1), the contrastive logit scales about 2,
    task-token rows N(0, 1), every other kernel N(0, 1 / (3 fan_in)) (the
    variance of U(-1/sqrt(fan_in), 1/sqrt(fan_in)))."""
    last = name.rsplit(".", 1)[-1]
    if name.startswith("logit_scales."):
        return 2.0, 0.1
    if name.startswith("special_tokens."):
        return 0.0, 1.0
    if last == "scale":
        return 1.0, 0.02
    if last == "gamma":
        return 0.0, 0.1
    if last in ("bias", "rel_bias", "pos_embed", "cls_token", "latents") or "embed_tokens" in name:
        return 0.0, 0.02
    if len(shape) < 2:
        return 0.0, 0.02
    fan_in = 1
    for d in shape[1:]:
        fan_in *= int(d)
    return 0.0, (3.0 * fan_in) ** -0.5


def group_seed(seed: int, tag: str, group: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{tag}/{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def groups(shapes: Mapping[str, Sequence[int]]) -> Dict[str, List[str]]:
    """{group: its leaf names, sorted}."""
    out: Dict[str, List[str]] = {}
    for n in sorted(shapes):
        out.setdefault(group_of(n), []).append(n)
    return out


def draw_group(names: Sequence[str], shapes: Mapping[str, Sequence[int]], seed: int, tag: str,
               group: str, device, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The group's leaves, drawn in float32 on `device` and rounded to `dtype`
    (returned in float32 when dtype is float32 or when rounding only)."""
    sizes = [int(torch.Size(shapes[n]).numel()) for n in names]
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, tag, group))
    z = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for n, size in zip(names, sizes):
        mean, std = leaf_init(n, shapes[n])
        out[n] = (z[at:at + size] * std + mean).view(tuple(shapes[n])).to(dtype)
        at += size
    return out


class Weights:
    """Lazy float32 weights of one model tag: `W[name]` draws the name's group
    on first use (rounded to `rounding`, the served dtype, then widened) and
    keeps it until `release(group)`. `override` maps names to tensors that
    stand in for the drawn ones (the trainables of a reference step)."""

    def __init__(self, shapes: Mapping[str, Sequence[int]], seed: int, tag: str, device,
                 rounding: Mapping[str, torch.dtype]):
        self.shapes = dict(shapes)
        self.seed, self.tag, self.device = seed, tag, device
        self.rounding = rounding
        self.by_group = groups(self.shapes)
        self.cache: Dict[str, torch.Tensor] = {}
        self.override: Dict[str, torch.Tensor] = {}

    def dtype_of(self, name: str) -> torch.dtype:
        """The dtype of the longest prefix of `name` in the rounding rules."""
        best = max((p for p in self.rounding if name.startswith(p)), key=len, default=None)
        return torch.float32 if best is None else self.rounding[best]

    def __contains__(self, name: str) -> bool:
        return name in self.shapes

    def __getitem__(self, name: str) -> torch.Tensor:
        if name in self.override:
            return self.override[name]
        if name not in self.cache:
            g = group_of(name)
            names = self.by_group[g]
            drawn = draw_group(names, self.shapes, self.seed, self.tag, g, self.device)
            for n, t in drawn.items():
                self.cache[n] = t.to(self.dtype_of(n)).float()
        return self.cache[name]

    def get(self, name: str):
        return self[name] if name in self.shapes else None

    def release(self, prefix: str) -> None:
        for n in [n for n in self.cache if n.startswith(prefix)]:
            del self.cache[n]


@torch.no_grad()
def fill_(named: Iterable[Tuple[str, torch.Tensor]], seed: int, tag: str) -> int:
    """Copy the drawn numbers into parameters in place (each in its own dtype
    and device), group by group; returns the number of leaves filled."""
    named = dict(named)
    shapes = {n: tuple(p.shape) for n, p in named.items()}
    count = 0
    for g, names in groups(shapes).items():
        p0 = named[names[0]]
        drawn = draw_group(names, shapes, seed, tag, g, p0.device)
        for n in names:
            named[n].copy_(drawn[n])
            count += 1
    return count
