"""The numbers that decide `correct`, each from the program's and the
reference's readings."""

from __future__ import annotations

import statistics
from typing import Dict, Mapping, Optional, Tuple


def loss_gap(prog: list, ref: list) -> float:
    """The widest relative gap of a step's loss."""
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog, ref))


def worst_leaf(prog: Mapping[str, float], ref: Mapping[str, float],
               keep: Optional[set] = None) -> Tuple[float, str]:
    """The widest gap |prog norm - ref norm| over the leaves in `keep`, each
    against the larger of its reference norm and the median leaf's."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    worst, at = -1.0, ""
    for n in names:
        g = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if g > worst:
            worst, at = g, n
    return worst, at


def moving_leaves(ref_grads: Mapping[str, float], share: float = 1e-3) -> set:
    """The leaves whose reference gradient is at least `share` of the median
    leaf's: the others move by round-off alone and are left out of the
    change."""
    med = statistics.median(ref_grads.values())
    return {n for n, g in ref_grads.items() if g >= share * med}


def train_numbers(prog: Dict[str, object], ref: Dict[str, object]) -> Dict[str, float]:
    n = len(ref["losses"])
    keep = moving_leaves(ref["grad_norms"])
    grad, _ = worst_leaf(prog["grad_norms"], ref["grad_norms"])
    change, _ = worst_leaf(prog["changes"], ref["changes"], keep)
    return {"loss_gap": loss_gap(prog["losses"][:n], ref["losses"]),
            "grad_gap": grad, "change_gap": change}
