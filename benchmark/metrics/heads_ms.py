"""The task heads' and distillation losses' span time (the port's `heads`
span, one a micro-batch) per micro-batch of the traced window
(harness/spans.py)."""

from benchmark.harness.spans import found


def read(ctx):
    s = found(ctx).get("heads")
    return 1e3 * s["span_s"] / s["count"] if s else None
