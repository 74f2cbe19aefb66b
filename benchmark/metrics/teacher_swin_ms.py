"""The swin teacher's span time (the port's `teacher.swin` span, one a
chunk) per micro-batch (a `heads` span each) of the traced window
(harness/spans.py)."""

from benchmark.harness.spans import found


def read(ctx):
    sp = found(ctx)
    t, mb = sp.get("teacher.swin"), sp.get("heads")
    return 1e3 * t["span_s"] / mb["count"] if t and mb else None
