"""Mean self span time of one decoder block call (the port's `decoder.block`
span: each forward and each remat recompute; the backward is outside it) in
the traced window (harness/spans.py)."""

from benchmark.harness.spans import found


def read(ctx):
    s = found(ctx).get("decoder.block")
    return 1e3 * s["self_span_s"] / s["count"] if s else None
