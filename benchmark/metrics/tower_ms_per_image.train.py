"""The vision tower's span time (the port's `vlm.tower` span, which carries
its image count) per image encoded in the traced window (harness/spans.py)."""

from benchmark.harness.spans import found


def read(ctx):
    s = found(ctx).get("vlm.tower")
    return 1e3 * s["span_s"] / s["args"]["images"] if s and s["args"].get("images") else None
