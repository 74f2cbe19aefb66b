"""The engine's decode span time (the port's `engine.decode` span: one
quantum of n token-steps over every slot; it carries n) per token-step in
the traced window (harness/spans.py)."""

from benchmark.harness.spans import found


def read(ctx):
    s = found(ctx).get("engine.decode")
    n = s["args"].get("n") if s else None
    return 1e3 * s["span_s"] / n if n else None
