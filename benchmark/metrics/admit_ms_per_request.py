"""The engine's admission span time (the port's `engine.admit` span: the
tower and the prefill; it carries the requests admitted) per request
admitted in the traced window (harness/spans.py)."""

from benchmark.harness.spans import found


def read(ctx):
    s = found(ctx).get("engine.admit")
    n = s["args"].get("requests") if s else None
    return 1e3 * s["span_s"] / n if n else None
