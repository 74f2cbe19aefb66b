"""Device operations launched inside the engine's decode spans
(`engine.decode`) per token-step in the traced window (harness/spans.py)."""

from benchmark.harness.spans import found


def read(ctx):
    s = found(ctx).get("engine.decode")
    n = s["args"].get("n") if s else None
    return s["ops"] / n if n else None
