"""Host milliseconds in the engine's reads of device values (the port's
`engine.sync` span, which holds the read alone) per `engine.step` in the
traced window (harness/spans.py)."""

from benchmark.harness.spans import found


def read(ctx):
    sp = found(ctx)
    sync, steps = sp.get("engine.sync"), sp.get("engine.step")
    return 1e3 * sync["host_s"] / steps["count"] if sync and steps else None
