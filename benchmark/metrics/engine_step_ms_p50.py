"""Median wall time of `Engine.step` calls in the window."""

import statistics


def read(ctx):
    ms = ctx.get("engine_step_ms")
    return statistics.median(ms) if ms else None
