"""The serving engine's share of the H100's dense bf16 peak while it works:
the model's work of the requests completed in the window
(benchmark/counts/model.py) over the wall time of the window's
`Engine.step` calls."""

from benchmark.counts.kernels import PEAK_BF16


def read(ctx):
    flops, busy = ctx.get("flops"), ctx.get("busy_s")
    if not flops or not busy:
        return None
    return 100.0 * flops / busy / PEAK_BF16
