"""The whole step's share of the H100's dense bf16 peak: the model's work in
the window (benchmark/counts/model.py) over the window's seconds."""

from benchmark.counts.kernels import PEAK_BF16


def read(ctx):
    flops, window = ctx.get("flops"), ctx.get("window_s")
    if not flops or not window:
        return None
    return 100.0 * flops / window / PEAK_BF16
