"""The port's hand-written kernels' share of their roofline in the traced
window: the launches' least times from their shapes over their device time."""

from benchmark.counts.kernels import roofline_share


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["calls"]:
        return None
    return roofline_share(tr["calls"], tr["kernels"])
