"""Host milliseconds the training loop waited for its next device batch
(the port's `train.data_wait` span, one an optimizer step) per optimizer step
of the traced window (harness/spans.py)."""

from benchmark.harness.spans import found


def read(ctx):
    s = found(ctx).get("train.data_wait")
    return 1e3 * s["host_s"] / s["count"] if s else None
