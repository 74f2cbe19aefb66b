"""The frozen teachers' device time per micro-batch: CUDA events around the
teacher function the benchmark hands to the training loop (traced steps)."""


def read(ctx):
    ms = ctx.get("teacher_ms")
    return sum(ms) / len(ms) if ms else None
