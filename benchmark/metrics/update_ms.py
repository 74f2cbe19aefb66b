"""The optimizer update's device time, `TrainStep.update_ms()`, averaged
over the traced steps."""


def read(ctx):
    ms = ctx.get("update_ms")
    return sum(ms) / len(ms) if ms else None
