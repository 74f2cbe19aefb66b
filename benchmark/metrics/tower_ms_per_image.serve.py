"""The vision tower's device time per image encoded in the traced window
(CUDA events from module hooks the benchmark registers)."""


def read(ctx):
    t = ctx.get("tower_ms")
    if not t or not t[1]:
        return None
    return t[0] / t[1]
