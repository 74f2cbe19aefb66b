"""Share of the engine's decode slot-steps that carried a request in the
window: `Engine.stats` slot_steps over steps x slots x quantum."""


def read(ctx):
    steps = ctx.get("steps")
    if not steps:
        return None
    return 100.0 * ctx["slot_steps"] / (steps * ctx["slots"] * ctx["quantum"])
