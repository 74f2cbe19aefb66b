"""Share of the traced window's device-idle time that lies inside the
teachers' spans (`teacher.*`: the host in a teacher while the device waits)
(harness/spans.py)."""

from benchmark.harness.spans import found


def read(ctx):
    sp, tr = found(ctx), ctx.get("trace") or {}
    if not tr.get("busy_s"):
        return None
    idle = tr["window_s"] - tr["busy_s"]
    inside = [s["idle_s"] for n, s in sp.items() if n.startswith("teacher.")]
    return 100.0 * sum(inside) / idle if inside and idle > 0 else None
