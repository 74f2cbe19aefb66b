"""The port's program spans in a torch.profiler trace, reduced to what the
span readers under `metrics/` take.

The port marks its layers with `visper_lm_tpu_torch.utils.diagnostics.span`
(a `torch.profiler.record_function` whose name carries its args:
`engine.admit[requests=2]`), switched on by `diagnostics.enable(True)` and
off by default. On the profiler's clock each span has a host interval; the
device operations it launched are those whose CUDA runtime call (a host
event named `cu...`, on the span's thread, inside its interval) has the
operation's correlation id. From those, per span name:

  count         the spans of that name
  host_s        their host time
  self_s        host time less that of the spans directly inside them
  device_s      the device time of the operations they launched
  ops           how many operations they launched
  span_s        from each span's start to the later of its host end and the
                end of its last launched operation: the span timed right
                whether the host or the device sets its pace, with no sync.
                Its start is the later of its host start and the end of the
                device work launched before it (no later than its own first
                operation's start), so that spans one after another tile the
                timeline and none counts the device's backlog of earlier work
  self_span_s   span time less that of the spans directly inside them
  idle_s        device-idle time inside their host intervals
  args          each arg summed over them

The profiler also puts a copy of each span on the device's row (a user
annotation from the first to the last operation it launched): `split`
leaves those copies out of the device intervals, where they would count as
busy time. `innermost` names the span open over a moment (an idle gap's
midpoint), and `span_label` puts it in front of the gap's label.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, Iterable, List, Optional, Tuple

SPANS = ("train.data_wait", "teacher.dinov2", "teacher.clip_h", "teacher.swin", "heads",
         "vlm.tower", "decoder.block", "engine.step", "engine.admit", "engine.decode",
         "engine.sync")
_NAME = re.compile(r"([^\[]+)(?:\[([^\]]*)\])?")

# (start_ns, end_ns, name, args, thread)
Mark = Tuple[int, int, str, Dict[str, float], int]


def parse(name: str) -> Optional[Tuple[str, Dict[str, float]]]:
    """(span name, args) of a trace event's name; None for other events."""
    m = _NAME.fullmatch(name)
    if m is None or m[1] not in SPANS:
        return None
    args = {}
    for kv in (m[2] or "").split(","):
        k, _, v = kv.partition("=")
        if k:
            args[k] = float(v)
    return m[1], args


def split(events: Iterable) -> Tuple[list, list, List[Mark], list]:
    """Kineto events -> device intervals (start, end, name, correlation), the
    span copies left out; other host intervals (start, end, name); the spans;
    runtime calls (start, thread, correlation)."""
    dev, host, marks, calls = [], [], [], []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if "CUDA" in str(e.device_type()):
            if dur > 0 and not e.is_user_annotation():
                dev.append((start, start + dur, e.name(), e.correlation_id()))
            continue
        name = e.name()
        span = parse(name)
        if span is not None:
            marks.append((start, start + dur, span[0], span[1], e.start_thread_id()))
        elif name.startswith("cu"):
            calls.append((start, e.start_thread_id(), e.correlation_id()))
        if dur > 0 and span is None:
            host.append((start, start + dur, name))
    return dev, host, marks, calls


def _busy(dev: list) -> Tuple[List[int], List[int], List[int]]:
    """The device's busy intervals merged: starts, ends, busy ns before each."""
    starts, ends, before = [], [], []
    total = 0
    for s, e, *_ in sorted(dev):
        if ends and s <= ends[-1]:
            if e > ends[-1]:
                total += e - ends[-1]
                ends[-1] = e
            continue
        starts.append(s)
        ends.append(e)
        before.append(total)
        total += e - s
    return starts, ends, before


def _busy_within(busy, a: int, b: int) -> int:
    starts, ends, before = busy

    def upto(t):
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return 0
        return before[i] + min(t, ends[i]) - starts[i]

    return upto(b) - upto(a) if b > a else 0


def reduce(marks: List[Mark], calls: list, dev: list) -> Dict[str, dict]:
    """Per span name: the sums the module docstring lists."""
    ops: Dict[int, Tuple[int, int]] = {}
    for s, e, _, corr in dev:
        ops[corr] = (s, e) if corr not in ops else (min(s, ops[corr][0]), max(e, ops[corr][1]))
    by_thread: Dict[int, Tuple[List[int], List[int]]] = {}
    # every launch in time order, and the latest end of the work launched so far
    launched, backlog = [], []
    for start, tid, corr in sorted(calls):
        if corr in ops:
            t = by_thread.setdefault(tid, ([], []))
            t[0].append(start)
            t[1].append(corr)
            launched.append(start)
            backlog.append(max(ops[corr][1], backlog[-1] if backlog else ops[corr][1]))
    busy = _busy(dev)
    rows = []
    for s, e, name, args, tid in marks:
        times, corrs = by_thread.get(tid, ([], []))
        lo, hi = bisect.bisect_left(times, s), bisect.bisect_left(times, e)
        linked = [ops[c] for c in corrs[lo:hi]]
        end = max([e] + [b for _, b in linked])
        i = bisect.bisect_left(launched, s) - 1
        queued = backlog[i] if i >= 0 else s
        if linked:
            queued = min(queued, min(a for a, _ in linked))
        begin = min(max(s, queued), end)
        rows.append(dict(s=s, e=e, name=name, args=args, tid=tid, begin=begin, end=end,
                         ops=len(linked), device=sum(b - a for a, b in linked), child_host=0,
                         child_span=0, idle=(e - s) - _busy_within(busy, s, e)))
    # each span's parent: the innermost span enclosing it on its thread
    stack: Dict[int, List[dict]] = {}
    for r in sorted(rows, key=lambda r: (r["s"], -r["e"])):
        st = stack.setdefault(r["tid"], [])
        while st and st[-1]["e"] < r["e"]:
            st.pop()
        if st:
            st[-1]["child_host"] += r["e"] - r["s"]
            st[-1]["child_span"] += r["end"] - r["begin"]
        st.append(r)
    out: Dict[str, dict] = {}
    for r in rows:
        o = out.setdefault(r["name"], dict(count=0, host_s=0.0, self_s=0.0, device_s=0.0, ops=0,
                                           span_s=0.0, self_span_s=0.0, idle_s=0.0, args={}))
        host, span = r["e"] - r["s"], r["end"] - r["begin"]
        o["count"] += 1
        o["host_s"] += host / 1e9
        o["self_s"] += max(0, host - r["child_host"]) / 1e9
        o["device_s"] += r["device"] / 1e9
        o["ops"] += r["ops"]
        o["span_s"] += span / 1e9
        o["self_span_s"] += max(0, span - r["child_span"]) / 1e9
        o["idle_s"] += r["idle"] / 1e9
        for k, v in r["args"].items():
            o["args"][k] = o["args"].get(k, 0.0) + v
    return out


def innermost(marks: List[Mark], t: int) -> Optional[str]:
    """The name of the innermost span open at `t`: of those open then, the
    latest begun."""
    best = None
    for s, e, name, _, _ in marks:
        if s <= t <= e and (best is None or s > best[0]):
            best = (s, name)
    return None if best is None else best[1]


def span_label(label: str, marks: List[Mark], t: int) -> str:
    """An idle gap's label ("host in aten::copy_", "host after ...") with
    the innermost span open at its midpoint `t` put first: "host in
    teacher.swin / aten::copy_", "host in engine.sync / after ..."."""
    name = innermost(marks, t)
    if name is None:
        return label
    rest = label[len("host "):] if label.startswith("host ") else label
    return f"host in {name} / {rest[len('in '):] if rest.startswith('in ') else rest}"


def found(ctx) -> Dict[str, dict]:
    """The traced window's spans from a reader's context ({} without them)."""
    tr = ctx.get("trace") or {}
    return tr.get("spans") or {}
