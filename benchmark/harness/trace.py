"""The traced part of a `--trace 1` run: a torch.profiler window, the port's
hand-written kernel launches recorded with their shapes, and what the
per-layer readers take from them (device busy time, the top device
operations, the idle gaps by what the host was doing, each kernel's time)."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

# trace name fragment -> kernel kind (the port's CUDA kernels' entry names)
KERNEL_NAMES = (("flash_bwd_dq", "dq"), ("flash_bwd_dkv", "dkv"), ("flash_fwd", "fwd"),
                ("window_attn", "window"), ("decode_attn", "decode"), ("decode_split", "decode"),
                ("w4_", "w4"))


def kernel_kind(name: str) -> Optional[str]:
    for frag, kind in KERNEL_NAMES:
        if frag in name:
            return kind
    return None


class LaunchRecorder:
    """Wraps the port's kernel entry points (module attributes, looked up at
    call time) so each launch's shapes are kept; restores them on exit."""

    def __init__(self):
        self.calls: List[dict] = []
        self._undo: List[Tuple[object, str, object]] = []

    def _wrap(self, mod, attr, make):
        orig = getattr(mod, attr)
        setattr(mod, attr, make(orig))
        self._undo.append((mod, attr, orig))

    def __enter__(self):
        from visper_lm_tpu_torch.ops import flash_attention as fa
        from visper_lm_tpu_torch.ops import window_attention as wa

        calls = self.calls

        def fwd(orig):
            def f(q, k, v, **kw):
                calls.append(dict(kind="fwd", q=tuple(q.shape), k=tuple(k.shape),
                                  causal=kw.get("causal", True), lens=kw.get("kv_lengths"),
                                  starts=kw.get("kv_starts")))
                return orig(q, k, v, **kw)
            return f

        def bwd(orig):
            def f(fn, q, k, v, dout, lse, delta, kv_lengths, kv_starts, causal, scale):
                calls.append(dict(kind=fn if fn == "dq" else "dkv", q=tuple(q.shape),
                                  k=tuple(k.shape), causal=causal, lens=kv_lengths, starts=kv_starts))
                return orig(fn, q, k, v, dout, lse, delta, kv_lengths, kv_starts, causal, scale)
            return f

        def win(orig):
            def f(q, k, v, bias, mask, scale):
                calls.append(dict(kind="window", q=tuple(q.shape),
                                  nw=0 if mask is None else int(mask.shape[0])))
                return orig(q, k, v, bias, mask, scale)
            return f

        self._wrap(fa, "flash_attention_fwd", fwd)
        self._wrap(fa, "_bwd_launch", bwd)
        self._wrap(wa, "window_attention_kernel", win)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()
        return False


class Tracer:
    """`with tracer.window(): ...` profiles the enclosed work; `summary()`
    reduces it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.recorder = LaunchRecorder()
        self.t0 = self.t1 = 0.0

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        import time

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof, self.recorder:
            self.t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            self.t1 = time.perf_counter()
        self.prof = prof

    def start(self):
        self._cm = self.window()
        self._cm.__enter__()

    def stop(self):
        self._cm.__exit__(None, None, None)

    def summary(self) -> Optional[dict]:
        if self.prof is None:
            return None
        events = self.prof.profiler.kineto_results.events()
        dev, host = [], []
        for e in events:
            dt = str(e.device_type())
            start, dur = e.start_ns(), e.duration_ns()
            if dur <= 0:
                continue
            if "CUDA" in dt:
                dev.append((start, start + dur, e.name()))
            else:
                host.append((start, start + dur, e.name()))
        return reduce_events(dev, host, self.t1 - self.t0, self.recorder.calls)


def reduce_events(dev: list, host: list, window_s: float, calls: list) -> dict:
    """Device intervals (start_ns, end_ns, name) and host ones -> busy
    seconds, seconds by device operation and by kernel kind, and the ten
    longest idle gaps, each named by the host op running through it (or the
    last one begun before it)."""
    import bisect

    if not dev:
        return {"busy_s": 0.0, "window_s": window_s, "ops": {}, "kernels": {}, "gaps": [],
                "calls": calls}
    dev = sorted(dev)
    lo, hi = dev[0][0], max(e for _, e, _ in dev)
    busy, cur_s, cur_e, gaps = 0, dev[0][0], dev[0][1], []
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    ops: Dict[str, float] = {}
    kernels: Dict[str, List[float]] = {}
    for s, e, n in dev:
        ops[n] = ops.get(n, 0.0) + (e - s) / 1e9
        kind = kernel_kind(n)
        if kind is not None:
            kernels.setdefault(kind, []).append((e - s) / 1e9)
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted(host)
    starts = [h[0] for h in host]
    labelled = []
    for gs, ge in gaps[:10]:
        mid = (gs + ge) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = "nothing traced"
        while i >= 0:
            hs, he, n = host[i]
            if he >= mid:
                label = f"in {n}"
                break
            if label == "nothing traced":
                label = f"after {n}"
            if hs < gs - 10 ** 9:
                break
            i -= 1
        labelled.append([f"host {label}", (ge - gs) / 1e9])
    return {"busy_s": busy / 1e9, "window_s": max(window_s, (hi - lo) / 1e9), "ops": ops,
            "kernels": kernels, "gaps": labelled, "calls": calls}


def breakdown(summary: Optional[dict]) -> Optional[dict]:
    if not summary:
        return None
    top = sorted(summary["ops"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in top], "idle_gaps": summary["gaps"][:10]}
