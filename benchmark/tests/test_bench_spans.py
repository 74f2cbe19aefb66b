"""The span reduction (harness/spans.py) and the span readers (metrics/) on
synthetic trace events: a span's copy on the device's row counts as no busy
time, self time and launched device time come out exact, an idle gap inside a
span is labelled with it, and every reader finds nothing without spans; then
on a CPU torch.profiler trace of the port's own spans."""

import os

import pytest
import torch

from benchmark.harness import spans
from benchmark.harness.loader import load_module
from benchmark.harness.trace import reduce_events
from benchmark.tests.tiny import ROOT

MS = 10 ** 6
READERS = ("data_wait_ms", "teacher_swin_ms", "teacher_dinov2_ms", "teacher_clip_h_ms",
           "heads_ms", "decoder_block_ms.train", "tower_ms_per_image.train",
           "idle_in_teachers.train", "admit_ms_per_request", "decode_ms_per_token_step",
           "launches_per_token_step", "sync_wait_ms")


class Event:
    """The part of a kineto event that harness/spans.py reads."""

    def __init__(self, name, start, end, cuda=False, corr=0, tid=1, annotation=False):
        self._v = (name, start, end, cuda, corr, tid, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _trace():
    """teacher.swin [0, 10) ms on the host holding a child span vlm.tower
    [2, 4) ms; three launches (two in the tower, one in the teacher after it)
    and one outside; on another thread a decoder.block [4.2, 4.4) ms whose op
    waits behind the device's backlog of the four launched before it (to 8
    ms); the device idle 9-20 ms, inside the teacher's host interval until 10
    ms."""
    return [
        Event("teacher.swin", 0, 10 * MS, annotation=True),
        Event("vlm.tower[images=4]", 2 * MS, 4 * MS, annotation=True),
        Event("aten::copy_", 5 * MS, 9 * MS),
        Event("cudaLaunchKernel", 2 * MS, 2 * MS + 10, corr=101),
        Event("cudaLaunchKernel", 3 * MS, 3 * MS + 10, corr=102),
        Event("cudaLaunchKernel", 4 * MS + 500, 4 * MS + 510, corr=103),
        Event("cudaLaunchKernel", 12 * MS, 12 * MS + 10, corr=104),
        Event("cudaLaunchKernel", 4 * MS + 600, 4 * MS + 610, corr=105, tid=2),
        Event("decoder.block", 4200 * 1000, 4400 * 1000, tid=3),
        Event("cudaLaunchKernel", 4300 * 1000, 4300 * 1000 + 10, corr=106, tid=3),
        Event("gemm", 3 * MS, 5 * MS, cuda=True, corr=101),
        Event("gemm", 5 * MS, 6 * MS, cuda=True, corr=102),
        Event("relu", 6 * MS, 8 * MS, cuda=True, corr=103),
        Event("add", 20 * MS, 21 * MS, cuda=True, corr=104),
        Event("other_thread", 7 * MS, 8 * MS, cuda=True, corr=105),
        Event("block_op", 8 * MS, 9 * MS, cuda=True, corr=106),
        Event("teacher.swin", 3 * MS, 12 * MS, cuda=True, annotation=True),
    ]


def test_span_reduction_on_synthetic_events():
    dev, host, marks, calls = spans.split(_trace())
    # the span's copy on the device row is no busy time
    assert [d[2] for d in dev] == ["gemm", "gemm", "relu", "add", "other_thread", "block_op"]
    with_copy = reduce_events([(3 * MS, 12 * MS, "teacher.swin")] + [d[:3] for d in dev], host,
                              0.021, [])
    without = reduce_events([d[:3] for d in dev], host, 0.021, [])
    assert without["busy_s"] == pytest.approx(0.007) and with_copy["busy_s"] > without["busy_s"]
    assert [m[2] for m in marks] == ["teacher.swin", "vlm.tower", "decoder.block"]
    assert [h[2] for h in host] == ["aten::copy_"] + ["cudaLaunchKernel"] * 6
    got = spans.reduce(marks, calls, dev)
    swin, tower = got["teacher.swin"], got["vlm.tower"]
    assert (swin["count"], swin["ops"], tower["ops"]) == (1, 3, 2)
    assert swin["host_s"] == pytest.approx(0.010) and swin["self_s"] == pytest.approx(0.008)
    # the device time it launched, and its span time to the last op's end
    assert swin["device_s"] == pytest.approx(0.005) and swin["span_s"] == pytest.approx(0.010)
    assert tower["device_s"] == pytest.approx(0.003) and tower["span_s"] == pytest.approx(0.004)
    assert swin["self_span_s"] == pytest.approx(0.006) and tower["args"] == {"images": 4.0}
    # device idle 0-3 ms and 9-10 ms inside the teacher, 2-3 ms inside the tower
    assert swin["idle_s"] == pytest.approx(0.004) and tower["idle_s"] == pytest.approx(0.001)
    # the block's span starts where the work launched before it ends (8 ms)
    block = got["decoder.block"]
    assert (block["ops"], block["host_s"]) == (1, pytest.approx(0.0002))
    assert block["span_s"] == pytest.approx(0.001) and block["idle_s"] == 0


def test_gap_inside_a_span_is_labelled_with_it():
    dev, host, marks, _ = spans.split(_trace())
    assert spans.innermost(marks, 9 * MS) == "teacher.swin"
    assert spans.innermost(marks, 3 * MS) == "vlm.tower"
    assert spans.innermost(marks, 15 * MS) is None
    assert spans.span_label("host in aten::copy_", marks, 9 * MS) == \
        "host in teacher.swin / aten::copy_"
    assert spans.span_label("host after cudaLaunchKernel", marks, 3 * MS) == \
        "host in vlm.tower / after cudaLaunchKernel"
    assert spans.span_label("host after aten::copy_", marks, 15 * MS) == "host after aten::copy_"


def _readers():
    return {n: load_module(os.path.join(ROOT, "benchmark", "metrics", n + ".py"),
                           "test_span_metric_" + n.replace(".", "_")) for n in READERS}


def test_span_readers_find_nothing_without_spans():
    summary = reduce_events([(0, MS, "gemm")], [(0, MS, "aten::mm")], 0.002, [])
    for name, mod in _readers().items():
        assert mod.read({}) is None, name
        assert mod.read({"trace": None}) is None, name
        assert mod.read({"trace": summary}) is None, name


def test_span_readers_on_a_reduction():
    def row(count, span_s, **kw):
        return dict(dict(count=count, host_s=span_s, self_s=span_s, device_s=span_s, ops=0,
                         span_s=span_s, self_span_s=span_s, idle_s=0.0, args={}), **kw)

    found = {
        "train.data_wait": row(2, 0.004),
        "teacher.swin": row(16, 2.0, idle_s=0.3), "teacher.dinov2": row(16, 0.4),
        "teacher.clip_h": row(16, 0.2, idle_s=0.1), "heads": row(4, 0.08),
        "decoder.block": row(256, 2.56, self_span_s=1.28),
        "vlm.tower": row(4, 0.32, args={"images": 32.0}),
        "engine.step": row(10, 20.0), "engine.admit": row(5, 1.5, args={"requests": 15.0}),
        "engine.decode": row(10, 4.0, ops=80000, args={"n": 80.0, "slots": 160.0}),
        "engine.sync": row(12, 0.6),
    }
    ctx = {"trace": {"spans": found, "window_s": 3.0, "busy_s": 2.0}}
    got = {n: mod.read(ctx) for n, mod in _readers().items()}
    want = {"data_wait_ms": 2.0, "teacher_swin_ms": 500.0, "teacher_dinov2_ms": 100.0,
            "teacher_clip_h_ms": 50.0, "heads_ms": 20.0, "decoder_block_ms.train": 5.0,
            "tower_ms_per_image.train": 10.0, "idle_in_teachers.train": 40.0,
            "admit_ms_per_request": 100.0, "decode_ms_per_token_step": 50.0,
            "launches_per_token_step": 1000.0, "sync_wait_ms": 60.0}
    assert got == pytest.approx(want)


def test_the_ports_spans_in_a_cpu_trace():
    """The port's spans switched on, profiled on the CPU and reduced: counts,
    args and nesting as the program opened them."""
    from visper_lm_tpu_torch.utils import diagnostics as diag

    acts = [torch.profiler.ProfilerActivity.CPU]
    diag.enable(True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            for n in (2, 3):
                with diag.span("engine.step"):
                    with diag.span("engine.admit", requests=n):
                        torch.ones(64).sum()
                    with diag.span("engine.sync"):
                        torch.ones(64).cumsum(0)
    finally:
        diag.enable(False)
    dev, host, marks, calls = spans.split(prof.profiler.kineto_results.events())
    got = spans.reduce(marks, calls, dev)
    assert {n: r["count"] for n, r in got.items()} == {"engine.step": 2, "engine.admit": 2,
                                                     "engine.sync": 2}
    assert got["engine.admit"]["args"] == {"requests": 5.0}
    step = got["engine.step"]
    inner = got["engine.admit"]["host_s"] + got["engine.sync"]["host_s"]
    assert step["self_s"] == pytest.approx(step["host_s"] - inner, abs=1e-9)
    assert any(h[2] == "aten::sum" for h in host) and not dev
