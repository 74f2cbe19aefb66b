"""The port's program spans (visper_lm_tpu_torch/utils/diagnostics.py `span`
and `enable`): off they are one shared no-op that makes no record_function,
no CUDA event and no allocation; on they land in a CPU torch.profiler trace
with their args, where the training loop, the teachers, the heads, the tower
and the decoder blocks put them, and where the serving engine puts its
admissions, decode quanta and host reads inside its steps."""

import collections
import re
import tracemalloc

import numpy as np
import pytest
import torch

from visper_lm_tpu_torch import config as tconfig
from visper_lm_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from visper_lm_tpu_torch.data.collate import build_splice_plan, collate_plans
from visper_lm_tpu_torch.models import teachers as tteach
from visper_lm_tpu_torch.models.teachers import swin as tswin
from visper_lm_tpu_torch.models.vlm import init_vlm
from visper_lm_tpu_torch.serve import engine as teng
from visper_lm_tpu_torch.train import optimizer as topt
from visper_lm_tpu_torch.train import trainer as ttrain
from visper_lm_tpu_torch.utils import diagnostics

# tiny teachers, as tests/_torch_tp_worker.py builds them
TEACHERS = dict(
    dinov2=dict(image_size=28, patch_size=14, hidden_size=24, num_layers=2, num_heads=2,
                mlp_dim=48, norm_eps=1e-6, hidden_act="gelu", use_pre_norm=False,
                dtype="float32"),
    clip_h=dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=2,
                mlp_dim=64, hidden_act="gelu", dtype="float32"),
    swin=dict(embed_dim=2, depths=(1, 1, 1, 1), num_heads=(1, 1, 1, 2), window_size=2),
)
ROWS, ACCUM, STEPS = 4, 2, 2
NAME = re.compile(r"([^\[]+)(?:\[(.*)\])?")
SPANS = {"train.data_wait", "teacher.dinov2", "teacher.clip_h", "teacher.swin", "heads",
         "vlm.tower", "decoder.block", "engine.step", "engine.admit", "engine.decode",
         "engine.sync"}


@pytest.fixture
def spans_on():
    diagnostics.enable(True)
    try:
        yield
    finally:
        diagnostics.enable(False)


def _spans(prof):
    """[(name, args, start_ns, end_ns, thread)] of the trace's spans."""
    out = []
    for e in prof.profiler.kineto_results.events():
        m = NAME.fullmatch(e.name())
        if not m or m[1] not in SPANS:
            continue
        args = dict(kv.split("=") for kv in m[2].split(",")) if m[2] else {}
        out.append((m[1], {k: int(v) for k, v in args.items()}, e.start_ns(),
                    e.start_ns() + e.duration_ns(), e.start_thread_id()))
    return out


def _profile(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


def test_span_off_makes_no_record_function_event_or_allocation(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a span that is off made a record_function or an event")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    assert diagnostics.span("engine.step") is diagnostics.span("engine.admit", requests=2)

    def calls(n):
        for _ in range(n):
            with diagnostics.span("engine.decode", n=8, slots=4):
                pass

    calls(10)
    tracemalloc.start()
    try:
        calls(1000)
        # what the calls left behind (other threads' allocations filtered out)
        kept = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, diagnostics.__file__), tracemalloc.Filter(True, __file__)])
    finally:
        tracemalloc.stop()
    assert sum(t.size for t in kept.traces) == 0


def test_span_on_lands_in_a_cpu_trace_with_its_args(spans_on):
    def work():
        with diagnostics.span("engine.admit", requests=3):
            with diagnostics.span("vlm.tower"):
                torch.ones(8).sum()

    got = _profile(work)
    assert [(n, a) for n, a, *_ in got] == [("engine.admit", {"requests": 3}), ("vlm.tower", {})]
    (_, _, s0, e0, t0), (_, _, s1, e1, t1) = got
    assert s0 <= s1 < e1 <= e0 and t0 == t1
    diagnostics.enable(False)
    assert _profile(work) == []


def _teacher_configs():
    return tteach.TeacherConfigs(
        dinov2=tconfig.VisionConfig(**TEACHERS["dinov2"]),
        clip_h=tconfig.VisionConfig(**TEACHERS["clip_h"]),
        swin=tswin.SwinConfig(**TEACHERS["swin"]), gen_embed_dim=24)


def _pt_batches(cfg, n, seq=48):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        plans = []
        for b in range(ROWS):
            ids = [1, 2, IMAGE_TOKEN_INDEX] + list(rng.integers(3, 400, size=6 + b))
            plans.append(build_splice_plan(
                ids, [IGNORE_INDEX] * 3 + ids[3:], seq, num_image_tokens=cfg.num_image_tokens,
                num_task_tokens=cfg.distill.num_task_tokens, num_tasks=3))
        img = rng.normal(size=(ROWS, 28, 28, 3)).astype(np.float32)
        batch = collate_plans(plans, images=img)
        batch["depth_images"] = img
        batch["gen_images"] = rng.normal(size=(ROWS, 28, 28, 3)).astype(np.float32)
        batch["seg_images"] = rng.normal(size=(ROWS, 64, 64, 3)).astype(np.float32)
        out.append(batch)
    return out


def test_trainer_spans_per_step_micro_batch_chunk_and_block(tmp_path, spans_on):
    """`trainer.train` with its teachers, STEPS steps of ACCUM micro-batches
    of ROWS rows (the teachers in chunks of 2): one data wait a step, each
    teacher once a chunk, the heads and the tower once a micro-batch, and
    each decoder block twice a micro-batch (its forward and the full remat's
    recompute)."""
    cfg = tconfig.tiny_test_vlm(distill=True)
    tcfgs = _teacher_configs()
    model = init_vlm(cfg, device="cpu")
    teachers = tteach.init_teachers(cfg, tcfgs, device="cpu", dtype=torch.float32)
    data = _pt_batches(cfg, ACCUM * (STEPS + 1))
    opt = topt.OptimizerConfig(learning_rate=1e-3, total_steps=10, warmup_ratio=0.1)
    tcfg = ttrain.TrainerConfig(output_dir=str(tmp_path / "run"), device="cpu", max_steps=STEPS,
                                save_steps=100, grad_accum_steps=ACCUM)

    def run():
        ttrain.train(cfg, opt, tcfg, model, lambda epoch: iter(data),
                     teacher_fn=tteach.make_teacher_fn(cfg, tcfgs, microbatch=2),
                     teacher_params=teachers)

    got = _profile(run)
    count = collections.Counter(n for n, *_ in got)
    micro = STEPS * ACCUM
    assert count["train.data_wait"] == STEPS
    for t in ("teacher.dinov2", "teacher.clip_h", "teacher.swin"):
        assert count[t] == micro * ROWS // 2, (t, count)
    assert count["heads"] == micro and count["vlm.tower"] == micro
    assert all(a == {"images": ROWS} for n, a, *_ in got if n == "vlm.tower")
    assert count["decoder.block"] == 2 * micro * cfg.decoder.num_layers
    # the teachers run before the heads' span, never inside it
    heads = [(s, e) for n, _, s, e, _ in got if n == "heads"]
    for n, _, s, e, _ in got:
        if n.startswith("teacher."):
            assert not any(hs <= s < he for hs, he in heads), n


def test_engine_step_holds_its_admissions_decodes_and_syncs(spans_on):
    cfg = tconfig.tiny_test_vlm(distill=True)
    model = init_vlm(cfg, device="cpu", seed=7)
    rng = np.random.default_rng(42)
    reqs = []
    for i, (extra, new) in enumerate(zip([5, 40, 90, 17, 30], [6, 9, 4, 7, 5])):
        ids = [1, 2, 3, IMAGE_TOKEN_INDEX] + rng.integers(4, 400, size=extra).tolist()
        plan = build_splice_plan(ids, None, 256, num_image_tokens=cfg.num_image_tokens,
                                 num_task_tokens=cfg.distill.num_task_tokens, num_tasks=3)
        reqs.append(teng.Request(plan=plan, images=rng.normal(size=(1, 28, 28, 3)).astype(np.float32),
                                 max_new_tokens=new, uid=i))
    eng = teng.Engine(model, cfg, teng.EngineConfig(num_slots=2, max_len=512), device="cpu")
    done = []
    got = _profile(lambda: done.extend(eng.run(reqs)))
    assert len(done) == len(reqs)
    steps = [(s, e, t) for n, _, s, e, t in got if n == "engine.step"]
    assert len(steps) >= eng.stats["steps"] > 0
    for n, a, s, e, t in got:
        if n in ("engine.admit", "engine.decode", "engine.sync"):
            assert any(ss <= s and e <= se and tt == t for ss, se, tt in steps), n
    assert sum(a["requests"] for n, a, *_ in got if n == "engine.admit") == len(reqs)
    decodes = [a for n, a, *_ in got if n == "engine.decode"]
    assert len(decodes) == eng.stats["steps"]
    assert all(a == {"n": eng.ecfg.decode_quantum, "slots": 2} for a in decodes)
    assert sum(n == "engine.sync" for n, *_ in got) == eng.stats["host_syncs"]
    assert sum(a["images"] for n, a, *_ in got if n == "vlm.tower") == len(reqs)
