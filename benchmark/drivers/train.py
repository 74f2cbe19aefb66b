"""Training driver: the window drives the port's own loop,
`visper_lm_tpu_torch.train.trainer.train`, fed through its `_Prefetcher`
with host batches the traffic generator builds from the seed.

Set-up builds the model and teachers (the benchmark's seeded weights) and
STEP_BATCHES optimizer steps' batches, which the loop cycles through, and it runs the first `check_steps`
optimizer steps, and more until every length bucket of the window's steps
has run: they are the warm-up, and the first ones are the checked steps
(their losses, the first gradient as the optimizer holds it, the change
after them). A
traced run profiles the first TRACE_STEPS steps of the window and ends. The window then counts
the optimizer steps that end before it closes; the loop is stopped by an
exception from its metrics sink, so no checkpoint is written. Once the
program is freed, the reference follows the checked steps on the same
batches and weights."""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict, List

import torch

from benchmark.counts import model as counts
from benchmark.harness import common, loader, portcfg, trace
from benchmark.harness.traffic import TrainTraffic
from benchmark.reference import compare, spec
from benchmark.reference import train as ref_train
from benchmark.reference.weights import Weights, fill_


TRACE_STEPS = 2
# distinct optimizer steps built in set-up; the window cycles through them
STEP_BATCHES = 16
# trainables above this many elements keep the reference's Adam moments in host memory
HOST_MOMENTS = 2 ** 30


class WindowClosed(Exception):
    pass


class Run:
    def __init__(self, cell: loader.Cell, args, started: float, device):
        self.cell, self.args, self.started = cell, args, started
        self.dev = torch.device(device)
        self.m = cell.config["model"]
        self.t = cell.traffic

    def build(self, dev):
        from visper_lm_tpu_torch.models.teachers import init_teachers
        from visper_lm_tpu_torch.models.vlm import init_vlm

        seed, rules = self.args.seed, portcfg.dtype_rules(self.cell.config)
        cfg, tcfgs = portcfg.build(self.cell.config, with_teachers=bool(self.t.get("teachers")))
        model = init_vlm(cfg, device=dev)
        portcfg.check_params(model.named_parameters(), spec.vlm(self.m), rules, "model")
        fill_(model.named_parameters(), seed, "vlm")
        teachers = None
        if tcfgs is not None:
            teachers = init_teachers(cfg, tcfgs, device=dev, dtype=rules.get("", torch.bfloat16))
            shapes = spec.teachers(self.m)
            portcfg.check_params(teachers.named_parameters(), shapes, rules, "teachers", exact=False)
            fill_(teachers.named_parameters(), seed, "teachers")
        return cfg, tcfgs, model, teachers

    def execute(self) -> Dict[str, object]:
        from visper_lm_tpu_torch.models.teachers import make_teacher_fn
        from visper_lm_tpu_torch.train.optimizer import OptimizerConfig
        from visper_lm_tpu_torch.train.trainer import TrainerConfig, train

        args, t, m = self.args, self.t, self.m
        dev = self.dev
        common.reset_peak(dev)
        cfg, tcfgs, model, teachers = self.build(dev)
        traffic = TrainTraffic(m, t, args.seed, dev)
        o = t["optimizer"]
        opt_cfg = OptimizerConfig(learning_rate=o["learning_rate"], weight_decay=o["weight_decay"],
                                  warmup_ratio=o["warmup_ratio"], total_steps=o["total_steps"],
                                  b1=o["b1"], b2=o["b2"], eps=o["eps"],
                                  max_grad_norm=o["max_grad_norm"], stage=t["stage"],
                                  master_weights=o["master_weights"])
        tracer = trace.Tracer(bool(args.trace))
        teacher_events: List = []
        teacher_fn = None
        if teachers is not None:
            inner = make_teacher_fn(cfg, tcfgs)

            def teacher_fn(tp, batch):
                if not (tracer.enabled and state.get("tracing")):
                    return inner(tp, batch)
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = inner(tp, batch)
                ev[1].record()
                teacher_events.append(ev)
                return out

        check = warm = t["check_steps"]
        # set-up runs every length bucket the window's steps use
        pads = [traffic.padded(s) for s in range(STEP_BATCHES)]
        while set(pads[warm:]) - set(pads[:warm]):
            warm += 1
        trace_steps = TRACE_STEPS
        state: Dict[str, object] = {"losses": [], "ends": [], "update_ms": [], "tracing": False}
        stop = {"flag": False}

        # every step's batches are built on the host during set-up
        built = [traffic.step(s) for s in range(STEP_BATCHES)]

        def data(epoch, skip_batches=0):
            s = 0
            while not stop["flag"]:
                yield from built[s % STEP_BATCHES]
                s += 1

        def sink(step, record):
            common.sync(dev)
            now = time.perf_counter()
            if step <= check:
                state["losses"].append(record["loss"])
            if step <= warm:
                return
            if state["tracing"]:
                state["update_ms"].append(state["step"].update_ms())
                if step - warm >= trace_steps:
                    tracer.stop()
                    state["tracing"] = False
                    state["ends"].append(now)
                    stop["flag"] = True
                    raise WindowClosed()
            if not args.trace and now - state["t0"] > args.seconds:
                stop["flag"] = True
                raise WindowClosed()
            state["ends"].append(now)

        def hook(step, ts, batch):
            state["step"] = ts
            if step == 1:
                b1 = ts.optimizer.cfg.b1
                state["grad_norms"] = {n: float(mu.double().norm()) / (1.0 - b1)
                                       for n, mu in ts.optimizer.mu.items()}
            if step == check:
                state["changes"] = self.changes(ts, dev)
            if step == warm:
                common.sync(dev)
                state["setup_s"] = time.time() - self.started
                if tracer.enabled:
                    tracer.start()
                    state["tracing"] = True
                state["t0"] = time.perf_counter()

        out_dir = tempfile.mkdtemp(prefix="bench_train_")
        tcfg = TrainerConfig(output_dir=out_dir, device=dev.type, grad_accum_steps=t["accum_steps"],
                             save_steps=10 ** 9, logging_steps=1, resume=False)
        try:
            train(cfg, opt_cfg, tcfg, model, data, teacher_fn=teacher_fn, teacher_params=teachers,
                  log_sinks=[sink], step_hooks=[hook])
            raise RuntimeError("benchmark: the training loop ended before the window closed")
        except WindowClosed:
            pass
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        peak = common.peak(dev)
        steps_done = len(state["ends"])
        window = state["ends"][-1] - state["t0"] if steps_done else float("nan")
        rows = t["per_device_batch"]
        values: Dict[str, float] = {"setup_s": state["setup_s"],
                                    "train_examples_per_s": rows * steps_done / window}
        summary = tracer.summary()
        ctx = {"trace": summary, "window_s": window,
               "flops": sum(self.step_flops(traffic, (warm + i) % STEP_BATCHES) for i in range(steps_done)),
               "update_ms": [x for x in state["update_ms"] if x is not None],
               "teacher_ms": [a.elapsed_time(b) for a, b in teacher_events]}
        values.update(loader.read_metrics(self.cell, ctx))
        prog = {"losses": state["losses"], "grad_norms": state["grad_norms"],
                "changes": state["changes"]}
        trainable = sorted(state["step"].trainable)
        del state["step"], model, teachers, teacher_fn
        common.free_device(dev)
        del built
        numbers = self.reference(traffic, prog, trainable, dev)
        checks, correct = common.judge(numbers, self.cell.limits)
        return {"correct": correct, "attempted": steps_done, "failed": 0, "values": values,
                "device": common.device_record(summary, peak, dev), "checks": checks,
                "breakdown": trace.breakdown(summary)}

    def changes(self, ts, dev) -> Dict[str, float]:
        """Each trainable's distance from its drawn start (the master copy
        where the optimizer keeps one: what the next step reads)."""
        shapes = spec.vlm(self.m)
        rules = portcfg.dtype_rules(self.cell.config)
        probe = Weights(shapes, self.args.seed, "vlm", dev, rules)
        out = {}
        with torch.no_grad():
            for n in ts.trainable:
                cur = ts.optimizer.master[n] if ts.optimizer.master is not None else ts.trainable[n]
                out[n] = float((cur.float() - probe[n]).double().norm())
        return out

    def step_flops(self, traffic: TrainTraffic, step: int) -> float:
        spliced = [int(n) for n in traffic.spliced(step)]
        mb = self.t["micro_batch"]
        return sum(counts.train_step(self.m, self.t["stage"], spliced[a:a + mb], traffic.padded(step))
                   for a in range(0, len(spliced), mb))

    def reference(self, traffic: TrainTraffic, prog, trainable: List[str], dev) -> Dict[str, float]:
        rules = portcfg.dtype_rules(self.cell.config)
        W = Weights(spec.vlm(self.m), self.args.seed, "vlm", dev, rules)
        Wt = (Weights(spec.teachers(self.m), self.args.seed, "teachers", dev, rules)
              if self.t.get("teachers") else None)
        want = sorted(n for n in spec.vlm(self.m) if any(n.startswith(p) for p in self.t["trainable"]))
        if want != trainable:
            raise SystemExit("benchmark: the program trains other parameters than the stage's")
        batches = [[{k: torch.as_tensor(v, device=dev) for k, v in mb.items()}
                    for mb in traffic.step(s)] for s in range(self.t["check_steps"])]
        size = sum(torch.Size(spec.vlm(self.m)[n]).numel() for n in want)
        host = torch.device("cpu") if size > HOST_MOMENTS else None
        ref = ref_train.steps(self.m, W, Wt, batches, self.t["optimizer"], want, moments_on=host)
        return compare.train_numbers(prog, ref)
