"""Open-loop serving driver: requests arrive at the traffic file's fixed
`rate` (exponential gaps: the same schedule for every seed) and are handed
to the port's `Engine` (`submit`) between its `step`s, as they fall due. Set-up builds the model (the benchmark's seeded
weights) and the engine, serves one admission group of every prompt bucket
and group size the traffic reaches (every shape warmed), then runs the open
loop `warm_seconds` before the window opens.

Every request due inside the window is timed from when it was due (so a
stall that delays later submissions counts): to the host's receipt of its
first token (`ttft_p95_ms`) and of its last (`answer_p95_ms`). After the
window closes no request arrives and the engine runs until each of those has
its answer. The reference then reads a seeded sample of the finished
requests, the longest among them."""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.counts import model as counts
from benchmark.harness import common, loader, portcfg, trace
from benchmark.harness.traffic import ServeTraffic, splice_plan, task_tokens
from benchmark.reference import serve as ref_serve
from benchmark.reference import spec
from benchmark.reference.weights import Weights, fill_


def quantile(xs: List[float], q: float) -> float:
    xs = sorted(xs)
    if not xs:
        return float("nan")
    pos = q * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Run:
    def __init__(self, cell: loader.Cell, args, started: float, device):
        self.cell, self.args, self.started = cell, args, started
        self.dev = torch.device(device)
        self.m = cell.config["model"]
        self.t = cell.traffic

    def execute(self) -> Dict[str, object]:
        from visper_lm_tpu_torch.data.collate import SplicePlan
        from visper_lm_tpu_torch.models.vlm import init_vlm
        from visper_lm_tpu_torch.serve.engine import Engine, EngineConfig, Request

        args, t, m = self.args, self.t, self.m
        dev = self.dev
        common.reset_peak(dev)
        rules = portcfg.dtype_rules(self.cell.config)
        cfg, _ = portcfg.build(self.cell.config, with_teachers=False)
        model = init_vlm(cfg, device=dev)
        portcfg.check_params(model.named_parameters(), spec.vlm(m), rules, "model")
        fill_(model.named_parameters(), args.seed, "vlm")
        engine = Engine(model, cfg, EngineConfig(**t["engine"]), device=dev)
        traffic = ServeTraffic(m, t, args.seed, dev)
        images = traffic.images
        clock = time.perf_counter

        def make(spec_req):
            p = spec_req.plan
            rec = {"spec": spec_req, "first": None, "submit": None, "done": None}

            def on_token(tok, rec=rec):
                rec["last"] = clock()
                if rec["first"] is None:
                    rec["first"] = rec["last"]

            req = Request(plan=SplicePlan(p.text_ids, p.token_type, p.src_index, p.labels,
                                          p.seq_length),
                          images=images[spec_req.image][None], max_new_tokens=spec_req.max_new_tokens,
                          stream_callback=on_token)
            rec["req"] = req
            return rec

        def drain() -> List[dict]:
            done = engine.finished
            engine.finished = []
            return [by_req[id(r)] for r in done]

        by_req: Dict[int, dict] = {}

        def submit(rec):
            by_req[id(rec["req"])] = rec
            engine.submit(rec["req"])
            rec["submit"] = rec["req"].submit_t

        def busy() -> bool:
            return bool(engine.queue) or any(s is not None for s in engine.slot_req)

        # every prompt bucket x admission group the traffic reaches, served once
        for n_tok, group in self.warm_shapes(engine):
            for _ in range(group):
                r = traffic.next()
                q = [5] * (n_tok - m["num_image_tokens"] - task_tokens(m) - m["num_sys_tokens"])
                r.plan = splice_plan(list(traffic.sys_ids) + [-200] + q, None, n_tok,
                                     m["num_image_tokens"], task_tokens(m))
                r.max_new_tokens = 1
                submit(make(r))
            while busy():
                engine.step()
            drain()
        rate = getattr(args, "rate", None) or t["rate"]
        gaps = traffic.gaps(rate)
        seconds = t["trace_seconds"] if args.trace else args.seconds
        t_start = clock()
        t0 = t_start + t["warm_seconds"]
        t1 = t0 + seconds
        due = t_start
        tracer = trace.Tracer(bool(args.trace))
        tower = None
        stats0 = None
        step_ms: List[float] = []
        window_recs: List[dict] = []
        completed: List[dict] = []
        opened = False
        k = 0
        while True:
            now = clock()
            if not opened and now >= t0:
                common.sync(dev)
                setup_s = time.time() - self.started
                stats0 = dict(engine.stats)
                if tracer.enabled:
                    tower = TowerTimer(model.vision_tower)
                    tracer.start()
                opened = True
            if now >= t1:
                break
            while due <= now and due < t1:
                rec = make(traffic.next())
                rec["due"] = due
                submit(rec)
                if due >= t0:
                    window_recs.append(rec)
                due += gaps[k % len(gaps)]
                k += 1
            if busy():
                s0 = clock()
                engine.step()
                if opened:
                    step_ms.append((clock() - s0) * 1e3)
            else:
                time.sleep(max(0.0, min(due, t1) - clock()))
            for rec in drain():
                if opened and rec["req"].done_t <= t1:
                    completed.append(rec)
        stats1 = dict(engine.stats)
        values_backlog = len(engine.queue)
        if tracer.enabled:
            tracer.stop()
        if tower is not None:
            tower.remove()
        # no new requests; every request of the window gets its answer
        deadline = clock() + 60.0
        while busy() and clock() < deadline:
            engine.step()
            drain()
        common.sync(dev)
        peak = common.peak(dev)
        answered = [r for r in window_recs if r["req"].done_t]
        failed = len(window_recs) - len(answered)
        ttft = [(r["first"] - r["due"]) * 1e3 for r in answered]
        answer = [(r["last"] - r["due"]) * 1e3 for r in answered]
        values: Dict[str, float] = {"setup_s": setup_s, "requests_per_s": len(completed) / seconds,
                                    "backlog": values_backlog}
        if failed == 0 and answered:
            values["ttft_p95_ms"] = quantile(ttft, 0.95)
            values["answer_p95_ms"] = quantile(answer, 0.95)
        summary = tracer.summary()
        d = {k: stats1[k] - stats0[k] for k in stats1}
        ctx = {"trace": summary, "window_s": seconds, "busy_s": sum(step_ms) / 1e3,
               "flops": sum(counts.served_request(m, r["spec"].plan.seq_length,
                                                  len(r["req"].output_ids)) for r in completed),
               "slot_steps": d["slot_steps"], "steps": d["steps"],
               "slots": t["engine"]["num_slots"], "quantum": engine.ecfg.decode_quantum,
               "engine_step_ms": step_ms,
               "tower_ms": None if tower is None else tower.ms(), }
        values.update(loader.read_metrics(self.cell, ctx))
        if getattr(args, "no_reference", False):
            return {"correct": False, "attempted": len(window_recs), "failed": failed,
                    "values": values, "device": common.device_record(summary, peak, dev),
                    "checks": {}, "breakdown": None}
        cached = self.harvest(engine, window_recs)
        finished = list({id(r): r for r in completed + window_recs
                         if r["req"].done_t and r["req"].output_ids}.values())
        short = sum(len(r["req"].output_ids) != r["spec"].max_new_tokens for r in finished)
        sample = self.sample(finished)
        del engine, model, by_req
        common.free_device(dev)
        gaps = self.reference(sample, images, dev)
        kv_err = self.cache_check(cached, images, dev, values)
        checks, within = common.judge(
            {"token_gap": max(g["gap"] for g in gaps), "kv_error": kv_err, "short_answers": short},
            dict(self.cell.limits, short_answers=0))
        correct = within and failed == 0
        if getattr(args, "control", False):
            values["control"] = {k: max(g[k] for g in gaps) for k in ("control_gap", "altered_gap")}
            values["control"]["kv_error"] = values.pop("control_kv_error")
        return {"correct": correct, "attempted": len(window_recs), "failed": failed,
                "values": values, "device": common.device_record(summary, peak, dev),
                "checks": checks, "breakdown": trace.breakdown(summary)}

    def warm_shapes(self, engine):
        """(prompt tokens, group size) pairs: each prompt bucket the traffic's
        question lengths reach, at each power-of-two group up to the engine's
        admission group."""
        m, t = self.m, self.t
        base = m["num_sys_tokens"] + m["num_image_tokens"] + task_tokens(m)
        q = t["question_tokens"]
        b = engine.ecfg.prompt_bucket
        buckets = sorted({-(-(base + n) // b) * b for n in range(q["low"], q["high"] + 1)})
        groups, g = [], 1
        while g <= max(engine.ecfg.admit_group, 1):
            groups.append(g)
            g *= 2
        return [(min(bk, base + q["high"]), g) for bk in buckets for g in groups
                if g <= engine.ecfg.num_slots]

    def harvest(self, engine, recs: List[dict]) -> List[dict]:
        """The KV caches the timed path left for the window's last answered
        requests whose slots were not taken again (`Engine.harvest`): the
        prompt and every served token but the last, on the host. A seeded
        choice of `check_caches` of them."""
        done = [r for r in recs if r["req"].done_t and len(r["req"].output_ids) > 1]
        out = []
        for i in np.random.default_rng([self.args.seed, 8]).permutation(len(done)):
            h = engine.harvest(done[i]["req"])
            if h is not None:
                k, v = h.cache.k[:, h.start:h.length, 0], h.cache.v[:, h.start:h.length, 0]
                out.append(dict(done[i], k=k.float().cpu(), v=v.float().cpu()))
                if len(out) == self.t["check_caches"]:
                    break
        return out

    def cache_check(self, cached: List[dict], images, dev, values) -> float:
        if not cached:
            return math.inf
        rules = portcfg.dtype_rules(self.cell.config)
        W = Weights(spec.vlm(self.m), self.args.seed, "vlm", dev, rules)
        reqs = [{"text_ids": r["spec"].plan.text_ids, "token_type": r["spec"].plan.token_type,
                 "src_index": r["spec"].plan.src_index, "image": images[r["spec"].image],
                 "tokens": list(r["req"].output_ids), "k": r["k"], "v": r["v"]} for r in cached]
        err = ref_serve.cache_error(self.m, W, reqs, dev)
        if getattr(self.args, "control", False):
            values["control_kv_error"] = ref_serve.cache_error(self.m, W, reqs, dev, prec="fp8",
                                                               against="fp8")
        return err

    def sample(self, finished: List[dict]) -> List[dict]:
        """The longest finished request, then others in a seeded order, until
        the sample holds `check_tokens` served tokens."""
        if not finished:
            return []
        rng = np.random.default_rng([self.args.seed, 9])
        longest = max(finished, key=lambda r: len(r["req"].output_ids))
        rest = [finished[i] for i in rng.permutation(len(finished)) if finished[i] is not longest]
        out, n = [longest], len(longest["req"].output_ids)
        for r in rest:
            if n >= self.t["check_tokens"] or len(out) >= self.t["check_max_requests"]:
                break
            out.append(r)
            n += len(r["req"].output_ids)
        return out

    def reference(self, sample: List[dict], images, dev) -> List[dict]:
        rules = portcfg.dtype_rules(self.cell.config)
        W = Weights(spec.vlm(self.m), self.args.seed, "vlm", dev, rules)
        reqs = [{"text_ids": r["spec"].plan.text_ids, "token_type": r["spec"].plan.token_type,
                 "src_index": r["spec"].plan.src_index, "image": images[r["spec"].image],
                 "tokens": list(r["req"].output_ids)} for r in sample]
        if not reqs:
            return [{"gap": math.inf, "tokens": 0}]
        return ref_serve.token_gaps(self.m, W, reqs, dev, control=getattr(self.args, "control", False))


class TowerTimer:
    """CUDA events around every forward of the vision tower (module hooks:
    nothing of the program is edited), and the images each encoded."""

    def __init__(self, module: torch.nn.Module):
        self.events = []

        def pre(mod, inp):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append([ev, None, int(inp[0].shape[0])])

        def post(mod, inp, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[-1][1] = ev

        # the ConvNeXt trunk runs as a function of its modules: its first and
        # last module calls bound it (the 4x4 stem convolution before them)
        first = getattr(module, "stem_norm", module)
        last = getattr(module, "norm_pre", module)
        self.handles = [first.register_forward_pre_hook(pre), last.register_forward_hook(post)]

    def remove(self):
        for h in self.handles:
            h.remove()

    def ms(self):
        done = [(a, b, n) for a, b, n in self.events if b is not None]
        if not done:
            return None
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b, _ in done), sum(n for _, _, n in done)
