"""The readings that the limits of `correct` are set from, at a cell's own
size on the chip (not run by the benchmark's runs):

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--seconds 20]
    python3 benchmark/control.py --workload <serving cell> --seeds 1 --rates 10,14,18 (the knee)

Training cells: the reference run in float8 (the precision below the
configuration's bfloat16) and, unless --no-half, the reference with half of
every micro-batch left out (the mean over the rest), each compared with the
float32 reference as the program is. Serving cells: a short run of the cell,
then at each position of the sampled requests' prompts and served tokens the
gap of the token float8 puts first, and of each served token plus one. Each
control's numbers go through the drivers' own comparison with the cell's
limits (`common.judge`), whose verdict is its 'correct'. One JSON line per
seed."""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def train_control(cell, seed: int, dev, half_batch: bool = True) -> dict:
    import torch

    from benchmark.harness import common, portcfg
    from benchmark.harness.traffic import TrainTraffic
    from benchmark.reference import compare, spec
    from benchmark.reference import train as ref_train
    from benchmark.reference.weights import Weights

    m, t = cell.config["model"], cell.traffic
    rules = portcfg.dtype_rules(cell.config)
    traffic = TrainTraffic(m, t, seed, dev)
    batches = [[{k: torch.as_tensor(v, device=dev) for k, v in mb.items()} for mb in traffic.step(s)]
               for s in range(t["check_steps"])]
    trainable = sorted(n for n in spec.vlm(m) if any(n.startswith(p) for p in t["trainable"]))
    W = Weights(spec.vlm(m), seed, "vlm", dev, rules)
    Wt = Weights(spec.teachers(m), seed, "teachers", dev, rules) if t.get("teachers") else None
    from benchmark.drivers.train import HOST_MOMENTS

    size = sum(torch.Size(spec.vlm(m)[n]).numel() for n in trainable)
    host = torch.device("cpu") if size > HOST_MOMENTS else None
    out = {"seed": seed}
    t0 = time.time()
    full = ref_train.steps(m, W, Wt, batches, t["optimizer"], trainable, moments_on=host)
    out["reference_s"] = time.time() - t0
    fp8 = ref_train.steps(m, W, Wt, batches, t["optimizer"], trainable, prec="fp8", moments_on=host)
    out["control"] = compare.train_numbers(fp8, full)
    out["control_correct"] = common.judge(out["control"], cell.limits)[1]
    if half_batch:
        half = [[{k: v[: v.shape[0] // 2] for k, v in mb.items()} for mb in micro] for micro in batches]
        out["half_batch"] = compare.train_numbers(
            ref_train.steps(m, W, Wt, half, t["optimizer"], trainable, moments_on=host), full)
        out["half_batch_correct"] = common.judge(out["half_batch"], cell.limits)[1]
    return out


def sweep(cell, seed: int, seconds: float, rates, dev) -> list:
    """The open loop at each offered rate (no reference): what completed,
    the backlog when the window closed, the first-token tail."""
    from benchmark.harness.common import RunArgs

    out = []
    for rate in rates:
        args = RunArgs(cell.name, seed, seconds, rate=rate, no_reference=True)
        v = cell.driver.Run(cell, args, time.time(), dev).execute()["values"]
        out.append({"rate": rate, "completed_per_s": v["requests_per_s"], "backlog": v["backlog"],
                    "ttft_p95_ms": v.get("ttft_p95_ms"), "answer_p95_ms": v.get("answer_p95_ms")})
        print(json.dumps(out[-1]), flush=True)
    return out


def serve_control(cell, seed: int, seconds: float, dev) -> dict:
    from benchmark.harness import common

    args = common.RunArgs(cell.name, seed, seconds, control=True)
    res = cell.driver.Run(cell, args, time.time(), dev).execute()
    ctl = res["values"]["control"]
    judged = {"control_correct": {"token_gap": ctl["control_gap"], "kv_error": ctl["kv_error"]},
              "altered_correct": {"token_gap": ctl["altered_gap"]}}
    return dict({"seed": seed, "program": {k: v["value"] for k, v in res["checks"].items()},
                 "control": ctl, "correct": res["correct"]},
                **{k: common.judge(v, cell.limits)[1] for k, v in judged.items()})


def main(argv) -> int:
    import argparse

    import torch

    from benchmark.harness import common, loader

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--rates", default="", help="serving cells: sweep these offered rates instead")
    p.add_argument("--no-half", action="store_true", help="training cells: the float8 control only")
    a = p.parse_args(argv)
    common.prepare_environment(ROOT)
    cell = loader.load_cell(ROOT, a.workload)
    dev = torch.device(a.device)
    if a.rates:
        sweep(cell, int(a.seeds.split(",")[0]), a.seconds, [float(r) for r in a.rates.split(",")], dev)
        return 0
    for seed in (int(s) for s in a.seeds.split(",")):
        if cell.traffic["driver"] == "train":
            rec = train_control(cell, seed, dev, half_batch=not a.no_half)
        else:
            rec = serve_control(cell, seed, a.seconds, dev)
        print(json.dumps(rec), flush=True)
        common.free_device(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
