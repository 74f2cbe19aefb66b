"""Argument parsing, the environment, the chip checks and the result line."""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "visper_lm_tpu")


def prepare_environment(root: str) -> None:
    """Every compile and kernel cache at a fixed path inside the checkout;
    libraries kept from loading JAX."""
    cache = os.path.join(root, "benchmark", ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def process_start(fallback: float) -> float:
    """The process's start on the wall clock (from /proc), else `fallback`."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return fallback


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class RunArgs:
    """A run's arguments given in code (the controls, the tests): the command
    line's four, and the controls' extras (`rate`, `control`, `no_reference`)."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: int = 0, **extra):
        self.workload, self.seed, self.seconds, self.trace = workload, seed, seconds, trace
        self.__dict__.update(extra)


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(root: str, argv: List[str], t_start: float) -> int:
    args = parse(argv)
    from benchmark.harness import loader

    cell = loader.load_cell(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    started = process_start(t_start)
    run = cell.driver.Run(cell, args, started, torch.device("cuda"))
    result = run.execute()
    found = forbidden_loaded()
    if found:
        print(f"benchmark: forbidden modules loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    checks: Dict[str, Dict[str, float]] = result.pop("checks")
    metrics = {}
    wanted = cell.end_to_end if not args.trace else cell.per_layer
    for name, unit in wanted:
        value = result["values"].get(name)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    line = {
        "correct": bool(result["correct"]),
        "attempted": int(result["attempted"]),
        "failed": int(result["failed"]),
        "metrics": metrics,
        "device": result["device"],
    }
    if args.trace and result.get("breakdown"):
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    print(f"benchmark: {args.workload} seed {args.seed} on {power_limit()}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """`correct`'s comparison: each number beside its limit, and whether
    every one is finite and within it."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return checks, all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def device_record(trace: Optional[dict], peak: int, device=None) -> Dict[str, object]:
    import torch

    cuda = device is None or torch.device(device).type == "cuda"
    rec = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": 1,
           "memory_peak_bytes": int(peak)}
    if trace is not None:
        rec["busy_s"] = trace["busy_s"]
        rec["window_s"] = trace["window_s"]
    return rec


def free_device(device=None) -> None:
    import torch

    gc.collect()
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0

