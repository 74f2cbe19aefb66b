"""A cell's files, found by the names BENCHMARK.json gives."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List, Tuple


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    root: str
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    driver: ModuleType
    end_to_end: List[Tuple[str, str]]
    per_layer: List[Tuple[str, str]]
    readers: Dict[str, ModuleType]


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load_cell(root: str, workload: str) -> Cell:
    bench_dir = os.path.join(root, "benchmark")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"benchmark: no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    with open(os.path.join(bench_dir, "configs", w["config"] + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(bench_dir, "limits", workload + ".json")) as f:
        limits = json.load(f)
    driver = load_module(os.path.join(bench_dir, "drivers", traffic["driver"] + ".py"),
                         "benchmark_driver_" + traffic["driver"])
    e2e = [(m["name"], m["unit"]) for m in spec["end_to_end"] if _applies(m, workload, set())]
    reported = {n for n, _ in e2e}
    per_layer = [(m["name"], m["unit"]) for m in spec["per_layer"]
                 if _applies(m, workload, reported)]
    readers = {n: load_module(os.path.join(bench_dir, "metrics", n + ".py"),
                              "benchmark_metric_" + n.replace(".", "_"))
               for n, _ in per_layer}
    return Cell(root, workload, int(w["chips"]), config, traffic, limits, driver, e2e, per_layer,
                readers)


def read_metrics(cell: Cell, ctx: dict) -> Dict[str, float]:
    """Each per-layer reader's value; a reader that finds nothing returns None
    and its metric stays out of the line."""
    out = {}
    for name, mod in cell.readers.items():
        value = mod.read(ctx)
        if value is not None:
            out[name] = value
    return out
