"""The system's measurement entry points on the card (counterparts of the
root scripts bench.py, bench_decode.py, bench_engine.py,
bench_input_pipeline.py and bench_teacher_pattern.py; the speculative
timing helper is `serve/speculative._bench`).

Each module has `main(argv=None)`, runs as
`python -m visper_lm_tpu_torch.tools.<name>`, keeps its JAX twin's flags,
defaults and printed JSON record, and adds `--device` (cuda by default;
`--device cpu` runs it here, `--smoke` picks the tiny config and does not
move the run). Every record also names the device it ran on (`"device"`).
The functions each `main` is made of (the workloads from their seeds, the
timing cores) take models built elsewhere, so other scripts reuse them.
"""

from __future__ import annotations

import torch


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (CUDA launches return before it
    finishes); nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    """What a record says it ran on: the card's name, or "cpu"."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
