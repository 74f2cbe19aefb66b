#!/usr/bin/env python3
"""chip_smoke.py's training phases alone, from one or more checkouts, on one NVIDIA GPU.

    python3 chip_ab_training.py [--memory] [--out FILE] DIR [DIR ...]

For each DIR, a checkout that holds chip_smoke.py, in the order given and each
in a process of its own: the checkout's kernels are built and its phase 12
(the recipes: PT at Llama-3-8B, IFT, LoRA and vision-tower steps at
Phi3-mini) runs; with --memory, phase 15 (the memory levers) runs after it
where the checkout has one. Each phase prints its own lines. Then one line
per run, `ab {...}`, holds the card, the checkout and each stage's step ms
(every step, and the mean after the first), peak GiB and, from phase 15, the
update's ms; `--out` also appends those lines to FILE.

To compare two trees within one call, give the parent's checkout first and
last: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from visper_lm_tpu_torch.ops import _build
from visper_lm_tpu_torch.ops import flash_attention as fa
from visper_lm_tpu_torch.ops import window_attention as wa

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
smi = cs.environment(_build)
_build.build_all()
recipe = cs.recipe_phase(fa, wa, smi)
summary = dict(card=smi)
for stage in ("pt", "ift", "lora", "vision_tower"):
    r = recipe[stage]
    summary[stage] = dict(step_ms=r["step_ms"], mean_step_ms_after_first=r["mean_step_ms_after_first"],
                          peak_gib=r["peak_gib"])
if sys.argv[1] == "memory" and hasattr(cs, "memory_phase"):
    mem = cs.memory_phase(fa, wa, smi)
    summary["memory"] = dict(
        parity_update_ms={k: v["update_ms"] for k, v in mem["parity"].items() if isinstance(v, dict)},
        ift={k: mem["ift"][k] for k in ("model", "step_ms", "timed_step_ms", "update_ms",
                                        "peak_gib", "pinned_gib")},
        aot={k: mem["aot"].get(k) for k in ("step_ms", "update_ms", "peak_hbm_gib",
                                            "resident_hbm_gib", "static_resident_gib")})
print("AB_SUMMARY " + json.dumps(summary))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dirs", nargs="+", help="checkouts that hold chip_smoke.py")
    p.add_argument("--memory", action="store_true", help="also run phase 15 where there is one")
    p.add_argument("--out", default=None, help="append the `ab` lines here")
    args = p.parse_args(argv)
    lines = []
    for d in args.dirs:
        root = Path(d).resolve()
        if not (root / "chip_smoke.py").is_file():
            raise SystemExit(f"{root} holds no chip_smoke.py")
        proc = subprocess.run([sys.executable, "-c", RUN, "memory" if args.memory else "recipe"],
                              cwd=root, stdout=subprocess.PIPE, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            raise SystemExit(f"{root}: the phases exited {proc.returncode}")
        summary = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB_SUMMARY ")][-1]
        line = "ab " + json.dumps(dict(dir=str(root), **json.loads(summary.split(" ", 1)[1])))
        print(line, flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
