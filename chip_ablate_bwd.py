#!/usr/bin/env python3
"""Where the time of the flash-attention backward kernels goes, on one NVIDIA GPU.

    python3 chip_ablate_bwd.py

Builds copies of visper_lm_tpu_torch/csrc/flash_bwd.cu in which the wgmma
kernels skip their shared-memory products (S and dP: "no_ss"), their
register-A products (the gradients: "no_rs"), the ex2 of P ("no_ex2"), both
kinds of product ("no_products") or all three ("loads_only": the ring of
loads, the barriers, the masks and the stores are left), and times the dq
(B2) and the dk/dv (B3) kernel of each build as CUDA graphs of 20 launches at
the training shape (B4 T1024 32/32 H96, kv_lengths 657/659/655/659) and the
GQA shape (B2 T1024 32/8 H128), every build twice, in mirrored order. The
ablated builds compute wrong gradients: they show where the time goes and
nothing else. Builds go to visper_lm_tpu_torch/_build/ablate/.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

VARIANTS = {
    "full": {},
    "no_ss": {"ABL_SS": 0},
    "no_rs": {"ABL_RS": 0},
    "no_ex2": {"ABL_EX2": 0},
    "no_products": {"ABL_SS": 0, "ABL_RS": 0},
    "loads_only": {"ABL_SS": 0, "ABL_RS": 0, "ABL_EX2": 0},
}
SHAPES = {  # b, t, nq, nkv, h, kv_lengths
    "train": (4, 1024, 32, 32, 96, [657, 659, 655, 659]),
    "gqa": (2, 1024, 32, 8, 128, [1024, 900]),
}


# (text, replacement, times it must occur in the wgmma kernels' part of the
# source): a renamed or reformatted call fails the build of the ablations
# instead of leaving a variant that is the full kernel.
SWITCHES = (
    ("wgmma_ss<", "if (ABL_SS) wgmma_ss<", 4),              # S, dP; S^T, dP^T
    ("wgmma_rs<H>(", "if (ABL_RS) wgmma_rs<H>(", 3),        # dq; dv, dk
    ("= ex2(", "= ABL_EX2 ? ex2(", 2),                      # P in dq, P^T in dk/dv
    ("ABL_EX2 ? ex2(st[i]);", "ABL_EX2 ? ex2(st[i]) : st[i];", 1),
    ("ABL_EX2 ? ex2(sa[i]);", "ABL_EX2 ? ex2(sa[i]) : sa[i];", 1),
)


def ablatable_source(src: str) -> str:
    """flash_bwd.cu with each product and ex2 of the wgmma kernels behind a
    switch (the mma.sync kernels above them are left as they are). Raises if
    a switched call does not occur as often as SWITCHES says."""
    cut = src.index("// bf16: TMA ring + wgmma")
    head, body = src[:cut], src[cut:]
    for old, new, times in SWITCHES:
        if body.count(old) != times:
            raise ValueError(f"chip_ablate_bwd: {old!r} occurs {body.count(old)} times, not {times}")
        body = body.replace(old, new)
    return head + body


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_ablate_bwd: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from chip_smoke import graph_ms
    from visper_lm_tpu_torch.ops import _build
    from visper_lm_tpu_torch.ops import flash_attention as fa

    out_dir = _build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "flash_bwd_ablate.cu"
    src.write_text(ablatable_source((_build.CSRC / "flash_bwd.cu").read_text()))
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {
        name: subprocess.Popen(
            _build.nvcc_command(src, out_dir / f"{name}.so", flags=flags,
                                defines={"ABL_SS": 1, "ABL_RS": 1, "ABL_EX2": 1, **over}),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, over in VARIANTS.items()
    }
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = _build.bind("flash_bwd", out_dir / f"{name}.so")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, (b, t, nq, nkv, h, lens) in SHAPES.items():
        q = torch.randn(b, t, nq, h, device="cuda", generator=gen).bfloat16()
        k, v = (torch.randn(b, t, nkv, h, device="cuda", generator=gen).bfloat16() for _ in range(2))
        dout = torch.randn(b, t, nq, h, device="cuda", generator=gen).bfloat16()
        kw = dict(causal=True, kv_lengths=torch.tensor(lens, device="cuda"))
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        times = {name: ([], []) for name in VARIANTS}
        for name in [*VARIANTS, *reversed(VARIANTS)]:
            with _build.loaded_as("flash_bwd", libs[name]):
                times[name][0].append(graph_ms(
                    [lambda: fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)], 20))
                times[name][1].append(graph_ms(
                    [lambda: fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)], 20))
        for name, (dq, dkv) in times.items():
            print(f"ablation {shape} {name}: dq {sum(dq) / 2:.4f} ms {dq}, "
                  f"dk/dv {sum(dkv) / 2:.4f} ms {dkv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
