#!/usr/bin/env python3
"""Where the time of an attention kernel goes, on one NVIDIA GPU.

    python3 chip_ablate_bwd.py [flash_bwd|window_attn]

Builds copies of one source under visper_lm_tpu_torch/csrc in which parts of
its kernels are switched off by `-D` defines, and times each build as CUDA
graphs of 20 launches, every build twice, in mirrored order. The ablated
builds compute wrong results: they show where the time goes and nothing else.
Builds go to visper_lm_tpu_torch/_build/ablate/.

flash_bwd (the default): the wgmma backward kernels skip their shared-memory
products (S and dP: "no_ss"), their register-A products (the gradients:
"no_rs"), the ex2 of P ("no_ex2"), both kinds of product ("no_products") or
all three ("loads_only": the ring of loads, the barriers, the masks and the
stores are left); the dq (B2) and the dk/dv (B3) kernel of each build at the
training shape (B4 T1024 32/32 H96, kv_lengths 657/659/655/659) and the GQA
shape (B2 T1024 32/8 H128).

window_attn: the window-attention kernel (B4, "streamed") skips its products
("no_products"), the reads of bias and mask ("no_bias_mask"), the softmax (no
exponential and no row reductions across lanes: "no_softmax") or all three
("loads_only": the loads of q, k, v and the store of the output are left);
each build at Swin-L's stages 1 and 3 without and with the shift mask (W512 /
W32, 6 / 24 heads, N144, D32), q, k and v as views of a packed projection. It
also times the full build at all eight Swin-L stage launches and prints its
registers, spills and CTAs per SM.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Tuple

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


# (text, replacement, times it must occur in the switched part of the
# source): a renamed or reformatted call fails the build of the ablations
# instead of leaving a variant that is the full kernel.
SWITCHES = (
    ("wgmma_ss<", "if (ABL_SS) wgmma_ss<", 4),              # S, dP; S^T, dP^T
    ("wgmma_rs<H>(", "if (ABL_RS) wgmma_rs<H>(", 3),        # dq; dv, dk
    ("= ex2(", "= ABL_EX2 ? ex2(", 2),                      # P in dq, P^T in dk/dv
    ("ABL_EX2 ? ex2(st[i]);", "ABL_EX2 ? ex2(st[i]) : st[i];", 1),
    ("ABL_EX2 ? ex2(sa[i]);", "ABL_EX2 ? ex2(sa[i]) : sa[i];", 1),
)

WINDOW_VARIANTS = {
    "full": {},
    "no_bias_mask": {"ABL_BIAS": 0},
    "no_softmax": {"ABL_SOFTMAX": 0},
    "no_products": {"ABL_MMA": 0},
    "loads_only": {"ABL_MMA": 0, "ABL_BIAS": 0, "ABL_SOFTMAX": 0},
}
WINDOW_SWITCHES = (
    ("mma_bf16(", "if (ABL_MMA) mma_bf16(", 4),                             # S, O
    ("const float2 bv = *reinterpret_cast<const float2*>(bias + off);",
     "const float2 bv = ABL_BIAS ? *reinterpret_cast<const float2*>(bias + off)"
     " : make_float2(0.f, 0.f);", 1),
    ("if (mask) {", "if (ABL_BIAS && mask) {", 1),
    ("s[nt][i] = ex2(fmaf(s[nt][i], kLog2e, -ml));",
     "s[nt][i] = ABL_SOFTMAX ? ex2(fmaf(s[nt][i], kLog2e, -ml)) : s[nt][i];", 1),
    ("mx[r] = fmaxf(mx[r], __shfl_xor_sync(", "if (ABL_SOFTMAX) mx[r] = fmaxf(mx[r], __shfl_xor_sync(", 2),
    ("sum += __shfl_xor_sync(", "if (ABL_SOFTMAX) sum += __shfl_xor_sync(", 2),
)
WINDOW_CASES = {  # W, heads, shifted
    "stage1": (512, 6, False), "stage1_shifted": (512, 6, True), "stage3": (32, 24, False),
    "stage3_shifted": (32, 24, True),
}
SWIN_STAGES = ((512, 6), (128, 12), (32, 24), (8, 48))   # Swin-L at 768 px, micro-batch 2


class Ablation(NamedTuple):
    cut: str                     # the switches apply from this text on
    switches: Tuple[Tuple[str, str, int], ...]
    full: Dict[str, object]      # the defines of the full kernel
    variants: Dict[str, Dict[str, object]]
    run: Callable


def ablatable_source(src: str, name: str = "flash_bwd") -> str:
    """The source with parts of its kernels behind switches (the text before
    the table's cut is left as it is). Raises if a switched call does not
    occur as often as the table says."""
    abl = ABLATIONS[name]
    cut = src.index(abl.cut)
    head, body = src[:cut], src[cut:]
    for old, new, times in abl.switches:
        if body.count(old) != times:
            raise ValueError(f"chip_ablate_bwd: {old!r} occurs {body.count(old)} times, not {times}")
        body = body.replace(old, new)
    return head + body


def run_flash_bwd(libs, graph_ms) -> None:
    from visper_lm_tpu_torch.ops import _build
    from visper_lm_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, (b, t, nq, nkv, h, lens) in SHAPES.items():
        q = torch.randn(b, t, nq, h, device="cuda", generator=gen).bfloat16()
        k, v = (torch.randn(b, t, nkv, h, device="cuda", generator=gen).bfloat16() for _ in range(2))
        dout = torch.randn(b, t, nq, h, device="cuda", generator=gen).bfloat16()
        kw = dict(causal=True, kv_lengths=torch.tensor(lens, device="cuda"))
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        times = {name: ([], []) for name in libs}
        for name in [*libs, *reversed(libs)]:
            with _build.loaded_as("flash_bwd", libs[name]):
                times[name][0].append(graph_ms(
                    [lambda: fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)], 20))
                times[name][1].append(graph_ms(
                    [lambda: fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)], 20))
        for name, (dq, dkv) in times.items():
            print(f"ablation {shape} {name}: dq {sum(dq) / 2:.4f} ms {dq}, "
                  f"dk/dv {sum(dkv) / 2:.4f} ms {dkv}")


def window_inputs(w: int, heads: int, shifted: bool, gen):
    """A Swin-L launch's inputs (N144, D32, micro-batch 2): q, k, v as the
    (W, heads, N, D) views of a packed projection, a random f32 bias and, when
    shifted, the model's own shift mask."""
    from visper_lm_tpu_torch.models.teachers import swin

    n, d, ws = 144, 32, 12
    qkv = torch.randn(w, n, 3, heads, d, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bias = torch.randn(heads, n, n, device="cuda", generator=gen)
    mask = None
    if shifted:
        side = int(round((w // 2) ** 0.5)) * ws
        mask = torch.as_tensor(swin._shift_attn_mask(side, side, ws, ws // 2), device="cuda")
    return q, k, v, bias, mask, d ** -0.5


def run_window_attn(libs, graph_ms) -> None:
    from visper_lm_tpu_torch.ops import _build
    from visper_lm_tpu_torch.ops import window_attention as wa

    res = _build.kernel_resources(_build.build_log("window_attn"))
    for entry, r in res.items():
        print(f"ptxas[window_attn] {entry}: {r}")
    threads, smem, ctas = (ctypes.c_int() for _ in range(3))
    for masked, stages in ((0, wa.MAX_STAGES), (1, 2)):
        rc = _build.load("window_attn").visper_window_attn_info(
            144, 32, masked, stages, ctypes.byref(threads), ctypes.byref(smem), ctypes.byref(ctas))
        print(f"window_attn N144 D32 masked {masked} stages {stages}: rc {rc}, "
              f"{threads.value} threads, {smem.value} B dynamic shared memory, "
              f"{ctas.value} CTAs per SM")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for i, (w, heads) in enumerate(SWIN_STAGES):
        for shifted in (False, True):
            args = window_inputs(w, heads, shifted, gen)
            ms = graph_ms([lambda: wa.window_attention_kernel(*args)], 20)
            print(f"window stage{i + 1}{'_shifted' if shifted else ''} W{w} heads{heads} "
                  f"(full build, CUDA graph): {ms:.4f} ms")
    for case, (w, heads, shifted) in WINDOW_CASES.items():
        args = window_inputs(w, heads, shifted, gen)
        times = {name: [] for name in libs}
        for name in [*libs, *reversed(libs)]:
            with _build.loaded_as("window_attn", libs[name]):
                times[name].append(graph_ms([lambda: wa.window_attention_kernel(*args)], 20))
        for name, t in times.items():
            print(f"ablation {case} {name}: {sum(t) / 2:.4f} ms {t}")


ABLATIONS = {
    "flash_bwd": Ablation("// bf16: TMA ring + wgmma", SWITCHES,
                          {"ABL_SS": 1, "ABL_RS": 1, "ABL_EX2": 1}, VARIANTS, run_flash_bwd),
    "window_attn": Ablation("// streamed:", WINDOW_SWITCHES,
                            {"ABL_MMA": 1, "ABL_BIAS": 1, "ABL_SOFTMAX": 1},
                            WINDOW_VARIANTS, run_window_attn),
}


def main() -> int:
    name = sys.argv[1] if len(sys.argv) > 1 else "flash_bwd"
    if name not in ABLATIONS:
        print(f"chip_ablate_bwd: no ablation for {name!r} (one of {sorted(ABLATIONS)})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ablate_bwd: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from chip_smoke import graph_ms
    from visper_lm_tpu_torch.ops import _build

    abl = ABLATIONS[name]
    out_dir = _build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}_ablate.cu"
    src.write_text(ablatable_source((_build.CSRC / f"{name}.cu").read_text(), name))
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {
        variant: subprocess.Popen(
            _build.nvcc_command(src, out_dir / f"{name}_{variant}.so", flags=flags,
                                defines={**abl.full, **over}),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for variant, over in abl.variants.items()
    }
    libs = {}
    for variant, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{log}")
        libs[variant] = _build.bind(name, out_dir / f"{name}_{variant}.so")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    abl.run(libs, graph_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
