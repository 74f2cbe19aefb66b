"""w4a16 matmul: the CUDA kernel's wrapper, its plain version, and the gate
that sends a packed-int4 linear to it.

Counterpart of visper_lm_tpu/ops/quant_matmul.py: the Pallas `_w4_kernel`
(:46, pallas_call :125, entry `w4_matmul` :85) becomes csrc/w4_matmul.cu (B5);
`w4_linear` and `w4_supported` (:150, :174) keep their roles.

Layout (utils/param.quantize_linear_int4): packed[r, o] (int8) holds rows 2r
(low nibble) and 2r + 1 (high nibble) of the input-major (din, dout) int4
weight, each sign-extended; scales[g, o] (f32) covers rows
[g * group, (g + 1) * group).

Semantics of the kernel, which the plain version `w4_matmul_reference`
repeats: each group's partial product x_g @ q_g is summed in f32, scaled in
f32 by the group's scale row, and the scaled partials are summed; the result
is cast to x's dtype. This differs from the plain `kernel_q4p` branch of
utils/param.linear (JAX's XLA branch), which rounds q * s to x's dtype and
takes one product.

`w4_matmul` launches a kernel for CUDA tensors (bf16 x) or raises; CPU
tensors take the plain version. csrc/w4_matmul.cu holds three kernels and
`w4_kernel_for` names the one a shape takes: "wgmma" (M > 16: the pipelined
warpgroup kernel), "splitk" (M <= 16: K split across the CTAs of a cluster by
`w4_split_plan`, the splits summed in split order through distributed shared
memory, so the result is the same bits run after run) and "mma_sync" (the
shapes those two do not take). `launches` counts the `w4_matmul` calls that
launched a kernel.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

# Kernel launches since the last reset; a caller sets it to 0 and reads it to
# show that a run went through the kernel.
launches = 0


SPLITK_MAX_M = 16          # rows of one m16 tile: the split-K kernel's M
SPLITK_TILE_N = 64         # output columns per split-K CTA
SPLITK_ROUND_CHUNKS = 8    # chunks (<= 64 k each) a CTA holds in shared memory at once
SPLITK_TARGET_CTAS = 528   # four CTAs on each of an H100's 132 SMs
SPLITK_MAX_SPLITS = 8      # the splits of a tile are one cluster (portable size 8)
KERNEL_IDS = {"mma_sync": 0, "wgmma": 1, "splitk": 2}


@functools.lru_cache(maxsize=None)
def w4_split_plan(din: int, dout: int, group: int) -> Optional[Tuple[int, int]]:
    """(groups per split, splits) of the split-K kernel for a (din, dout)
    linear, or None where it cannot take the group (one that does not fit
    SPLITK_ROUND_CHUNKS chunks of the largest of 64/32/16 k dividing it).
    Splits lie on group boundaries and cover the groups in order, each
    exactly once (the last split may be shorter): as many splits, up to
    SPLITK_MAX_SPLITS, as it takes to reach about SPLITK_TARGET_CTAS CTAs;
    a split that would just overflow one round of shared memory is cut to a
    round when that still fits the cluster."""
    if group <= 0 or group % 16 or din % group:
        return None
    chunk = 64 if group % 64 == 0 else 32 if group % 32 == 0 else 16
    round_groups = SPLITK_ROUND_CHUNKS * chunk // group
    if round_groups == 0:
        return None
    groups = din // group
    tiles = -(-dout // SPLITK_TILE_N)
    want_splits = min(SPLITK_MAX_SPLITS, groups, -(-SPLITK_TARGET_CTAS // tiles))
    gps = -(-groups // want_splits)
    if gps > round_groups and -(-groups // round_groups) <= SPLITK_MAX_SPLITS:
        gps = round_groups
    return gps, -(-groups // gps)


@functools.lru_cache(maxsize=None)
def w4_kernel_for(m: int, din: int, dout: int, group: int) -> str:
    """The name of the hand-written kernel that an (M, din) x (din, dout)
    product with this group takes on CUDA; raises for a group no kernel runs.
    Never the plain version."""
    if group <= 0 or group % 16 or din % group:
        raise ValueError(f"w4_matmul: group {group} must be a multiple of 16 dividing din {din}")
    if m <= SPLITK_MAX_M:
        return "splitk" if w4_split_plan(din, dout, group) is not None else "mma_sync"
    if group % 64 == 0 and dout % 16 == 0:
        return "wgmma"
    return "mma_sync"


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(din/2, dout) nibble-packed int8 -> (din, dout) int32 in [-8, 7]: the
    low nibble is row 2r, the high nibble row 2r + 1, both sign-extended.
    The shifts run in int32 (an int8 left shift would overflow)."""
    p = packed.int()
    low = (p << 28) >> 28
    high = p >> 4
    return torch.stack([low, high], dim=1).reshape(2 * packed.shape[0], packed.shape[1])


def w4_matmul_reference(
    x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, group: int
) -> torch.Tensor:
    """Plain version of the kernel: (M, din) @ dequant(packed, scales) ->
    (M, dout) in x's dtype; group partials in f32, each scaled in f32."""
    q = unpack_int4(packed).float()
    xf = x.float()
    out = torch.zeros(x.shape[0], packed.shape[1], dtype=torch.float32, device=x.device)
    for g in range(scales.shape[0]):
        rows = slice(g * group, (g + 1) * group)
        out += (xf[:, rows] @ q[rows]) * scales[g].float()
    return out.to(x.dtype)


def _check(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, group: int) -> None:
    for name, t in (("x", x), ("packed", packed), ("scales", scales)):
        if not t.is_cuda:
            raise ValueError(f"w4_matmul: {name} is on {t.device}, expected CUDA")
        if t.device != x.device:
            raise ValueError("w4_matmul: inputs on different devices")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"w4_matmul: {name} must be a contiguous 2-D tensor")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"w4_matmul: the kernel takes bf16 x, not {x.dtype}")
    if packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError("w4_matmul: packed must be int8 and scales f32")
    din = x.shape[1]
    if packed.shape[0] * 2 != din or scales.shape[1] != packed.shape[1]:
        raise ValueError(
            f"w4_matmul: shapes x {tuple(x.shape)} packed {tuple(packed.shape)} "
            f"scales {tuple(scales.shape)}"
        )
    if group <= 0 or group % 16 or scales.shape[0] * group != din:
        raise ValueError(f"w4_matmul: group {group} must be a multiple of 16 dividing din {din}")
    if x.data_ptr() % 16 or packed.data_ptr() % 16 or scales.data_ptr() % 16:
        raise ValueError("w4_matmul: x, packed and scales must be 16-byte aligned")


def w4_matmul(
    x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, group: int = 128,
    kernel: Optional[str] = None,
) -> torch.Tensor:
    """(M, din) @ dequant(packed (din/2, dout) int8, scales (G, dout) f32)
    -> (M, dout) in x's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel `w4_kernel_for` names on the current stream, or
    raise. `kernel` forces one of KERNEL_IDS instead (to time or test one
    against another); a shape that kernel does not take raises."""
    if x.device.type == "cpu":
        return w4_matmul_reference(x, packed, scales, group)
    _check(x, packed, scales, group)
    from visper_lm_tpu_torch.ops import _build

    global launches
    lib = _build.load("w4_matmul")
    m, din = x.shape
    dout = packed.shape[1]
    if kernel is None:
        kernel = w4_kernel_for(m, din, dout, group)
    elif kernel not in KERNEL_IDS:
        raise ValueError(f"w4_matmul: no kernel named {kernel!r} (one of {sorted(KERNEL_IDS)})")
    out = torch.empty((m, dout), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    gps = 0
    if kernel == "splitk":
        plan = w4_split_plan(din, dout, group)
        if plan is None or m > SPLITK_MAX_M:
            raise ValueError(f"w4_matmul: the split-K kernel does not take M {m}, group {group}")
        gps = plan[0]
    rc = lib.visper_w4_matmul(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
        m, din, dout, group, KERNEL_IDS[kernel], gps, stream,
    )
    if rc != 0:
        raise RuntimeError(f"w4_matmul: {kernel} kernel launch failed with CUDA error {rc}")
    launches += 1
    return out


def w4_supported(packed: torch.Tensor, scales: torch.Tensor, x: torch.Tensor) -> bool:
    """Whether a packed-int4 linear goes to the kernel: JAX `w4_supported`'s
    gate exactly (2-D packed and scales, din = 2 x packed rows, an even group
    >= 2). A group the kernel cannot run (not a multiple of 16) passes the
    gate and makes `w4_matmul` raise: it never falls back quietly."""
    if packed.ndim != 2 or scales.ndim != 2:
        return False
    din = packed.shape[0] * 2
    if x.shape[-1] != din or scales.shape[0] == 0 or din % scales.shape[0]:
        return False
    group = din // scales.shape[0]
    return group % 2 == 0 and group >= 2


def w4_linear(packed: torch.Tensor, scales: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (..., din) through `w4_matmul`, leading dims flattened and restored."""
    din = packed.shape[0] * 2
    lead = x.shape[:-1]
    y = w4_matmul(x.reshape(-1, din).contiguous(), packed, scales, din // scales.shape[0])
    return y.reshape(*lead, packed.shape[1])
