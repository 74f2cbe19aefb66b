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

`w4_matmul` launches the kernel for CUDA tensors (bf16 x) or raises; CPU
tensors take the plain version. `launches` counts kernel launches.
"""

from __future__ import annotations

import torch

# Kernel launches since the last reset; a caller sets it to 0 and reads it to
# show that a run went through the kernel.
launches = 0


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
    if group % 16 or scales.shape[0] * group != din:
        raise ValueError(f"w4_matmul: group {group} must be a multiple of 16 dividing din {din}")
    if x.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("w4_matmul: x and packed must be 16-byte aligned")


def w4_matmul(
    x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, group: int = 128
) -> torch.Tensor:
    """(M, din) @ dequant(packed (din/2, dout) int8, scales (G, dout) f32)
    -> (M, dout) in x's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream or raise."""
    if x.device.type == "cpu":
        return w4_matmul_reference(x, packed, scales, group)
    _check(x, packed, scales, group)
    from visper_lm_tpu_torch.ops import _build

    global launches
    lib = _build.load("w4_matmul")
    m, din = x.shape
    dout = packed.shape[1]
    out = torch.empty((m, dout), dtype=x.dtype, device=x.device)
    rc = lib.visper_w4_matmul(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
        m, din, dout, group, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"w4_matmul: kernel launch failed with CUDA error {rc}")
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
