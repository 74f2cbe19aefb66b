"""What one kernel launch needs, from its shapes: floating-point operations
and the bytes of its inputs read once and its outputs written once; and the
least time an H100 SXM could take for it."""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

PEAK_BF16 = 989e12          # dense bf16 tensor-core FLOP/s, H100 SXM (data sheet)
PEAK_BYTES = 3.35e12        # HBM3 bytes/s


def attention_pairs(t: int, s: int, causal: bool, lens: Optional[np.ndarray],
                    starts: Optional[np.ndarray], b: int) -> int:
    """The (query, key) pairs a masked attention needs, summed over the batch:
    row i sees keys j with starts <= j < lens and, when causal, j <= i + s - t."""
    lens = np.full(b, s) if lens is None else np.asarray(lens, np.int64).reshape(-1)
    starts = np.zeros(b, np.int64) if starts is None else np.asarray(starts, np.int64).reshape(-1)
    rows = np.arange(t)[None, :]
    hi = np.minimum(lens[:, None], (rows + (s - t) + 1) if causal else s)
    return int(np.clip(hi - starts[:, None], 0, None).sum())


def flash_launch(kind: str, q, k, causal: bool, lens, starts) -> tuple:
    """(flops, bytes) of a B1 (kind 'fwd'), B2 ('dq') or B3 ('dkv') launch:
    q (B, T, Nq, H), k (B, S, Nkv, H), bf16 tensors, f32 lse and delta."""
    b, t, nq, h = q
    s, nkv = k[1], k[2]
    pairs = attention_pairs(t, s, causal, lens, starts, b) * nq
    q_b, kv_b, stat_b = b * t * nq * h * 2, b * s * nkv * h * 2, b * nq * t * 4
    if kind == "fwd":             # S = Q K^T, O = P V
        return 4.0 * h * pairs, q_b + 2 * kv_b + q_b + stat_b
    if kind == "dq":              # S, dP = dO V^T, dQ = dS K
        return 6.0 * h * pairs, q_b + 2 * kv_b + q_b + 2 * stat_b + q_b
    if kind == "dkv":             # S, dP, dK = dS^T Q, dV = P^T dO
        return 8.0 * h * pairs, q_b + 2 * kv_b + q_b + 2 * stat_b + 2 * kv_b
    raise ValueError(kind)


def window_launch(q, nw: int) -> tuple:
    """(flops, bytes) of a B4 launch: q (W, heads, N, D) bf16, the f32 bias
    (heads, N, N) and, shifted, the f32 mask (nW, N, N)."""
    w, heads, n, d = q
    flops = 4.0 * w * heads * n * n * d
    data = 4 * w * heads * n * d * 2 + heads * n * n * 4 + nw * n * n * 4
    return flops, data


def bound_seconds(flops: float, data: float) -> float:
    return max(flops / PEAK_BF16, data / PEAK_BYTES)


def launch_bound(call: dict) -> float:
    """The least time of one recorded launch (harness/trace.LaunchRecorder)."""
    if call["kind"] == "window":
        return bound_seconds(*window_launch(call["q"], call["nw"]))

    def host(x):
        return None if x is None else x.detach().cpu().numpy()

    return bound_seconds(*flash_launch(call["kind"], call["q"], call["k"], call["causal"],
                                       host(call["lens"]), host(call["starts"])))


def roofline_share(calls: Iterable[dict], kernel_seconds: dict) -> Optional[float]:
    """Sum of the launches' least times over the sum of their device times, in
    percent, over the kinds whose recorded launches and traced kernels agree
    in number; None when no kind does."""
    by_kind: dict = {}
    for c in calls:
        by_kind.setdefault(c["kind"], []).append(c)
    bound = spent = 0.0
    for kind, cs in by_kind.items():
        times = kernel_seconds.get(kind, [])
        if len(times) != len(cs) or not cs:
            continue
        bound += sum(launch_bound(c) for c in cs)
        spent += sum(times)
    if spent <= 0:
        return None
    return 100.0 * bound / spent
