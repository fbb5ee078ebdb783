"""The benchmark's arithmetic: the card's peaks, the kernels' bytes and
bounds, the idle share of a traced window, percentiles.

Frozen copies of ``chip_smoke.py``'s ``bound_ms``, ``ccl_bytes``,
``picks_bytes`` and ``idle_share`` (the last reworked to take the device
intervals once, so a traced window is read in one pass), so that a change
to the program's own scripts cannot move them.
"""

from __future__ import annotations

# NVIDIA's data sheet for one H100 SXM at its 700 W limit: HBM3 bandwidth
# and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_ms(n_bytes: float, n_ops: float):
    """The least time the card could take: (ms, "bytes" or "operations"),
    whichever bounds."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ccl_bytes(n: int, h: int) -> int:
    """K1 on one (N, H) image: the seed and two connectivity masks read
    (bytes), the labels and the two ring extrema written (int32)."""
    return (2 * n * h + (n - 1) * h) + 3 * 4 * n * h


def picks_bytes(n: int, h: int) -> int:
    """K2 on one (N, H) image: ranges, columns and ground flags read,
    labels written, and the per-ring counts."""
    return (4 + 4 + 1 + 4) * n * h + 4 * n


def picks_ops(n: int, h: int) -> float:
    """K2's operations: the curvature (12 flops a cell) and the occlusion
    and parallel-beam tests (~8)."""
    return 20.0 * n * h


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    iv = sorted(intervals)
    if not iv:
        return 0.0
    busy, (a, b) = 0.0, iv[0]
    for c, d in iv[1:]:
        if c > b:
            busy, a, b = busy + (b - a), c, d
        else:
            b = max(b, d)
    return busy + (b - a)


def gaps(intervals, w0: float, w1: float):
    """The idle (start, end) gaps of the window [w0, w1] between the
    union of ``intervals``."""
    out, t = [], w0
    for a, b in sorted(intervals):
        if a > t:
            out.append((t, min(a, w1)))
        t = max(t, b)
    if t < w1:
        out.append((t, w1))
    return [(a, b) for a, b in out if b > a]


def idle_share(busy_us: float, window_us: float) -> float:
    """1 - busy / window."""
    return 1.0 - busy_us / window_us


def percentile(values, q: float) -> float:
    """The ``q`` (0..1) quantile by nearest rank of sorted ``values``."""
    v = sorted(values)
    return v[min(len(v) - 1, int(round(q * (len(v) - 1))))]

