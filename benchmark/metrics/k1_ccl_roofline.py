"""K1's share of its roofline over the profiled scans: the least time its
launches could take (each image's seed and connectivity masks read once,
labels and ring extrema written once, at the card's HBM bandwidth) over
the device time of its three kernels.  One launch is counted a
``ccl_local`` record."""

from benchmark import trace, yardstick


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    _, launches = trace.kernel_time(tr, r"\bccl_local\b")
    us, _ = trace.kernel_time(tr, r"\bccl_(local|seams|resolve)\b")
    if not launches or us <= 0:
        return None
    s = ctx.cfg.sensor
    bound_ms, _ = yardstick.bound_ms(
        yardstick.ccl_bytes(s.n_scan, s.horizon_scan), 0.0)
    return 100.0 * launches * bound_ms * 1e3 / us
