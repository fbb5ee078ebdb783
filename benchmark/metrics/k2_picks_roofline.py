"""K2's share of its roofline over the profiled scans: the least time its
launches could take (ranges, columns, ground flags read once, labels
written once; or its curvature and test operations, whichever bounds) over
the device time of ``picks_kernel``."""

from benchmark import trace, yardstick


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    us, launches = trace.kernel_time(tr, r"\bpicks_kernel\b")
    if not launches or us <= 0:
        return None
    s = ctx.cfg.sensor
    bound_ms, _ = yardstick.bound_ms(
        yardstick.picks_bytes(s.n_scan, s.horizon_scan),
        yardstick.picks_ops(s.n_scan, s.horizon_scan))
    return 100.0 * launches * bound_ms * 1e3 / us
