"""The share of the profiled window in which no kernel or copy ran on the
card: 1 - (the union of the device's intervals) / the window."""

from benchmark import yardstick


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_us <= 0:
        return None
    return 100.0 * yardstick.idle_share(tr.busy_us, tr.window_us)
