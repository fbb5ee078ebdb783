"""The union of the device's intervals over the profiled scans of the
open loop, a scan."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.scans:
        return None
    return tr.busy_us * 1e-3 / tr.scans
