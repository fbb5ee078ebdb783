"""Median over the open loop's tracking scans of the time from the step call
to the fused pose on the host (the card idle before the call)."""

import statistics


def read(ctx):
    v = ctx.rec.step_ms["tracking"]
    return statistics.median(v) if v else None
