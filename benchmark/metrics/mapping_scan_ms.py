"""Median over the window's mapping scans of the host clock around the step
call, the card synchronised before and after (a traced run, outside its
profiled scans)."""

import statistics


def read(ctx):
    v = ctx.rec.step_ms["mapping"]
    return statistics.median(v) if v else None
