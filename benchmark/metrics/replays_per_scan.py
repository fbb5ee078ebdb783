"""CUDA graph replays of the step program over the window's scans (the
runner's exact count)."""


def read(ctx):
    if not ctx.rec.scans or "replays" not in ctx.rec.counts:
        return None
    return ctx.rec.counts["replays"] / ctx.rec.scans
