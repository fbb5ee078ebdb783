"""Scans stepped in the window over the window's seconds (staging, the
sensor's stand-in, and the check's snapshots left out)."""


def read(ctx):
    if ctx.rec.window_s <= 0 or ctx.rec.scans == 0:
        return None
    return ctx.rec.scans / ctx.rec.window_s
