"""Host reads the step's runner made (the submap branch on a mapping
scan) over the window's scans."""


def read(ctx):
    if not ctx.rec.scans or "reads" not in ctx.rec.counts:
        return None
    return ctx.rec.counts["reads"] / ctx.rec.scans
