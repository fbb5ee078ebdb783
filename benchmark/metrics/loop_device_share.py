"""The share of the step's device time that loop closure takes: the
device spans of the chains a loop attempt runs (first segment the
loop's, its ICP's or the pose graph's: ``loop``, ``loop icp``, ``pg``)
over those of every chain, in the traced scans.  From the program's tracer over the profiled scans; None
where it tallies no attempt.

In a ``--trace 1`` run this reads the profiled window, where CUPTI slows
every graph launch, and a chain's span runs from the later of its launch's
end and the previous work: a reading of the program under the profiler,
for finding where time goes, and no basis for claiming a gain."""

LOOP_HEADS = ("loop", "pg")


def read(ctx):
    try:
        from legoloam_tpu_torch.utils import profiling
    except ImportError:
        return None
    summary = getattr(profiling, "summary", None)
    s = summary() if summary is not None else None
    if not s or not s["scans"] or not s.get("tallies", {}).get(
            "loop_attempts"):
        return None
    loop = every = 0.0
    for name, c in s["chains"].items():
        ms = sum(c["device_ms"])
        every += ms
        if name.split("+")[0].split()[0] in LOOP_HEADS:
            loop += ms
    return 100.0 * loop / every if every > 0 else None
