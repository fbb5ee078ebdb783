"""Device milliseconds of a loop-closure attempt: the device spans of the
chains an attempt runs (those whose first segment is the loop's, its
ICP's or the pose graph's: ``loop+loop icp``, ``loop icp``,
``loop icp+loop``, ``loop+fuse``, ``pg``, ``pg+loop+fuse``) summed over
the traced scans, over the attempts made there (the runner's
``loop_attempts`` tally).  From the
program's tracer over the profiled scans; None where it tallies no
attempt.

In a ``--trace 1`` run this reads the profiled window, where CUPTI slows
every graph launch: a reading of the program under the profiler, for
finding where time goes, and no basis for claiming a gain."""

LOOP_HEADS = ("loop", "pg")


def read(ctx):
    try:
        from legoloam_tpu_torch.utils import profiling
    except ImportError:
        return None
    summary = getattr(profiling, "summary", None)
    s = summary() if summary is not None else None
    if not s or not s["scans"]:
        return None
    attempts = s.get("tallies", {}).get("loop_attempts")
    if not attempts:
        return None
    ms = sum(sum(c["device_ms"]) for name, c in s["chains"].items()
             if name.split("+")[0].split()[0] in LOOP_HEADS)
    return ms / attempts
