"""Host reads a loop-closure attempt makes: the ICP's stop flag once a
chunk of iterations, the acceptance once, and on a closure the CG's stop
flag once a chunk of iterations of each GN step (the tracer's
``slam.read ICP stop``, ``slam.read loop accepted`` and ``slam.read CG
stop`` spans), over the attempts made in the traced scans.  From the
program's tracer over the profiled scans; None where it tallies no
attempt."""

READS = ("slam.read ICP stop", "slam.read loop accepted",
         "slam.read CG stop")


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
    return sum(s["spans"].get(n, {"count": 0})["count"]
               for n in READS) / attempts
