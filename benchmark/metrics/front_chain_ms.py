"""Median device milliseconds of the graph chain that runs the frontend
and odometry (``front...`` in the SLAM step, ``odometry`` alone): from
its start (the later of the timing event recorded before its replay and
the end of its launch) to the event after it.  From the program's tracer
over the profiled scans.

In a ``--trace 1`` run this reads the profiled window, where CUPTI slows
every graph launch (on an H100 a replay's launch takes ~0.05-0.2 ms
alone, 7-15 ms profiled): a reading of the program under the profiler,
for finding where time goes, and no basis for claiming a gain;
chip_smoke.py's ``[tracing]`` gives the tracer's figures without it."""

import statistics


def read(ctx):
    try:
        from legoloam_tpu_torch.utils import profiling
    except ImportError:
        return None
    summary = getattr(profiling, "summary", None)
    s = summary() if summary is not None else None
    if not s or not s["scans"]:
        return None
    ms = [m for name, c in s["chains"].items()
          if name.split("+")[0] in ("front", "odometry")
          for m in c["device_ms"]]
    return statistics.median(ms) if ms else None
