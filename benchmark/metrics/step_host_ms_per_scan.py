"""Host milliseconds a scan in the program's step outside its replays and
reads (``slam.step`` less its ``slam.replay`` and ``slam.read``
children): the inputs' copy, the Python walk of the segments, the
outputs' copy.  From the program's tracer over the profiled scans.

In a ``--trace 1`` run this reads the profiled window, where CUPTI slows
every graph launch (on an H100 a replay's launch takes ~0.05-0.2 ms
alone, 7-15 ms profiled): a reading of the program under the profiler,
for finding where time goes, and no basis for claiming a gain;
chip_smoke.py's ``[tracing]`` gives the tracer's figures without it."""


def read(ctx):
    try:
        from legoloam_tpu_torch.utils import profiling
    except ImportError:
        return None
    summary = getattr(profiling, "summary", None)
    s = summary() if summary is not None else None
    if not s or not s["scans"]:
        return None
    return s["step_host_ms"] / s["scans"]
