"""Host milliseconds a scan inside ``graph.replay()`` (the program's
``slam.replay <chain>`` spans) over the traced steps: the cost of
launching the step's graphs.  Read from the program's tracer
(``legoloam_tpu_torch.utils.profiling``), which is on while the profiler
records, so it covers the profiled scans.

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
    return sum(c["launch_ms"] for c in s["chains"].values()) / s["scans"]
