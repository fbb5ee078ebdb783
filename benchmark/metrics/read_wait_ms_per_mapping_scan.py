"""Host milliseconds a mapping scan blocked in the submap-branch read
(``slam.read submap branch``): the host waits there for the frontend's
chain to finish on the card.  From the program's tracer over the profiled
scans.

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
    if not s or not s["mapping_scans"]:
        return None
    span = s["spans"].get("slam.read submap branch")
    return span["ms"] / s["mapping_scans"] if span else None
