"""Device milliseconds of the pose graph's link scans a loop-closure
attempt: the profiler's device time of the kernels that take the
link-axis prefix sums of the re-solve's CG and update (K5's
``link_scan_rows`` and ``link_scan_ranges``, ``csrc/link_scan.cu``, or,
on a port without K5, PyTorch's ``tensor_kernel_scan_outer_dim``, which
``torch.cumsum(., dim=0)`` over the (M, 6) link array runs) over the
profiled scans, divided by the attempts made there (the tracer's
``loop_attempts`` tally).  So it reads the same work whatever implements
it.  None where no attempt was tallied or nothing traced.

The pose graph's two ``cumsum`` calls (``_hvp`` and ``_update``) are the
only outer-dimension scans ``vlp16_loop.grow`` runs: the port's other
``cumsum`` calls scan their last (innermost) dimension or a 1-D tensor
(features, voxel grouping, decimation), except the IMU de-skew's, which
the cell does not run, and the distributed solver's, which no cell runs.
On the parent's traced run the kernel's launches equal the re-solves' CG
chunks x 2 + GN steps (one a CG iteration, one a GN step)."""

from benchmark import trace

KERNELS = r"\blink_scan_(rows|ranges)\b|\btensor_kernel_scan_outer_dim\b"


def read(ctx):
    try:
        from legoloam_tpu_torch.utils import profiling
    except ImportError:
        return None
    tr = ctx.trace
    summary = getattr(profiling, "summary", None)
    s = summary() if summary is not None else None
    if tr is None or not s or not s["scans"]:
        return None
    attempts = s.get("tallies", {}).get("loop_attempts")
    if not attempts:
        return None
    us, _ = trace.kernel_time(tr, KERNELS)
    return us * 1e-3 / attempts
