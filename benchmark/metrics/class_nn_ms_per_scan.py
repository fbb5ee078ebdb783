"""K4's device milliseconds a scan: the profiler's device time of the
class-NN search's kernels (``class_nn_chunks``, ``class_nn_scan``,
``class_nn_merge``: ``csrc/class_nn.cu``) over the profiled scans, divided
by their number.  None where no such kernel ran (a program whose odometry
searches in plain PyTorch)."""

from benchmark import trace


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.rec.profiled_scans:
        return None
    us, launches = trace.kernel_time(tr,
                                     r"\bclass_nn_(chunks|scan|merge)\b")
    if not launches or us <= 0:
        return None
    return us * 1e-3 / ctx.rec.profiled_scans
