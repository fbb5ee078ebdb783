"""The share of the odometry's unrolled LM iterations that did work:
``surf_iters + corner_iters`` of the returned ``diag`` over the
2 x ``max_iterations`` a scan that run behind the freeze mask.  From the
program's tracer over the profiled scans."""


def read(ctx):
    try:
        from legoloam_tpu_torch.utils import profiling
    except ImportError:
        return None
    summary = getattr(profiling, "summary", None)
    s = summary() if summary is not None else None
    if not s or not s["scans"] or not s["lm_run"]:
        return None
    return 100.0 * s["lm_used"] / s["lm_run"]
