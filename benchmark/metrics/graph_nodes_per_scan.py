"""CUDA graph nodes launched a scan: each replayed chain's node count
(``cuGraphGetNodes`` at its capture) summed over the traced steps, over
their scans.  From the program's tracer over the profiled scans."""


def read(ctx):
    try:
        from legoloam_tpu_torch.utils import profiling
    except ImportError:
        return None
    summary = getattr(profiling, "summary", None)
    s = summary() if summary is not None else None
    if not s or not s["scans"] or not s["chains"]:
        return None
    return s["nodes"] / s["scans"]
