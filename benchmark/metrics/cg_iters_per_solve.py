"""CG iterations of a pose-graph re-solve: the iterations of its GN steps'
preconditioned CG (the runner's ``cg_iters`` tally, each GN step's count
once its stop flag is read) over the re-solves made in the traced scans
(``loops_closed``: an accepted closure re-solves the graph once).  From
the program's tracer over the profiled scans; None where no closure was
accepted there."""


def read(ctx):
    try:
        from legoloam_tpu_torch.utils import profiling
    except ImportError:
        return None
    summary = getattr(profiling, "summary", None)
    s = summary() if summary is not None else None
    if not s or not s["scans"]:
        return None
    tallies = s.get("tallies", {})
    solves = tallies.get("loops_closed")
    if not solves:
        return None
    return tallies.get("cg_iters", 0) / solves
