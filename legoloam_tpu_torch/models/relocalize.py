"""Kidnapped-robot relocalization against a keyframe map (port of
``legoloam_tpu/models/relocalize.py``: the reference's loop-closure ICP,
``src/mapOptmization.cpp:875-945``, generalised to a scan taken at an
unknown pose).

  1. Candidates: keyframe positions deduped at ``candidate_leaf``, ranked by
     distance to the prior belief, the nearest ``n_candidates`` (a stable
     sort, so ties keep the lower index as ``lax.top_k`` does).
  2. Hypotheses: ``yaw_hypotheses`` headings per candidate (its attitude
     rotated about world z).
  3. Coarse stage: ``coarse_iters`` ICP iterations per hypothesis against a
     ±``window``-keyframe submap around the candidate.
  4. Refine stage: the ``refine_top_k`` best coarse hypotheses run the full
     ``icp_max_iters``; the best refined fitness wins if below
     ``fitness_thresh``.

As the JAX package's one compiled program, every decision stays on the
device.  The JAX ``lax.scan`` over hypotheses is one body a candidate —
its window submap once, its headings' ICPs batched (one K3 search of
``n_yaw x cur_cap`` queries an iteration), ``coarse_iters`` iterations
unrolled with a freeze mask per heading — run ``n_cand`` times with the
candidate's rank in a device buffer, writing each heading's fitness, pose
and keyframe into (n_hyp,) buffers.  A candidate out of range runs frozen
and gets an infinite fitness, as in JAX.  The refine stage is one body a
rank, run ``refine_top_k`` times: the full ICP in chunks of
``REFINE_CHUNK`` iterations with one read of the stop flag a chunk.
Through a graph runner (``step_graph.make_runner``) each body is captured
once and replayed (``rt.cut()`` ends each pass), so the pool does not grow
with the candidate count.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Tuple

import torch

from ..config import PipelineConfig, RelocalizeConfig
from ..device import at, const
from ..ops import icp as icp_ops
from ..ops import se3
from ..ops.se3 import Pose
from ..ops.segments import EAGER
from ..ops.voxel import voxel_representative
from .loopclosure import window_cloud
from .mapping import KeyframeStore, dedup_positions

# The refine ICP's iterations a chunk, with one read of the stop flag a
# chunk.  Unrolling all ``icp_max_iters`` with a freeze mask (no read) took
# 2.7 s a DEFAULT relocalization on the card against 1.1 s in chunks of 8:
# a frozen iteration still runs its small kernels (PERF.md, PR 9).
REFINE_CHUNK = icp_ops.CHUNK


class RelocDiag(NamedTuple):
    accepted: torch.Tensor      # () bool
    candidate: torch.Tensor     # () int32 keyframe index of the winner
    fitness: torch.Tensor       # () best ICP fitness (mean sq NN distance)
    n_candidates: torch.Tensor  # () int32 candidates in range


class _Search(NamedTuple):
    """The candidates, the scan cloud and the coarse stage's results."""

    cand: torch.Tensor       # (n_cand,) int64 keyframe indices
    cand_ok: torch.Tensor    # (n_cand,) bool in range
    pts: torch.Tensor        # (cur_cap, 3) scan cloud, sensor frame
    val: torch.Tensor        # (cur_cap,)
    rank: torch.Tensor       # () int64 the candidate the coarse body takes
    fits: torch.Tensor       # (n_hyp,) coarse fitness, inf when rejected
    R: torch.Tensor          # (n_hyp, 3, 3) coarse-aligned hypothesis poses
    t: torch.Tensor          # (n_hyp, 3)
    idx: torch.Tensor        # (n_hyp,) int64 each hypothesis' keyframe


class _Best(NamedTuple):
    """The refine stage's running best."""

    top: torch.Tensor        # (k_ref,) int64 hypotheses by coarse fitness
    rank: torch.Tensor       # () int64 the rank the refine body takes
    fit: torch.Tensor        # ()
    R: torch.Tensor
    t: torch.Tensor
    idx: torch.Tensor        # () int32, -1 if none


def _search(kf: KeyframeStore, scan_pts, scan_valid, prior: Pose,
            cfg: RelocalizeConfig) -> _Search:
    """The candidate cells (position dedup and distance-to-prior ranking)
    and the scan cloud bounded to ``cur_cap``."""
    dev = kf.t.device
    m = kf.t.shape[0]
    n_cand = min(cfg.n_candidates, m)
    n_hyp = n_cand * max(cfg.yaw_hypotheses, 1)
    kf_ok = torch.arange(m, device=dev) < kf.count
    rep = dedup_positions(kf.t, kf_ok, prior.t, cfg.candidate_leaf)
    d2 = torch.sum((kf.t - prior.t[None]) ** 2, dim=-1)
    d2 = torch.where(rep, d2, torch.full_like(d2, math.inf))
    cand_d2, cand = torch.sort(d2, stable=True)
    pts, val = voxel_representative(scan_pts, scan_valid, cfg.scan_leaf,
                                    cfg.cur_cap)
    return _Search(
        cand=cand[:n_cand], cand_ok=torch.isfinite(cand_d2[:n_cand]),
        pts=pts, val=val, rank=torch.zeros((), dtype=torch.int64, device=dev),
        fits=torch.full((n_hyp,), math.inf, device=dev),
        R=torch.eye(3, device=dev).expand(n_hyp, 3, 3).clone(),
        t=torch.zeros((n_hyp, 3), device=dev),
        idx=torch.zeros((n_hyp,), dtype=torch.int64, device=dev))


def _window(kf: KeyframeStore, idx, cfg: RelocalizeConfig):
    return window_cloud(kf, idx, cfg.window, cfg.submap_leaf, cfg.hist_cap)


def _placed_fit(res: icp_ops.IcpResult, T0: Pose, ok):
    """The fitness gated on ``ok`` and PCL's hasConverged, and the aligned
    pose (the ICP's correction after ``T0``)."""
    fit = torch.where(ok & res.has_converged, res.fitness,
                      torch.full_like(res.fitness, math.inf))
    return fit, se3.compose(res.pose, T0)


def _coarse(kf: KeyframeStore, s: _Search, cfg: RelocalizeConfig) -> _Search:
    """One candidate (``s.rank``) with all its headings: the window
    submap, the scan placed at each heading, ``coarse_iters`` batched ICP
    iterations; each heading's result written into ``s``'s (n_hyp,)
    buffers in place, and the rank advanced."""
    dev = kf.t.device
    n_yaw = max(cfg.yaw_hypotheses, 1)
    idx = at(s.cand, s.rank)
    ok = at(s.cand_ok, s.rank)
    hist_pts, hist_val = _window(kf, idx, cfg)
    yaws = torch.arange(cfg.yaw_hypotheses, device=dev) * (2.0 * math.pi
                                                           / n_yaw)
    ez = const((0.0, 0.0, 1.0), dev)
    T_h = Pose(se3.so3_exp(yaws[:, None] * ez) @ at(kf.R, idx),
               at(kf.t, idx).expand(n_yaw, 3))
    src = se3.transform_points(T_h, s.pts.expand(n_yaw, *s.pts.shape))
    src_val = s.val.expand(n_yaw, *s.val.shape)
    max_corr_sq = cfg.icp_max_corr_dist ** 2
    st = icp_ops.icp_start(Pose.identity((n_yaw,), device=dev),
                           frozen=~ok, max_iters=cfg.coarse_iters)
    st = icp_ops.icp_iterate(st, src, src_val, hist_pts, hist_val,
                             cfg.coarse_iters, cfg.coarse_iters, cfg.icp_eps,
                             max_corr_sq)
    res = icp_ops.icp_result(st, src, src_val, hist_pts, hist_val,
                             max_corr_sq)
    fit, T = _placed_fit(res, T_h, ok)
    rows = s.rank * n_yaw + torch.arange(n_yaw, device=dev)
    s.fits.index_copy_(0, rows, fit)
    s.R.index_copy_(0, rows, T.R)
    s.t.index_copy_(0, rows, T.t)
    s.idx.index_copy_(0, rows, idx.expand(n_yaw))
    s.rank.add_(1)
    return s


def _top(s: _Search, prior: Pose, cfg: RelocalizeConfig) -> _Best:
    """The ``refine_top_k`` best coarse hypotheses (stable: ties to the
    lower index, as ``lax.top_k``) and the empty best."""
    dev = s.fits.device
    k_ref = min(cfg.refine_top_k, s.fits.shape[0])
    return _Best(top=torch.sort(s.fits, stable=True).indices[:k_ref],
                 rank=torch.zeros((), dtype=torch.int64, device=dev),
                 fit=torch.full((), math.inf, device=dev),
                 R=prior.R.clone(), t=prior.t.clone(),
                 idx=torch.full((), -1, dtype=torch.int32, device=dev))


class _Refine(NamedTuple):
    """One refine rank's inputs: the hypothesis' pose, its window, the
    scan placed there (masked when the hypothesis was rejected)."""

    h: torch.Tensor
    ok: torch.Tensor
    frozen: torch.Tensor
    T: Pose
    src: torch.Tensor
    src_val: torch.Tensor
    hist_pts: torch.Tensor
    hist_val: torch.Tensor
    init: Pose


def _refine_prepare(kf: KeyframeStore, s: _Search, b: _Best,
                    cfg: RelocalizeConfig) -> _Refine:
    h = at(b.top, b.rank)
    ok = torch.isfinite(at(s.fits, h))
    T = Pose(at(s.R, h), at(s.t, h))
    hist_pts, hist_val = _window(kf, torch.clamp(at(s.idx, h), min=0), cfg)
    return _Refine(h=h, ok=ok, frozen=~ok, T=T,
                   src=se3.transform_points(T, s.pts), src_val=s.val & ok,
                   hist_pts=hist_pts, hist_val=hist_val & ok,
                   init=Pose.identity(device=kf.t.device))


def _refine_update(s: _Search, b: _Best, r: _Refine, res) -> _Best:
    """relocalize.py:160-164's ``where(better, ...)``, in place, and the
    rank advanced."""
    fit, T = _placed_fit(res, r.T, r.ok)
    better = fit < b.fit
    b.R.copy_(torch.where(better, T.R, b.R))
    b.t.copy_(torch.where(better, T.t, b.t))
    b.idx.copy_(torch.where(better, at(s.idx, r.h).to(torch.int32), b.idx))
    b.fit.copy_(torch.where(better, fit, b.fit))
    b.rank.add_(1)
    return b


def _outcome(kf: KeyframeStore, s: _Search, b: _Best, prior: Pose,
             cfg: RelocalizeConfig):
    accepted = (b.fit < cfg.fitness_thresh) & (kf.count > 0)
    T_out = se3.where_pose(accepted, Pose(b.R, b.t), prior)
    # Orthonormality insurance on the chained heading and ICP rotations.
    T_out = Pose(se3.so3_project(T_out.R), T_out.t)
    return T_out, RelocDiag(accepted=accepted, candidate=b.idx.clone(),
                            fitness=b.fit.clone(),
                            n_candidates=s.cand_ok.sum().to(torch.int32))


def relocalize(kf: KeyframeStore, scan_pts, scan_valid, prior: Pose,
               cfg: RelocalizeConfig, rt=EAGER) -> Tuple[Pose, RelocDiag]:
    """The scan's world pose in the keyframe map: (the corrected pose, or
    the prior when rejected; diagnostics).  ``scan_pts`` (N, 3) in the
    sensor (scan-end) frame.  ``rt``: the segment runner (the eager one,
    or ``step_graph.make_runner``'s)."""
    n_cand = min(cfg.n_candidates, kf.t.shape[0])
    s = rt.seg(("reloc", "search", cfg), partial(_search, cfg=cfg), kf,
               scan_pts, scan_valid, prior)
    for _ in range(n_cand):
        s = rt.seg(("reloc", "coarse", cfg), partial(_coarse, cfg=cfg), kf,
                   s, into=s)
        rt.cut()
    b = rt.seg(("reloc", "top", cfg), partial(_top, cfg=cfg), s, prior)
    k_ref = b.top.shape[0]
    for _ in range(k_ref):
        r = rt.seg(("reloc", "refine prepare", cfg),
                   partial(_refine_prepare, cfg=cfg), kf, s, b)
        res = icp_ops.icp(r.src, r.src_val, r.hist_pts, r.hist_val, r.init,
                          max_corr_dist=cfg.icp_max_corr_dist,
                          max_iters=cfg.icp_max_iters, eps=cfg.icp_eps,
                          frozen=r.frozen, chunk=REFINE_CHUNK, rt=rt,
                          key="reloc icp")
        b = rt.seg(("reloc", "refine update"), _refine_update, s, b, r, res,
                   into=b)
        rt.cut()
    return rt.seg(("reloc", "outcome", cfg), partial(_outcome, cfg=cfg), kf,
                  s, b, prior)


def _rebase(state, T: Pose, diag: RelocDiag):
    """The mapping correction rebased so the fused output continues on the
    map, where accepted: (``t_bef`` = the odometry pose, ``t_aft`` = the
    relocalized pose, the submap cache's stale flag, ``initialized``)."""
    od, mp = state.odom, state.mapping
    ok = diag.accepted
    # The submap cache's origin predates the jump.
    return (se3.where_pose(ok, od.pose, mp.t_bef),
            se3.where_pose(ok, T, mp.t_aft), mp.cache.stale | ok,
            mp.initialized | ok)


def relocalize_slam_state(state, cfg: PipelineConfig, rt=None):
    """Relocalize the current scan (the odometry state's last corner and
    surf clouds: call after at least one ``slam_scan_step``) in the state's
    keyframe map, and rebase the mapping correction so the fused output
    continues on the map: ``t_bef`` = the odometry pose, ``t_aft`` = the
    relocalized pose.  Returns (state, diag); the state is unchanged when
    relocalization is rejected.  On the card the search runs as captured
    CUDA graphs; the results are device tensors.  ``rt``: the segment
    runner to use instead (``make_runner(device, graph=False)`` runs the
    eager body on the card; its ``reads`` count the host reads)."""
    from .step_graph import make_runner
    od, mp = state.odom, state.mapping
    if rt is None:
        rt = make_runner(od.xi.device)
    rt.adopt(state)
    pts, val = rt.adopt((
        torch.cat([od.last_corner.xyz, od.last_surf.xyz], dim=0),
        torch.cat([od.last_corner.valid, od.last_surf.valid], dim=0)))
    T, diag = relocalize(mp.kf, pts, val, mp.t_aft, cfg.reloc, rt=rt)
    t_bef, t_aft, stale, initialized = rt.seg(("reloc", "rebase"), _rebase,
                                              state, T, diag)
    rt.flush()
    mapping = mp._replace(t_bef=t_bef, t_aft=t_aft,
                          cache=mp.cache._replace(stale=stale),
                          initialized=initialized)
    return state._replace(mapping=mapping), diag
