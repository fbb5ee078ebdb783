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

The JAX package's ``lax.scan`` over hypotheses is a Python loop here.  A
hypothesis whose candidate is out of range skips its ICP (the JAX program
runs it on empty clouds and discards it with an infinite fitness), and each
candidate's submap is built once for all its headings.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..config import PipelineConfig, RelocalizeConfig
from ..ops import icp as icp_ops
from ..ops import se3
from ..ops.se3 import Pose
from ..ops.voxel import voxel_representative
from .loopclosure import window_cloud
from .mapping import KeyframeStore, dedup_positions


class RelocDiag(NamedTuple):
    accepted: torch.Tensor      # () bool
    candidate: torch.Tensor     # () int32 keyframe index of the winner
    fitness: torch.Tensor       # () best ICP fitness (mean sq NN distance)
    n_candidates: torch.Tensor  # () int32 candidates in range


def relocalize(kf: KeyframeStore, scan_pts, scan_valid, prior: Pose,
               cfg: RelocalizeConfig) -> Tuple[Pose, RelocDiag]:
    """The scan's world pose in the keyframe map: (the corrected pose, or
    the prior when rejected; diagnostics).  ``scan_pts`` (N, 3) in the
    sensor (scan-end) frame."""
    dev = kf.t.device
    m = kf.t.shape[0]
    inf = torch.tensor(math.inf, device=dev)
    kf_ok = torch.arange(m, device=dev) < kf.count
    rep = dedup_positions(kf.t, kf_ok, prior.t, cfg.candidate_leaf)
    d2 = torch.sum((kf.t - prior.t[None]) ** 2, dim=-1)
    d2 = torch.where(rep, d2, inf)
    n_cand = min(cfg.n_candidates, m)
    cand_d2, cand = torch.sort(d2, stable=True)
    cand_ok = torch.isfinite(cand_d2[:n_cand])
    cand_h = cand[:n_cand].tolist()
    ok_h = cand_ok.tolist()

    pts, val = voxel_representative(scan_pts, scan_valid, cfg.scan_leaf,
                                    cfg.cur_cap)
    n_yaw = max(cfg.yaw_hypotheses, 1)
    yaws = torch.arange(cfg.yaw_hypotheses, device=dev) * (2.0 * math.pi
                                                           / n_yaw)
    ez = torch.tensor([0.0, 0.0, 1.0], device=dev)
    windows = {}

    def submap(idx: int):
        if idx not in windows:
            windows[idx] = window_cloud(kf, torch.tensor(idx, device=dev),
                                        cfg.window, cfg.submap_leaf,
                                        cfg.hist_cap)
        return windows[idx]

    def align(T0: Pose, idx: int, iters: int):
        """ICP of the scan placed at ``T0`` onto ``idx``'s submap: (the
        fitness gated on PCL's hasConverged, the aligned pose)."""
        hist_pts, hist_val = submap(idx)
        res = icp_ops.icp(se3.transform_points(T0, pts), val, hist_pts,
                          hist_val, Pose.identity(device=dev),
                          max_corr_dist=cfg.icp_max_corr_dist,
                          max_iters=iters, eps=cfg.icp_eps, chunk=1)
        fit = torch.where(res.has_converged, res.fitness, inf)
        return fit, se3.compose(res.pose, T0)

    # Coarse stage over every (candidate, heading) hypothesis.
    fits, poses, idxs = [], [], []
    for h in range(n_cand * n_yaw):
        ci, yi = h // n_yaw, h % n_yaw
        idx = cand_h[ci]
        T_h = Pose(se3.so3_exp(ez * yaws[yi]) @ kf.R[idx], kf.t[idx])
        if ok_h[ci]:
            fit, T_h = align(T_h, idx, cfg.coarse_iters)
        else:
            fit = inf
        fits.append(fit)
        poses.append(T_h)
        idxs.append(idx)

    # Refine stage: the best coarse hypotheses run the full ICP (a wrong
    # place can out-score the right one at coarse depth on self-similar
    # worlds).
    fits = torch.stack(fits)
    top = torch.sort(fits, stable=True).indices[:min(cfg.refine_top_k,
                                                     len(idxs))].tolist()
    best_fit, best_T = inf, prior
    best_idx = torch.tensor(-1, dtype=torch.int32, device=dev)
    for h in top:
        if not math.isfinite(float(fits[h])):
            continue
        fit_r, T_r = align(poses[h], idxs[h], cfg.icp_max_iters)
        better = fit_r < best_fit
        best_T = se3.where_pose(better, T_r, best_T)
        best_fit = torch.where(better, fit_r, best_fit)
        best_idx = torch.where(better, idxs[h], best_idx).to(torch.int32)

    accepted = (best_fit < cfg.fitness_thresh) & (kf.count > 0)
    T_out = se3.where_pose(accepted, best_T, prior)
    # Orthonormality insurance on the chained heading and ICP rotations.
    T_out = Pose(se3.so3_project(T_out.R), T_out.t)
    return T_out, RelocDiag(accepted=accepted, candidate=best_idx,
                            fitness=best_fit,
                            n_candidates=cand_ok.sum().to(torch.int32))


def relocalize_slam_state(state, cfg: PipelineConfig):
    """Relocalize the current scan (the odometry state's last corner and
    surf clouds: call after at least one ``slam_scan_step``) in the state's
    keyframe map, and rebase the mapping correction so the fused output
    continues on the map: ``t_bef`` = the odometry pose, ``t_aft`` = the
    relocalized pose.  Returns (state, diag); the state is unchanged when
    relocalization is rejected."""
    od, mp = state.odom, state.mapping
    pts = torch.cat([od.last_corner.xyz, od.last_surf.xyz], dim=0)
    val = torch.cat([od.last_corner.valid, od.last_surf.valid], dim=0)
    T, diag = relocalize(mp.kf, pts, val, mp.t_aft, cfg.reloc)
    ok = diag.accepted
    mapping = mp._replace(
        t_bef=se3.where_pose(ok, od.pose, mp.t_bef),
        t_aft=se3.where_pose(ok, T, mp.t_aft),
        # The submap cache's origin predates the jump.
        cache=mp.cache._replace(stale=mp.cache.stale | ok),
        initialized=mp.initialized | ok)
    return state._replace(mapping=mapping), diag
