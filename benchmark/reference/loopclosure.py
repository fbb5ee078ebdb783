"""ICP loop closure (frozen plain copy of ``models/loopclosure.py``;
LeGO-LOAM's ``loopClosureThread`` / ``performLoopClosure`` /
``correctPoses``, ``src/mapOptmization.cpp:802-945,1456-1478``).

One attempt: detect the nearest keyframe within ``search_radius`` that is
older than ``min_time_gap`` than the latest; align the latest keyframe's
corner and surface cloud (world frame) onto the ±``history_num``-keyframe
window around it by ICP (``icp.py``); accept on PCL's ``hasConverged`` and
a fitness below ``fitness_thresh``; append the between-factor
Z = T_cor⁻¹ ∘ T_old with the fitness as its variance, re-solve the pose
graph (``posegraph.py``) and take its poses for every keyframe.

Departures from the source, as the port's: the attempt runs on data time
within the step, not in a 1 Hz thread beside it; the window leaves out
keyframes within ``min_time_gap`` of the latest (the current pass); both
clouds are deduplicated to one representative point a ``submap_leaf`` voxel
and held at fixed caps (``cur_cap``, ``hist_cap``); with no candidate both
clouds are masked and the ICP runs no iteration.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import icp as icp_ops
from . import posegraph, se3
from .config import LoopClosureConfig, PoseGraphConfig
from .device import at
from .mapping import KeyframeStore
from .posegraph import LoopFactors
from .se3 import Pose
from .voxel import voxel_representative


class LoopDiag(NamedTuple):
    candidate: torch.Tensor   # () int32, -1 if none
    fitness: torch.Tensor
    closed: torch.Tensor      # () bool


def detect(kf: KeyframeStore, cfg: LoopClosureConfig) -> torch.Tensor:
    """Index of the closure candidate for the latest keyframe, or -1 (the
    first minimum on ties)."""
    m = kf.t.shape[0]
    cur = kf.count.long() - 1
    ok = (torch.arange(m, device=kf.t.device) < kf.count) \
        & (at(kf.time, cur) - kf.time > cfg.min_time_gap)
    d2 = torch.sum((kf.t - at(kf.t, cur)[None]) ** 2, dim=-1)
    d2 = torch.where(ok, d2, torch.full_like(d2, math.inf))
    best = torch.argmin(d2)
    found = at(d2, best) < cfg.search_radius ** 2
    return torch.where(found, best, -1).to(torch.int32)


def _world_cloud(kf: KeyframeStore, idx):
    """One keyframe's stored corner and surface clouds in world
    coordinates."""
    pose = Pose(at(kf.R, idx), at(kf.t, idx))
    return (torch.cat([se3.transform_points(pose, at(kf.corner, idx)),
                       se3.transform_points(pose, at(kf.surf, idx))], dim=0),
            torch.cat([at(kf.corner_valid, idx), at(kf.surf_valid, idx)],
                      dim=0))


def _history_cloud(kf: KeyframeStore, center, cfg: LoopClosureConfig):
    """The keyframes ``center ± history_num`` in world coordinates, those
    within ``min_time_gap`` of the latest left out, one representative
    point a ``submap_leaf`` voxel, at most ``hist_cap``
    (historyKeyframeSearchNum = 25, utility.h:133)."""
    dev = kf.t.device
    half = cfg.history_num
    offs = torch.arange(-half, half + 1, device=dev)
    last = torch.clamp(kf.count.long() - 1, min=0)
    raw = center + offs
    idxs = torch.minimum(torch.clamp(raw, min=0), last)
    in_range = (raw >= 0) & (raw < kf.count)
    in_range = in_range & (at(kf.time, last) - kf.time[idxs]
                           > cfg.min_time_gap)
    poses = Pose(kf.R[idxs], kf.t[idxs])
    cpts = se3.transform_points(poses, kf.corner[idxs])
    spts = se3.transform_points(poses, kf.surf[idxs])
    pts = torch.cat([cpts, spts], dim=1).reshape(-1, 3)
    val = torch.cat([kf.corner_valid[idxs] & in_range[:, None],
                     kf.surf_valid[idxs] & in_range[:, None]],
                    dim=1).reshape(-1)
    return voxel_representative(pts, val, cfg.submap_leaf, cfg.hist_cap)


def close_and_correct(kf: KeyframeStore, loops: LoopFactors,
                      cfg: LoopClosureConfig, pg_cfg: PoseGraphConfig):
    """One attempt and, on acceptance, the re-solve and the corrected
    store.  Returns (store, factors, the corrected latest pose, diag)."""
    dev = kf.t.device
    cur = torch.clamp(kf.count.long() - 1, min=0)
    cand = detect(kf, cfg)
    has_cand = (cand >= 0) & (kf.count >= 2)
    cur_pts, cur_val = _world_cloud(kf, cur)
    hist_pts, hist_val = _history_cloud(
        kf, torch.clamp(cand, min=0).long(), cfg)
    res = icp_ops.icp(cur_pts, cur_val & has_cand, hist_pts,
                      hist_val & has_cand, Pose.identity(device=dev),
                      max_corr_dist=cfg.icp_max_corr_dist,
                      max_iters=cfg.icp_max_iters, eps=cfg.icp_eps,
                      frozen=~has_cand)
    # PCL-compatible acceptance (mapOptmization.cpp:904) and the factor
    # poseFrom.between(poseTo) (mapOptmization.cpp:919-939).
    accept = has_cand & res.has_converged & (res.fitness < cfg.fitness_thresh)
    c = torch.clamp(cand, min=0).long()
    T_cor = se3.compose(res.pose, Pose(at(kf.R, cur), at(kf.t, cur)))
    Z = se3.relative(T_cor, Pose(at(kf.R, c), at(kf.t, c)))
    new = posegraph.add_loop_factor(loops, cur, c, Z, res.fitness)
    loops = LoopFactors(*(torch.where(accept, a, b)
                          for a, b in zip(new, loops)))
    R, t = kf.R, kf.t
    if bool(accept):
        R, t = posegraph.optimize(R, t, kf.count, kf.chain_R, kf.chain_t,
                                  loops, Pose(kf.R[0], kf.t[0]), pg_cfg)
        kf = kf._replace(R=R, t=t)
    return (kf, loops, Pose(at(R, cur), at(t, cur)),
            LoopDiag(candidate=cand, fitness=res.fitness, closed=accept))
