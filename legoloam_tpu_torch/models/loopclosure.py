"""ICP loop closure (port of ``legoloam_tpu/models/loopclosure.py``; the
reference's ``loopClosureThread`` / ``performLoopClosure`` /
``correctPoses``, ``src/mapOptmization.cpp:802-945,1456-1478``).

One attempt: detect the nearest keyframe within ``search_radius`` that is
older than ``min_time_gap``; align the latest keyframe's corner + surf cloud
onto a ±``history_num``-keyframe submap around it (ICP on kernel K3); on
acceptance add a between-factor with the ICP fitness as its variance,
re-solve the pose graph and rewrite every keyframe pose.  The JAX package's
``lax.cond`` branches become host branches: one read when no candidate
exists (the JAX program then runs an ICP on empty clouds, with the same
diagnostics), one read of the acceptance.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..config import LoopClosureConfig, PoseGraphConfig
from ..ops import icp as icp_ops
from ..ops import se3
from ..ops.se3 import Pose
from ..ops.voxel import voxel_representative
from . import posegraph
from .mapping import KeyframeStore
from .posegraph import LoopFactors


class LoopDiag(NamedTuple):
    candidate: torch.Tensor   # () int32, -1 if none
    fitness: torch.Tensor
    closed: torch.Tensor      # () bool


def detect(kf: KeyframeStore, cfg: LoopClosureConfig) -> torch.Tensor:
    """Index of the closure candidate for the latest keyframe, or -1 (the
    first minimum on ties, as ``jnp.argmin``)."""
    m = kf.t.shape[0]
    cur = kf.count.long() - 1
    ok = (torch.arange(m, device=kf.t.device) < kf.count) \
        & (kf.time[cur] - kf.time > cfg.min_time_gap)
    d2 = torch.sum((kf.t - kf.t[cur][None]) ** 2, dim=-1)
    d2 = torch.where(ok, d2, torch.full_like(d2, math.inf))
    best = torch.argmin(d2)
    found = d2[best] < cfg.search_radius ** 2
    return torch.where(found, best, -1).to(torch.int32)


def _world_cloud(kf: KeyframeStore, idx, corner=True, surf=True):
    """One keyframe's stored scan in world coordinates."""
    pose = Pose(kf.R[idx], kf.t[idx])
    parts, vals = [], []
    if corner:
        parts.append(se3.transform_points(pose, kf.corner[idx]))
        vals.append(kf.corner_valid[idx])
    if surf:
        parts.append(se3.transform_points(pose, kf.surf[idx]))
        vals.append(kf.surf_valid[idx])
    return torch.cat(parts, dim=0), torch.cat(vals, dim=0)


def window_cloud(kf: KeyframeStore, center, half: int, leaf: float,
                 cap: int, min_time_gap: float | None = None):
    """The keyframes ``center - half .. center + half`` in world
    coordinates, representative-deduped to ``cap`` points.  With
    ``min_time_gap``, keyframes within that many seconds of the latest one
    are left out, so a drifted current pass cannot leak into the submap."""
    dev = kf.t.device
    offs = torch.arange(-half, half + 1, device=dev)
    last = torch.clamp(kf.count.long() - 1, min=0)
    raw = center + offs
    idxs = torch.minimum(torch.clamp(raw, min=0), last)
    in_range = (raw >= 0) & (raw < kf.count)
    if min_time_gap is not None:
        in_range = in_range & (kf.time[last] - kf.time[idxs] > min_time_gap)
    poses = Pose(kf.R[idxs], kf.t[idxs])
    cpts = se3.transform_points(poses, kf.corner[idxs])
    spts = se3.transform_points(poses, kf.surf[idxs])
    pts = torch.cat([cpts, spts], dim=1).reshape(-1, 3)
    val = torch.cat([kf.corner_valid[idxs] & in_range[:, None],
                     kf.surf_valid[idxs] & in_range[:, None]],
                    dim=1).reshape(-1)
    return voxel_representative(pts, val, leaf, cap)


def _history_cloud(kf: KeyframeStore, center, cfg: LoopClosureConfig):
    """±history_num-keyframe submap around ``center`` without the current
    pass, 0.4 m representative-deduped (historyKeyframeSearchNum=25,
    utility.h:133)."""
    return window_cloud(kf, center, cfg.history_num, cfg.submap_leaf,
                        cfg.hist_cap, min_time_gap=cfg.min_time_gap)


def close_and_correct(kf: KeyframeStore, loops: LoopFactors,
                      cfg: LoopClosureConfig, pg_cfg: PoseGraphConfig
                      ) -> Tuple[KeyframeStore, LoopFactors, Pose, LoopDiag]:
    """One loop-closure attempt and, on acceptance, the full pose-graph
    re-solve and keyframe correction.  Returns the (possibly corrected)
    store, the factors, the corrected latest pose and diagnostics.  A
    corrected store is a new store; ``kf`` is not written."""
    dev = kf.t.device
    cur = max(int(kf.count) - 1, 0)
    cand = detect(kf, cfg)
    c = int(cand)
    if c < 0 or cur < 1:
        diag = LoopDiag(candidate=cand,
                        fitness=torch.zeros((), device=dev),
                        closed=torch.tensor(False, device=dev))
        return kf, loops, Pose(kf.R[cur], kf.t[cur]), diag

    cur_pts, cur_val = _world_cloud(kf, cur)
    hist_pts, hist_val = _history_cloud(kf, torch.tensor(c, device=dev),
                                        cfg)
    res = icp_ops.icp(cur_pts, cur_val, hist_pts, hist_val,
                      Pose.identity(device=dev),
                      max_corr_dist=cfg.icp_max_corr_dist,
                      max_iters=cfg.icp_max_iters, eps=cfg.icp_eps)
    # PCL-compatible acceptance (mapOptmization.cpp:904): any termination,
    # the iteration cap included, gated on the fitness.
    accept = res.has_converged & (res.fitness < cfg.fitness_thresh)
    diag = LoopDiag(candidate=cand, fitness=res.fitness, closed=accept)
    if not bool(accept):
        return kf, loops, Pose(kf.R[cur], kf.t[cur]), diag

    # Factor Z = T_cor⁻¹ ∘ T_old (poseFrom.between(poseTo),
    # mapOptmization.cpp:919-939).
    T_cor = se3.compose(res.pose, Pose(kf.R[cur], kf.t[cur]))
    Z = se3.relative(T_cor, Pose(kf.R[c], kf.t[c]))
    loops = posegraph.add_loop_factor(loops, cur, c, Z, res.fitness)
    R_out, t_out = posegraph.optimize(
        kf.R, kf.t, kf.count, kf.chain_R, kf.chain_t, loops,
        Pose(kf.R[0], kf.t[0]), pg_cfg)
    kf = kf._replace(R=R_out, t=t_out)
    return kf, loops, Pose(kf.R[cur], kf.t[cur]), diag
