"""ICP loop closure (port of ``legoloam_tpu/models/loopclosure.py``; the
reference's ``loopClosureThread`` / ``performLoopClosure`` /
``correctPoses``, ``src/mapOptmization.cpp:802-945,1456-1478``).

One attempt: detect the nearest keyframe within ``search_radius`` that is
older than ``min_time_gap``; align the latest keyframe's corner + surf cloud
onto a ±``history_num``-keyframe submap around it (ICP on kernel K3); on
acceptance add a between-factor with the ICP fitness as its variance,
re-solve the pose graph and rewrite every keyframe pose.  As in the JAX
package, no candidate masks both clouds and the ICP runs no iteration; the
JAX ``lax.cond`` around the re-solve becomes one host read of the
acceptance, and the ICP and the pose graph's CG read a stop flag once a
chunk of iterations (``ops/segments.py``).  An attempt starts a chain of
its own (``rt.cut()``), and tallies itself, its closure and its ICP
iterations on the runner (``rt.tally``: ``loop_attempts``,
``loops_closed``, ``icp_iters``) once the acceptance is read.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Tuple

import torch

from ..config import LoopClosureConfig, PoseGraphConfig
from ..device import at
from ..ops import icp as icp_ops
from ..ops import se3
from ..ops.se3 import Pose
from ..ops.segments import EAGER
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
        & (at(kf.time, cur) - kf.time > cfg.min_time_gap)
    d2 = torch.sum((kf.t - at(kf.t, cur)[None]) ** 2, dim=-1)
    d2 = torch.where(ok, d2, torch.full_like(d2, math.inf))
    best = torch.argmin(d2)
    found = at(d2, best) < cfg.search_radius ** 2
    return torch.where(found, best, -1).to(torch.int32)


def _world_cloud(kf: KeyframeStore, idx, corner=True, surf=True):
    """One keyframe's stored scan in world coordinates."""
    pose = Pose(at(kf.R, idx), at(kf.t, idx))
    parts, vals = [], []
    if corner:
        parts.append(se3.transform_points(pose, at(kf.corner, idx)))
        vals.append(at(kf.corner_valid, idx))
    if surf:
        parts.append(se3.transform_points(pose, at(kf.surf, idx)))
        vals.append(at(kf.surf_valid, idx))
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
        in_range = in_range & (at(kf.time, last) - kf.time[idxs]
                               > min_time_gap)
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


class _Attempt(NamedTuple):
    """An attempt's inputs: the latest keyframe, the candidate, the two
    clouds (masked when there is no candidate) and the ICP's start."""

    cur: torch.Tensor        # () int64
    cand: torch.Tensor       # () int32, -1 if none
    has_cand: torch.Tensor   # () bool
    no_cand: torch.Tensor    # () bool, the ICP's freeze
    cur_pts: torch.Tensor
    cur_val: torch.Tensor
    hist_pts: torch.Tensor
    hist_val: torch.Tensor
    init: Pose


def _prepare(kf: KeyframeStore, cfg: LoopClosureConfig) -> _Attempt:
    cur = torch.clamp(kf.count.long() - 1, min=0)
    cand = detect(kf, cfg)
    has_cand = (cand >= 0) & (kf.count >= 2)
    cur_pts, cur_val = _world_cloud(kf, cur)
    hist_pts, hist_val = _history_cloud(kf, torch.clamp(cand, min=0).long(),
                                        cfg)
    return _Attempt(cur=cur, cand=cand, has_cand=has_cand, no_cand=~has_cand,
                    cur_pts=cur_pts,
                    cur_val=cur_val & has_cand, hist_pts=hist_pts,
                    hist_val=hist_val & has_cand,
                    init=Pose.identity(device=kf.t.device))


def _accept(kf: KeyframeStore, loops: LoopFactors, a: _Attempt, res,
            cfg: LoopClosureConfig):
    """PCL-compatible acceptance (mapOptmization.cpp:904): any termination,
    the iteration cap included, gated on the fitness; the factor
    Z = T_cor⁻¹ ∘ T_old (poseFrom.between(poseTo), mapOptmization.cpp:
    919-939) appended when accepted.  Returns (accepted, factors)."""
    accept = a.has_cand & res.has_converged \
        & (res.fitness < cfg.fitness_thresh)
    c = torch.clamp(a.cand, min=0).long()
    T_cor = se3.compose(res.pose, Pose(at(kf.R, a.cur), at(kf.t, a.cur)))
    Z = se3.relative(T_cor, Pose(at(kf.R, c), at(kf.t, c)))
    new = posegraph.add_loop_factor(loops, a.cur, c, Z, res.fitness)
    return accept, LoopFactors(*(torch.where(accept, a, b)
                                 for a, b in zip(new, loops)))


def _outcome(R, t, a: _Attempt, accept, fitness):
    """The corrected latest pose and the diagnostics."""
    return (Pose(at(R, a.cur), at(t, a.cur)),
            LoopDiag(candidate=a.cand, fitness=fitness, closed=accept))


def close_and_correct(kf: KeyframeStore, loops: LoopFactors,
                      cfg: LoopClosureConfig, pg_cfg: PoseGraphConfig,
                      rt=EAGER
                      ) -> Tuple[KeyframeStore, LoopFactors, Pose, LoopDiag]:
    """One loop-closure attempt and, on acceptance, the full pose-graph
    re-solve and keyframe correction.  Returns the (possibly corrected)
    store, the factors, the corrected latest pose and diagnostics.  Run
    eagerly, a corrected store is a new store and ``kf`` is not written;
    a graph runner (``rt``) writes the factors and the corrected poses
    into ``loops`` and ``kf`` (they are its static buffers)."""
    # The attempt's chains are its own: the tracer times them apart from
    # the step's frontend and mapping.
    rt.cut()
    a = rt.seg(("loop", "prepare", cfg), partial(_prepare, cfg=cfg), kf)
    res = icp_ops.icp(a.cur_pts, a.cur_val, a.hist_pts, a.hist_val, a.init,
                      max_corr_dist=cfg.icp_max_corr_dist,
                      max_iters=cfg.icp_max_iters, eps=cfg.icp_eps,
                      frozen=a.no_cand, rt=rt, key="loop icp")
    accept, loops = rt.seg(("loop", "accept", cfg),
                           partial(_accept, cfg=cfg), kf, loops, a, res,
                           into=(None, loops))
    R, t = kf.R, kf.t
    closed = rt.read(accept, "loop accepted")
    rt.tally("loop_attempts", 1)
    rt.tally("loops_closed", int(closed))
    rt.tally("icp_iters", res.iters)
    if closed:
        R, t = posegraph.optimize(R, t, kf.count, kf.chain_R, kf.chain_t,
                                  loops, Pose(kf.R[0], kf.t[0]), pg_cfg,
                                  rt=rt)
        kf = kf._replace(R=R, t=t)
    corrected, diag = rt.seg(("loop", "outcome"), _outcome, R, t, a, accept,
                             res.fitness)
    return kf, loops, corrected, diag
