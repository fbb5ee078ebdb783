"""The per-scan SLAM step with loop closure on, straight-line and eager:
the body of the port's ``pipeline.step_body`` with ``run_loop`` (no IMU, no
bootstrap).  The frontend, odometry, mapping and fusion are ``step.py``'s;
a loop attempt (``loopclosure.py``) runs after mapping and before fusion,
and on a closed loop the store takes the re-solved poses, the mapping
correction is re-anchored at the corrected latest pose and the submap
cache is marked stale (``correctPoses``, mapOptmization.cpp:1429-1478)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import fusion, loopclosure, mapping, odometry, posegraph, se3, step
from .config import PipelineConfig
from .se3 import Pose


class SlamState(NamedTuple):
    odom: odometry.OdometryState
    mapping: mapping.MapState
    loops: posegraph.LoopFactors


def check_config(cfg: PipelineConfig) -> None:
    """With ``loopClosureEnableFlag`` set, LeGO-LOAM's submap is the
    ``search_num`` newest keyframes (mapOptmization.cpp:961-1000), so a
    configuration with ``loop.enabled`` must use ``submap_mode`` "recent".
    With loop closure off this is ``step.py``'s step: no attempt runs."""
    if cfg.loop.enabled and cfg.mapping.submap_mode != "recent":
        raise ValueError("the loop-closure reference step runs loop "
                         "closure on mapping.submap_mode 'recent' only")


def init_slam_state(cfg: PipelineConfig, device) -> SlamState:
    return SlamState(
        odom=odometry.init_state(cfg.odom, cfg.feat, device),
        mapping=mapping.init_state(cfg.mapping, device),
        loops=posegraph.init_loop_factors(cfg.posegraph.max_loop_factors,
                                          device))


def _adopt(mp: mapping.MapState, kf, corrected: Pose, closed):
    """The corrected store, the correction re-anchored and the cache marked
    stale on a closed loop; else the state as it was."""
    return mp._replace(
        kf=kf._replace(R=torch.where(closed, kf.R, mp.kf.R),
                       t=torch.where(closed, kf.t, mp.kf.t)),
        t_aft=se3.where_pose(closed, corrected, mp.t_aft),
        cache=mp.cache._replace(stale=mp.cache.stale | closed))


def slam_step(state: SlamState, points, valid, ring, scan_time,
              cfg: PipelineConfig, run_mapping: bool, run_loop: bool):
    """One SLAM step: ``step.slam_step``, then with ``run_loop`` one loop
    attempt, then fusion on the (possibly corrected) mapping state.
    Returns (state, ``step.StepOut``)."""
    inner, out = step.slam_step(step.SlamState(state.odom, state.mapping),
                                points, valid, ring, scan_time, cfg,
                                run_mapping)
    mp, loops = inner.mapping, state.loops
    if run_loop:
        kf, loops, corrected, diag = loopclosure.close_and_correct(
            mp.kf, loops, cfg.loop, cfg.posegraph)
        mp = _adopt(mp, kf, corrected, diag.closed)
        out = out._replace(mapped_pose=mp.t_aft, fused_pose=fusion.fuse(
            inner.odom.pose, mp.t_bef, mp.t_aft))
    return SlamState(odom=inner.odom, mapping=mp, loops=loops), out
