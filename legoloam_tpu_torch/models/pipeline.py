"""Per-scan pipeline assembly (port of ``legoloam_tpu/models/pipeline.py``):
projection -> segmentation -> features -> two-step LM odometry -> every
``mapping_every`` scans the scan-to-map step -> fusion.

This slice carries the no-IMU path without loop closure or keyframe
decimation; asking for those raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import PipelineConfig
from ..device import resolve_device
from ..ops import features as feat_ops
from ..ops import projection, segmentation
from ..ops.features import ScanFeatures
from ..ops.se3 import Pose
from . import fusion as fusion_mod
from . import mapping as mapping_mod
from . import odometry as odom
from . import posegraph as pg_mod
from .odometry import OdometryDiag, OdometryState

_LATER = "is not ported yet (see ROADMAP.md queue 1: {})"


def process_scan(points, valid, ring, cfg: PipelineConfig,
                 imu_integral=None) -> ScanFeatures:
    """Frontend: raw scan -> features (imageProjection + the feature half of
    featureAssociation)."""
    if imu_integral is not None:
        raise NotImplementedError("the IMU path " + _LATER.format("P9"))
    img = projection.project_scan(points, valid, cfg.sensor, ring=ring)
    if not cfg.deskew:
        # Rigid clouds: every point sits at the scan-end frame (rel_time 1).
        img = img._replace(rel_time=torch.ones_like(img.rel_time))
    seg = segmentation.segment(img, cfg.sensor, cfg.seg)
    return feat_ops.extract_features(img, seg, cfg.sensor, cfg.feat)


class OdometryOutput(NamedTuple):
    pose: Pose
    diag: OdometryDiag


def odometry_scan_step(state: OdometryState, points, valid, ring,
                       cfg: PipelineConfig
                       ) -> Tuple[OdometryState, OdometryOutput]:
    """Frontend + odometry for one scan."""
    feats = process_scan(points, valid, ring, cfg)
    new_state, pose, diag = odom.odometry_step(state, feats, cfg.odom)
    return new_state, OdometryOutput(pose=pose, diag=diag)


class SlamState(NamedTuple):
    odom: OdometryState
    mapping: mapping_mod.MapState
    loops: pg_mod.LoopFactors


class SlamOutput(NamedTuple):
    odom_pose: Pose
    mapped_pose: Pose
    fused_pose: Pose
    diag: OdometryDiag


def init_slam_state(cfg: PipelineConfig, device=None) -> SlamState:
    """Empty SLAM state on ``device`` (default: the CUDA device; raises when
    there is none)."""
    dev = resolve_device(device)
    return SlamState(
        odom=odom.init_state(cfg.odom, cfg.feat, dev),
        mapping=mapping_mod.init_state(cfg.mapping, dev),
        loops=pg_mod.init_loop_factors(cfg.posegraph.max_loop_factors, dev))


def slam_scan_step(state: SlamState, points, valid, ring,
                   cfg: PipelineConfig, scan_time, run_mapping: bool,
                   run_loop: bool = False, imu_integral=None,
                   bootstrap: bool = False):
    """One full SLAM step on the state's device.  ``bootstrap`` (pass it on
    scan index 1): re-seed and re-solve the odometry twice before the final
    solve, as the JAX package does.  The keyframe store is updated in place.
    """
    if imu_integral is not None:
        raise NotImplementedError("the IMU path " + _LATER.format("P9"))
    if run_loop and cfg.loop.enabled:
        raise NotImplementedError("loop closure " + _LATER.format("P11"))
    dev = state.odom.xi.device
    points, valid, ring = (torch.as_tensor(a, device=dev)
                           for a in (points, valid, ring))
    if bootstrap:
        feats = process_scan(points, valid, ring, cfg)
        xi_seed = state.odom.xi
        for _ in range(2):
            ns, _, _ = odom.odometry_step(state.odom, feats, cfg.odom,
                                          xi_seed=xi_seed)
            xi_seed = ns.xi
        odom_state, pose, diag = odom.odometry_step(state.odom, feats,
                                                    cfg.odom, xi_seed=xi_seed)
        out = OdometryOutput(pose=pose, diag=diag)
    else:
        odom_state, out = odometry_scan_step(state.odom, points, valid, ring,
                                             cfg)
    map_state = state.mapping
    if run_mapping:
        map_state, _, _ = mapping_mod.mapping_step(
            map_state, odom_state.last_corner, odom_state.last_surf,
            odom_state.last_outlier, out.pose, scan_time, cfg.mapping,
            ground_cloud=odom_state.last_flat)
    fused = fusion_mod.fuse(out.pose, map_state.t_bef, map_state.t_aft)
    return (SlamState(odom=odom_state, mapping=map_state, loops=state.loops),
            SlamOutput(odom_pose=out.pose, mapped_pose=map_state.t_aft,
                       fused_pose=fused, diag=out.diag))


def maybe_decimate(state: SlamState, cfg: PipelineConfig, margin: int = 16):
    """Keyframe-store saturation guard.  Decimation is not ported yet, so
    this raises once the store comes within ``margin`` of its cap instead of
    letting keyframes overflow silently.  Returns ``(state, False)``."""
    if int(state.mapping.kf.count) >= cfg.mapping.max_keyframes - margin:
        raise NotImplementedError("keyframe decimation "
                                  + _LATER.format("P10"))
    return state, False


class LoopScheduler:
    """Loop-closure attempt cadence on DATA time (one attempt each
    ``cfg.loop.cadence`` seconds of scan timestamps)."""

    def __init__(self, cfg: PipelineConfig):
        self.cadence = cfg.loop.cadence
        self.enabled = cfg.loop.enabled
        self._last: float | None = None

    def due(self, scan_time: float) -> bool:
        if not self.enabled:
            return False
        if self._last is None:
            self._last = scan_time
            return False
        if scan_time - self._last >= self.cadence:
            self._last = scan_time
            return True
        return False


def run_slam_sequence(scans, cfg: PipelineConfig, times=None, device=None):
    """Host loop of the full pipeline over ``(points, valid, ring)``
    triples; returns (fused trajectory Pose (K, ...), final state)."""
    state = init_slam_state(cfg, device)
    sched = LoopScheduler(cfg)
    fused_R, fused_t = [], []
    for k, (pts, valid, ring) in enumerate(scans):
        t = float(k) * cfg.sensor.scan_period if times is None else times[k]
        state, out = slam_scan_step(
            state, pts, valid, ring, cfg, t,
            run_mapping=(k % cfg.mapping_every == 0),
            run_loop=sched.due(t), bootstrap=(k == 1))
        fused_R.append(out.fused_pose.R)
        fused_t.append(out.fused_pose.t)
        if k % 32 == 31:
            state, _ = maybe_decimate(state, cfg)
    return Pose(torch.stack(fused_R), torch.stack(fused_t)), state
