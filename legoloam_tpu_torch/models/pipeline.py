"""Per-scan pipeline assembly (port of ``legoloam_tpu/models/pipeline.py``):
projection -> segmentation -> features (with IMU de-skew when an IMU
integral is given) -> two-step LM odometry -> every ``mapping_every`` scans
the scan-to-map step -> loop closure when due -> fusion, plus the
keyframe-store saturation guard and the block drivers.

The mapping half of a step (the scan-to-map step, loop closure, the
saturation guard) runs through a ``Backend``: the single device's by
default, or a mesh's (``parallel.pipeline_dist.MeshBackend``), so the
drivers below are also the distributed drivers.

The JAX package's block drivers fuse B scans into one XLA program to save
dispatches; here they are loops over the streaming step, so their outputs
equal the streaming driver's and their API is kept for parity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import PipelineConfig
from ..device import resolve_device
from ..ops import deskew as deskew_ops
from ..ops import features as feat_ops
from ..ops import projection, se3, segmentation
from ..ops.features import ScanFeatures
from ..ops.se3 import Pose
from . import fusion as fusion_mod
from . import loopclosure as loop_mod
from . import mapping as mapping_mod
from . import odometry as odom
from . import posegraph as pg_mod
from . import relocalize as reloc_mod
from .odometry import OdometryDiag, OdometryState


def process_scan(points, valid, ring, cfg: PipelineConfig,
                 imu_integral: Optional[deskew_ops.ImuIntegral] = None,
                 scan_start_time=0.0) -> ScanFeatures:
    """Frontend: raw scan -> features (imageProjection + the feature half of
    featureAssociation), de-skewed by ``imu_integral`` when given."""
    img = projection.project_scan(points, valid, cfg.sensor, ring=ring)
    if not cfg.deskew:
        # Rigid clouds: every point sits at the scan-end frame (rel_time 1).
        img = img._replace(rel_time=torch.ones_like(img.rel_time))
    seg = segmentation.segment(img, cfg.sensor, cfg.seg)
    xyz = None
    if imu_integral is not None:
        xyz = deskew_ops.deskew_image(
            img.xyz, img.rel_time, img.valid, scan_start_time, imu_integral,
            scan_period=cfg.sensor.scan_period).xyz
    return feat_ops.extract_features(img, seg, cfg.sensor, cfg.feat,
                                     xyz_deskewed=xyz)


def process_scan_with_imu(points, valid, ring, cfg: PipelineConfig,
                          imu_integral: deskew_ops.ImuIntegral,
                          scan_start_time):
    """Frontend + de-skew, also returning the de-skew result that seeds the
    odometry (updateInitialGuess, featureAssociation.cpp:1639-1664) and the
    mapping attitude blend: (features, DeskewResult)."""
    img = projection.project_scan(points, valid, cfg.sensor, ring=ring)
    seg = segmentation.segment(img, cfg.sensor, cfg.seg)
    dsk = deskew_ops.deskew_image(
        img.xyz, img.rel_time, img.valid, scan_start_time, imu_integral,
        scan_period=cfg.sensor.scan_period)
    feats = feat_ops.extract_features(img, seg, cfg.sensor, cfg.feat,
                                      xyz_deskewed=dsk.xyz)
    return feats, dsk


def imu_xi_seed(dsk: deskew_ops.DeskewResult, scan_period: float):
    """Initial-guess twist from the IMU: rotation = the gyro's integral over
    the scan, translation = the scan-start velocity (sensor frame) times the
    scan period."""
    R_s = se3.euler_zyx_to_mat(dsk.rpy_start[0], dsk.rpy_start[1],
                               dsk.rpy_start[2])
    return torch.cat([dsk.ang_delta,
                      se3.rotate_vec(R_s.T, dsk.velo_start) * scan_period])


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


def _stack(outs):
    """A list of equal NamedTuple trees -> one tree with a leading axis."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    return type(first)(*(_stack(list(xs)) for xs in zip(*outs)))


def odometry_scan_block(state: OdometryState, points, valid, ring,
                        cfg: PipelineConfig
                        ) -> Tuple[OdometryState, OdometryOutput]:
    """B scans ((B, P, 3), (B, P), (B, P)) in order: B calls of
    ``odometry_scan_step``, outputs stacked on a leading axis."""
    outs = []
    for j in range(points.shape[0]):
        state, out = odometry_scan_step(state, points[j], valid[j], ring[j],
                                        cfg)
        outs.append(out)
    return state, _stack(outs)


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


def _on(tree, dev):
    """Every tensor of a NamedTuple tree on ``dev``."""
    if isinstance(tree, tuple):
        return type(tree)(*(_on(v, dev) for v in tree))
    return torch.as_tensor(tree, device=dev)


class Backend:
    """Where the mapping half of a SLAM step runs: on one device (this
    class) or over the ranks of a mesh
    (``parallel.pipeline_dist.MeshBackend``).  The frontend, odometry and
    fusion are the same for both."""

    map_hooks = mapping_mod.LOCAL

    def init_state(self, cfg: PipelineConfig, device=None):
        """The empty state."""
        return init_slam_state(cfg, device)

    def from_single(self, state: SlamState):
        """A single-device state (e.g. a loaded checkpoint) as this
        backend's."""
        return state

    def snapshot(self, state, cfg: PipelineConfig):
        """The single-device state that checkpoints and maps are written
        from; None where this process writes nothing."""
        return state

    def close_loop(self, map_state, loops, cfg: PipelineConfig):
        """One loop-closure attempt: (map state, loop factors)."""
        kf, loops, corrected, ldiag = loop_mod.close_and_correct(
            map_state.kf, loops, cfg.loop, cfg.posegraph)
        if bool(ldiag.closed):
            # correctPoses: adopt the corrected store and re-anchor the
            # mapping correction at the corrected latest pose
            # (mapOptmization.cpp:1429-1478); the submap cache no longer
            # matches the moved keyframes.
            map_state = map_state._replace(
                kf=kf, t_aft=corrected, cache=map_state.cache._replace(
                    stale=torch.ones_like(map_state.cache.stale)))
        return map_state, loops

    def maybe_decimate(self, state, cfg: PipelineConfig, margin: int = 16):
        return maybe_decimate(state, cfg, margin)

    def relocalize(self, state, cfg: PipelineConfig):
        """``relocalize.relocalize_slam_state``: (state, diag)."""
        return reloc_mod.relocalize_slam_state(state, cfg)


SINGLE = Backend()


def slam_scan_step(state: SlamState, points, valid, ring,
                   cfg: PipelineConfig, scan_time, run_mapping: bool,
                   run_loop: bool = False,
                   imu_integral: Optional[deskew_ops.ImuIntegral] = None,
                   bootstrap: bool = False, backend: Backend = SINGLE):
    """One full SLAM step on the state's device.  ``bootstrap`` (pass it on
    scan index 1): re-seed and re-solve the odometry twice before the final
    solve, as the JAX package does.  With ``imu_integral``: de-skew, the
    gyro's rotation as the odometry seed (translation keeps the
    constant-velocity prior) and blend, and the mapping attitude blend.
    ``run_loop`` with ``cfg.loop.enabled``: one loop-closure attempt after
    mapping.  The keyframe store is updated in place, except that a closed
    loop replaces its poses.  ``backend``: where mapping and loop closure
    run (a mesh's, with its state)."""
    dev = state.odom.xi.device
    points, valid, ring = (torch.as_tensor(a, device=dev)
                           for a in (points, valid, ring))
    imu_rot = imu_rpy_end = None
    if imu_integral is not None:
        imu_integral = _on(imu_integral, dev)
        feats, dsk = process_scan_with_imu(points, valid, ring, cfg,
                                           imu_integral, scan_time)
        seed = imu_xi_seed(dsk, cfg.sensor.scan_period)
        xi_seed = torch.cat([seed[:3], state.odom.xi[3:]])
        imu_rot = dsk.ang_delta
        imu_rpy_end = dsk.rpy_start + dsk.ang_delta
    else:
        feats = process_scan(points, valid, ring, cfg)
        xi_seed = state.odom.xi
    if bootstrap:
        for _ in range(2):
            ns, _, _ = odom.odometry_step(state.odom, feats, cfg.odom,
                                          xi_seed=xi_seed, imu_rot=imu_rot)
            xi_seed = ns.xi
    odom_state, pose, diag = odom.odometry_step(
        state.odom, feats, cfg.odom, xi_seed=xi_seed, imu_rot=imu_rot)

    map_state, loops = state.mapping, state.loops
    if run_mapping:
        map_state, _, _ = mapping_mod.mapping_step(
            map_state, odom_state.last_corner, odom_state.last_surf,
            odom_state.last_outlier, pose, scan_time, cfg.mapping,
            imu_rpy=imu_rpy_end, ground_cloud=odom_state.last_flat,
            hooks=backend.map_hooks)
    if run_loop and cfg.loop.enabled:
        map_state, loops = backend.close_loop(map_state, loops, cfg)
    fused = fusion_mod.fuse(pose, map_state.t_bef, map_state.t_aft)
    return (state._replace(odom=odom_state, mapping=map_state, loops=loops),
            SlamOutput(odom_pose=pose, mapped_pose=map_state.t_aft,
                       fused_pose=fused, diag=diag))


def slam_scan_block(state: SlamState, points, valid, ring,
                    cfg: PipelineConfig, scan_times, run_loop: bool = False,
                    imu_integrals: Optional[deskew_ops.ImuIntegral] = None,
                    bootstrap: bool = False, backend: Backend = SINGLE):
    """B consecutive scans ((B, P, 3), (B, P), (B, P), times (B,)): the
    scan-to-map step (and, with ``run_loop``, a loop-closure attempt) on the
    block's first scan, odometry and fusion on every scan — B calls of
    ``slam_scan_step``, outputs stacked on a leading axis.
    ``imu_integrals``: each field stacked on a leading B axis.
    ``bootstrap`` (the first block of a run) applies the scan-1
    double-resolve, so it needs B >= 2."""
    n = points.shape[0]
    if bootstrap and n < 2:
        raise ValueError(
            "slam_scan_block(bootstrap=True) needs a block of >= 2 scans (the "
            "double-resolve applies to scan index 1; use the streaming "
            "driver)")
    outs = []
    for j in range(n):
        integ = None if imu_integrals is None else type(imu_integrals)(
            *(a[j] for a in imu_integrals))
        state, out = slam_scan_step(
            state, points[j], valid[j], ring[j], cfg, scan_times[j],
            run_mapping=(j == 0), run_loop=(run_loop and j == 0),
            imu_integral=integ, bootstrap=(bootstrap and j == 1),
            backend=backend)
        outs.append(out)
    return state, _stack(outs)


def maybe_decimate(state: SlamState, cfg: PipelineConfig, margin: int = 16):
    """Keyframe-store saturation guard: when ``count`` is within ``margin``
    of ``max_keyframes``, decimate the store (``decimate_keyframes``) and
    mark the submap cache stale.  Reads ``count`` back, so drivers call it
    at a cadence; ``margin`` covers the keyframes that can accrete between
    calls.  Returns ``(state, decimated)``."""
    if int(state.mapping.kf.count) < cfg.mapping.max_keyframes - margin:
        return state, False
    kf, loops = mapping_mod.decimate_keyframes(
        state.mapping.kf, state.loops,
        keep_recent=cfg.mapping.decimate_keep_recent)
    mp = state.mapping
    cache = mp.cache._replace(stale=torch.ones_like(mp.cache.stale))
    return state._replace(mapping=mp._replace(kf=kf, cache=cache),
                          loops=loops), True


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


def run_slam_sequence(scans, cfg: PipelineConfig, times=None, device=None,
                      imu_integrals=None, backend: Backend = SINGLE):
    """Host loop of the full pipeline over ``(points, valid, ring)``
    triples: the scan-1 bootstrap, per-scan IMU integrals (a sequence, one
    per scan, or None), the loop-closure cadence on data time and the
    saturation guard every 32 scans.  Returns (fused trajectory Pose
    (K, ...), final state)."""
    state = backend.init_state(cfg, device)
    sched = LoopScheduler(cfg)
    fused_R, fused_t = [], []
    for k, (pts, valid, ring) in enumerate(scans):
        t = float(k) * cfg.sensor.scan_period if times is None else times[k]
        state, out = slam_scan_step(
            state, pts, valid, ring, cfg, t,
            run_mapping=(k % cfg.mapping_every == 0),
            run_loop=sched.due(t),
            imu_integral=None if imu_integrals is None else imu_integrals[k],
            bootstrap=(k == 1), backend=backend)
        fused_R.append(out.fused_pose.R)
        fused_t.append(out.fused_pose.t)
        if k % 32 == 31:
            state, _ = backend.maybe_decimate(state, cfg)
    return Pose(torch.stack(fused_R), torch.stack(fused_t)), state


def run_odometry_sequence(scans, cfg: PipelineConfig, device=None):
    """Odometry alone over ``(points, valid, ring)`` triples on ``device``
    (default: the CUDA device): (stacked world poses, per-scan diags)."""
    dev = resolve_device(device)
    state = odom.init_state(cfg.odom, cfg.feat, dev)
    poses_R, poses_t, diags = [], [], []
    for pts, valid, ring in scans:
        state, out = odometry_scan_step(
            state, *(torch.as_tensor(a, device=dev)
                     for a in (pts, valid, ring)), cfg)
        poses_R.append(out.pose.R)
        poses_t.append(out.pose.t)
        diags.append(out.diag)
    return Pose(torch.stack(poses_R), torch.stack(poses_t)), diags
