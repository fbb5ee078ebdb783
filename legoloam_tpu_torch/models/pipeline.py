"""Per-scan pipeline assembly (port of ``legoloam_tpu/models/pipeline.py``):
projection -> segmentation -> features (with IMU de-skew when an IMU
integral is given) -> two-step LM odometry -> every ``mapping_every`` scans
the scan-to-map step -> loop closure when due -> fusion, plus the
keyframe-store saturation guard and the block drivers.

The mapping half of a step (the scan-to-map step, loop closure, the
saturation guard) runs through a ``Backend``: the single device's by
default, or a mesh's (``parallel.pipeline_dist.MeshBackend``), so the
drivers below are also the distributed drivers.

``step_body`` is the step's one copy: straight-line segments with a host
read between two only where a decision picks what runs next (the submap
branch, a loop attempt's chunk loops; ``ops/segments.py``), and
``odometry_body`` the odometry's, one segment.

The functional drivers (``slam_scan_step``, ``slam_scan_block``,
``odometry_scan_step``, ``odometry_scan_block``) run their body eagerly on
the state's device and keep nothing between calls: a state goes in and a
new state comes out.  What replays on the card is a program that its
caller owns, ``step_graph.StepGraph`` or ``step_graph.OdometryGraph``
(on the card with a capturable backend the segments between two reads
are one captured CUDA graph, as the JAX package runs the step as one
compiled program); ``run_slam_sequence`` and ``run_odometry_sequence``
each drive one.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import PipelineConfig
from ..device import resolve_device
from ..ops import deskew as deskew_ops
from ..ops import features as feat_ops
from ..ops import projection, se3, segmentation
from ..ops.features import ScanFeatures
from ..ops.se3 import Pose
from ..ops.segments import EAGER, Eager
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
    featureAssociation), de-skewed by ``imu_integral`` when given.  The ops
    take a leading batch axis as they come; a batch of scans goes through
    ``process_scans``, the one batched entry."""
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


def process_scans(points, valid, ring, cfg: PipelineConfig) -> ScanFeatures:
    """The frontend of B scans at once: points (B, P, 3), valid (B, P),
    ring (B, P) -> ``ScanFeatures`` with a leading (B,) on every field, each
    scan's equal to its own ``process_scan`` (no IMU), as the JAX package
    vmaps ``process_scan``.  One launch of K1 and one of K2 a call;
    ``step_graph.FrontendGraph`` runs it as one captured graph."""
    if points.dim() != 3:
        raise ValueError(f"process_scans takes (B, P, 3) points, got "
                         f"{tuple(points.shape)}")
    return process_scan(points, valid, ring, cfg)


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


def _odometry(state: OdometryState, points, valid, ring,
              cfg: PipelineConfig):
    feats = process_scan(points, valid, ring, cfg)
    new_state, pose, diag = odom.odometry_step(state, feats, cfg.odom)
    return new_state, OdometryOutput(pose=pose, diag=diag)


def odometry_body(state: OdometryState, points, valid, ring,
                  cfg: PipelineConfig, rt=EAGER):
    """Frontend + odometry for one scan on device tensors, as one segment
    through ``rt`` (no host read): the body of ``odometry_scan_step``,
    ``odometry_scan_block`` and ``step_graph.OdometryGraph``."""
    return rt.seg(("odometry",), partial(_odometry, cfg=cfg), state, points,
                  valid, ring, into=(state, None))


def odometry_scan_step(state: OdometryState, points, valid, ring,
                       cfg: PipelineConfig
                       ) -> Tuple[OdometryState, OdometryOutput]:
    """Frontend + odometry for one scan: ``odometry_body`` on the state's
    device, eagerly.  The state given is not written."""
    dev = state.xi.device
    return odometry_body(state, *(torch.as_tensor(a, device=dev)
                                  for a in (points, valid, ring)), cfg)


def _stack(outs):
    """A list of equal NamedTuple trees -> one tree with a leading axis."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    return type(first)(*(_stack(list(xs)) for xs in zip(*outs)))


def odometry_scan_block(state: OdometryState, points, valid, ring,
                        cfg: PipelineConfig
                        ) -> Tuple[OdometryState, OdometryOutput]:
    """B scans ((B, P, 3), (B, P), (B, P)) in order, outputs stacked on a
    leading axis: B calls of ``odometry_scan_step``.  The state given is
    not written."""
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


def _adopt(mp: mapping_mod.MapState, kf, corrected: Pose, closed):
    """correctPoses (mapOptmization.cpp:1429-1478): on a closed loop, the
    corrected store, the mapping correction re-anchored at the corrected
    latest pose, and the submap cache marked stale (its keyframes moved);
    else the state as it was."""
    return mp._replace(
        kf=kf._replace(R=torch.where(closed, kf.R, mp.kf.R),
                       t=torch.where(closed, kf.t, mp.kf.t)),
        t_aft=se3.where_pose(closed, corrected, mp.t_aft),
        cache=mp.cache._replace(stale=mp.cache.stale | closed))


class Backend:
    """Where the mapping half of a SLAM step runs: on one device (this
    class) or over the ranks of a mesh
    (``parallel.pipeline_dist.MeshBackend``).  The frontend, odometry and
    fusion are the same for both.  ``capturable``: the step can run as CUDA
    graphs (a mesh's on NCCL only: gloo's collectives cannot be
    captured)."""

    map_hooks = mapping_mod.LOCAL
    capturable = True

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

    def close_loop(self, map_state, loops, cfg: PipelineConfig, rt=EAGER):
        """One loop-closure attempt: (map state, loop factors)."""
        kf, loops, corrected, ldiag = loop_mod.close_and_correct(
            map_state.kf, loops, cfg.loop, cfg.posegraph, rt=rt)
        map_state = rt.seg(("loop", "adopt"), _adopt, map_state, kf,
                           corrected, ldiag.closed, into=map_state)
        return map_state, loops

    def maybe_decimate(self, state, cfg: PipelineConfig, margin: int = 16):
        return maybe_decimate(state, cfg, margin)

    def relocalize(self, state, cfg: PipelineConfig):
        """``relocalize.relocalize_slam_state``: (state, diag)."""
        return reloc_mod.relocalize_slam_state(state, cfg)


SINGLE = Backend()


class _Front(NamedTuple):
    """A step's first segment: the new odometry state, its diagnostics,
    and for a mapping step the mapping's first part and the IMU attitude
    at scan end."""

    odom: OdometryState
    diag: OdometryDiag
    prep: Optional[mapping_mod.MapPrep]
    imu_rpy: Optional[torch.Tensor]


def _front(state: SlamState, points, valid, ring, scan_time, imu_integral,
           cfg: PipelineConfig, run_mapping: bool, bootstrap: bool,
           hooks: mapping_mod.MapHooks) -> _Front:
    """Frontend, odometry (re-solved twice first under ``bootstrap``) and,
    for a mapping step, ``mapping.mapping_prepare``."""
    imu_rot = imu_rpy_end = None
    if imu_integral is not None:
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
    prep = None
    if run_mapping:
        prep = mapping_mod.mapping_prepare(
            state.mapping, odom_state.last_corner, odom_state.last_surf,
            odom_state.last_outlier, pose, cfg.mapping, hooks)
    return _Front(odom=odom_state, diag=diag, prep=prep, imu_rpy=imu_rpy_end)


def _map(mp: mapping_mod.MapState, front: _Front, submap,
         odom_state: OdometryState, scan_time, cfg: PipelineConfig,
         hooks: mapping_mod.MapHooks):
    """``mapping.mapping_finish``: the new map state."""
    return mapping_mod.mapping_finish(
        mp, front.prep, submap, odom_state.pose, scan_time, cfg.mapping,
        imu_rpy=front.imu_rpy, ground_cloud=odom_state.last_flat,
        hooks=hooks)[0]


def step_body(state: SlamState, points, valid, ring, scan_time,
              cfg: PipelineConfig, run_mapping: bool, run_loop: bool = False,
              imu_integral: Optional[deskew_ops.ImuIntegral] = None,
              bootstrap: bool = False, backend: Backend = SINGLE, rt=EAGER):
    """One SLAM step on device tensors (``scan_time`` a () tensor): its
    segments through ``rt``, whose reads are the only host reads — the
    submap branch on a mapping step, and a loop attempt's."""
    V = (run_mapping, run_loop, bootstrap, imu_integral is not None)
    hooks = backend.map_hooks
    f = rt.seg(("front",) + V,
               partial(_front, cfg=cfg, run_mapping=run_mapping,
                       bootstrap=bootstrap, hooks=hooks),
               state, points, valid, ring, scan_time, imu_integral,
               into=_Front(state.odom, None, None, None))
    state = state._replace(odom=f.odom)
    if run_mapping:
        branch = None if f.prep.branch is None \
            else rt.read(f.prep.branch, "submap branch")
        mp, submap = rt.seg(("submap", branch) + V,
                            partial(mapping_mod.submap_update,
                                    cfg=cfg.mapping, branch=branch,
                                    hooks=hooks),
                            state.mapping, f.prep, into=(state.mapping, None))
        mp = rt.seg(("mapping", branch) + V,
                    partial(_map, cfg=cfg, hooks=hooks),
                    mp, f, submap, state.odom, scan_time, into=state.mapping)
        state = state._replace(mapping=mp)
    if run_loop and cfg.loop.enabled:
        mp, loops = backend.close_loop(state.mapping, state.loops, cfg, rt=rt)
        state = state._replace(mapping=mp, loops=loops)
    fused = rt.seg(("fuse",), fusion_mod.fuse, state.odom.pose,
                   state.mapping.t_bef, state.mapping.t_aft)
    return state, SlamOutput(odom_pose=state.odom.pose,
                             mapped_pose=state.mapping.t_aft,
                             fused_pose=fused, diag=f.diag)


def _step_inputs(dev, points, valid, ring, scan_time, imu_integral):
    """A step's inputs as tensors on ``dev``: (points, valid, ring,
    ``scan_time`` as a () float32 tensor, ``imu_integral``)."""
    points, valid, ring = (torch.as_tensor(a, device=dev)
                           for a in (points, valid, ring))
    scan_time = torch.as_tensor(scan_time, dtype=torch.float32, device=dev)
    if imu_integral is not None:
        imu_integral = _on(imu_integral, dev)
    return points, valid, ring, scan_time, imu_integral


def slam_scan_step(state: SlamState, points, valid, ring,
                   cfg: PipelineConfig, scan_time, run_mapping: bool,
                   run_loop: bool = False,
                   imu_integral: Optional[deskew_ops.ImuIntegral] = None,
                   bootstrap: bool = False, backend: Backend = SINGLE):
    """One full SLAM step on the state's device, run eagerly (the
    functional step; the drivers run the same body through
    ``step_graph.StepGraph``), its decisions read through the backend's
    ``map_hooks.read``.  ``bootstrap`` (pass it on scan index 1):
    re-seed and re-solve the odometry twice before the final solve, as the
    JAX package does.  With ``imu_integral``: de-skew, the gyro's rotation
    as the odometry seed (translation keeps the constant-velocity prior)
    and blend, and the mapping attitude blend.  ``run_loop`` with
    ``cfg.loop.enabled``: one loop-closure attempt after mapping.  The
    keyframe store is updated in place, except that a closed loop replaces
    its poses.  ``backend``: where mapping and loop closure run (a mesh's,
    with its state)."""
    points, valid, ring, scan_time, imu_integral = _step_inputs(
        state.odom.xi.device, points, valid, ring, scan_time, imu_integral)
    return step_body(state, points, valid, ring, scan_time, cfg, run_mapping,
                     run_loop, imu_integral, bootstrap, backend,
                     Eager(backend.map_hooks.read))


def slam_scan_block(state: SlamState, points, valid, ring,
                    cfg: PipelineConfig, scan_times, run_loop: bool = False,
                    imu_integrals: Optional[deskew_ops.ImuIntegral] = None,
                    bootstrap: bool = False, backend: Backend = SINGLE):
    """B consecutive scans ((B, P, 3), (B, P), (B, P), times (B,)): the
    scan-to-map step (and, with ``run_loop``, a loop-closure attempt) on the
    block's first scan, odometry and fusion on every scan — B step bodies
    run eagerly through ``StepGraph.block``, outputs stacked on a leading
    axis.  The state is written as ``slam_scan_step`` writes it.
    ``imu_integrals``: each field stacked on a leading B axis.
    ``bootstrap`` (the first block of a run) applies the scan-1
    double-resolve, so it needs B >= 2."""
    if bootstrap and points.shape[0] < 2:
        raise ValueError(
            "slam_scan_block(bootstrap=True) needs a block of >= 2 scans (the "
            "double-resolve applies to scan index 1; use the streaming "
            "driver)")
    from .step_graph import StepGraph
    sg = StepGraph(state, cfg, backend, graph=False)
    outs = sg.block(points, valid, ring, scan_times, run_loop, imu_integrals,
                    bootstrap)
    return sg.state, outs


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
    saturation guard every 32 scans.  The steps run through one
    ``step_graph.StepGraph`` (CUDA graphs on the card with a capturable
    backend).  Returns (fused trajectory Pose (K, ...), final state)."""
    from .step_graph import StepGraph
    sg = StepGraph(backend.init_state(cfg, device), cfg, backend)
    sched = LoopScheduler(cfg)
    fused_R, fused_t = [], []
    for k, (pts, valid, ring) in enumerate(scans):
        t = float(k) * cfg.sensor.scan_period if times is None else times[k]
        out = sg.step(
            pts, valid, ring, t, run_mapping=(k % cfg.mapping_every == 0),
            run_loop=sched.due(t),
            imu_integral=None if imu_integrals is None else imu_integrals[k],
            bootstrap=(k == 1))
        fused_R.append(out.fused_pose.R)
        fused_t.append(out.fused_pose.t)
        if k % 32 == 31:
            state, decimated = backend.maybe_decimate(sg.state, cfg)
            if decimated:
                sg.load(state)
    return Pose(torch.stack(fused_R), torch.stack(fused_t)), sg.state


def run_odometry_sequence(scans, cfg: PipelineConfig, device=None):
    """Odometry alone over ``(points, valid, ring)`` triples on ``device``
    (default: the CUDA device) through one ``step_graph.OdometryGraph``
    (on the card a scan is one graph replay): (stacked world poses,
    per-scan diags)."""
    from .step_graph import OdometryGraph
    g = OdometryGraph(odom.init_state(cfg.odom, cfg.feat,
                                      resolve_device(device)), cfg)
    poses_R, poses_t, diags = [], [], []
    for pts, valid, ring in scans:
        out = g.step(pts, valid, ring)
        poses_R.append(out.pose.R)
        poses_t.append(out.pose.t)
        diags.append(out.diag)
    return Pose(torch.stack(poses_R), torch.stack(poses_t)), diags
