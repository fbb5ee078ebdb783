"""The SLAM loop over the ranks (port of
``legoloam_tpu/parallel/pipeline_dist.py``).

The state splits by memory class:

  * keyframe CLOUDS (``max_keyframes`` x scan-cap points, ~0.5 GB at
    DEFAULT) are sharded cyclically: keyframe k on rank k % n, local slot
    k // n, ``ceil(M / n)`` slots a rank (port-only padding: ``M`` need not
    divide by ``n``);
  * keyframe POSES, times and chain factors, the odometry state and the
    loop factors are replicated: every rank runs the frontend and odometry
    on the same scan, and every decision that guards a collective (the map
    gate, the residual gate, the LM's convergence, the keyframe gate, the
    loop candidate and its acceptance, the CG tolerance) reads replicated
    or all-reduced values, the same on every rank.

Per mapping step: a replicated global keyframe selection, each rank
voxelises the selected keyframes it owns and one all-gather concatenates
the submap (``extract_submap_dist``); the scan-to-map LM splits the scan
rows over the ranks and all-reduces its normal equations
(``mapping_dist.scan_to_map_sharded``); a new keyframe's clouds are written
by their owner only.  The submap is rebuilt every step (no ``SubmapCache``,
as in the JAX package).  Loop closure gathers the ±``history_num`` window's
clouds by a masked all-reduce, runs the ICP (K3) on every rank, and re-solves
the pose graph over the ranks (``posegraph_dist.optimize_sharded``).

As in the JAX package, the mesh path never decimates the keyframe store
and counts no submap voxel overflow.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import LoopClosureConfig, MappingConfig, PipelineConfig, \
    PoseGraphConfig
from ..device import resolve_device
from ..models import loopclosure as loop_mod
from ..models import mapping as mapping_mod
from ..models import odometry as odom
from ..models import pipeline as pipeline_mod
from ..models import posegraph
from ..models import relocalize as reloc_mod
from ..models.mapping import KeyframeStore, dedup_positions
from ..models.posegraph import LoopFactors
from ..ops import deskew as deskew_ops
from ..ops import icp as icp_ops
from ..ops import se3
from ..ops.features import FeatureCloud
from ..ops.se3 import Pose
from ..ops.voxel import voxel_downsample, voxel_representative
from . import mapping_dist, posegraph_dist
from .mapping_dist import _first_k, cyclic_rows, local_slots
from .mesh import Mesh


# The keyframe store's cloud arrays: sharded; every other field replicated.
CLOUD_FIELDS = ("corner", "corner_valid", "surf", "surf_valid")


class DistKeyframes(NamedTuple):
    """Keyframe store split by memory class: pose-sized arrays replicated,
    cloud arrays this rank's cyclic shard."""

    R: torch.Tensor            # (M, 3, 3) replicated
    t: torch.Tensor            # (M, 3)    replicated
    time: torch.Tensor         # (M,)      replicated
    chain_R: torch.Tensor      # (M, 3, 3) replicated
    chain_t: torch.Tensor      # (M, 3)    replicated
    corner: torch.Tensor       # (m_loc, Ck, 3) this rank's slots
    corner_valid: torch.Tensor
    surf: torch.Tensor         # (m_loc, Cs, 3) this rank's slots
    surf_valid: torch.Tensor
    count: torch.Tensor        # () replicated
    overflow: torch.Tensor     # () replicated: warranted keyframes dropped


class DistMapState(NamedTuple):
    kf: DistKeyframes
    t_bef: Pose
    t_aft: Pose
    ground_ref: torch.Tensor
    ground_ref_ok: torch.Tensor
    initialized: torch.Tensor


class DistSlamState(NamedTuple):
    odom: odom.OdometryState
    mapping: DistMapState
    loops: LoopFactors


def init_dist_state(cfg: PipelineConfig, mesh: Mesh) -> DistSlamState:
    """The empty SLAM state of this rank, on ``mesh.device``."""
    dev = resolve_device(mesh.device)
    mc = cfg.mapping
    m = mc.max_keyframes
    m_loc = local_slots(m, mesh.size)
    f = dict(device=dev)
    b = dict(dtype=torch.bool, device=dev)
    eye = torch.eye(3, **f).expand(m, 3, 3)
    kf = DistKeyframes(
        R=eye.clone(), t=torch.zeros((m, 3), **f),
        time=torch.zeros((m,), **f), chain_R=eye.clone(),
        chain_t=torch.zeros((m, 3), **f),
        corner=torch.zeros((m_loc, mc.scan_corner_cap, 3), **f),
        corner_valid=torch.zeros((m_loc, mc.scan_corner_cap), **b),
        surf=torch.zeros((m_loc, mc.scan_surf_cap, 3), **f),
        surf_valid=torch.zeros((m_loc, mc.scan_surf_cap), **b),
        count=torch.tensor(0, dtype=torch.int32, device=dev),
        overflow=torch.tensor(0, dtype=torch.int32, device=dev))
    mstate = DistMapState(
        kf=kf, t_bef=Pose.identity(device=dev),
        t_aft=Pose.identity(device=dev),
        ground_ref=torch.tensor(0.0, **f),
        ground_ref_ok=torch.tensor(False, **b),
        initialized=torch.tensor(False, **b))
    return DistSlamState(
        odom=odom.init_state(cfg.odom, cfg.feat, dev), mapping=mstate,
        loops=posegraph.init_loop_factors(cfg.posegraph.max_loop_factors,
                                          dev))


def from_keyframe_store(kf: KeyframeStore, mesh: Mesh) -> DistKeyframes:
    """A single-device store (e.g. a loaded checkpoint, given on every
    rank) in the sharded layout: poses replicated, this rank's cloud
    slots."""
    return DistKeyframes(*(
        cyclic_rows(a, mesh) if name in CLOUD_FIELDS else a.to(mesh.device)
        for name, a in zip(kf._fields, kf)))


def to_keyframe_store(kf: DistKeyframes, mesh: Mesh,
                      everywhere: bool = False) -> Optional[KeyframeStore]:
    """Inverse of ``from_keyframe_store``: the single-device store with the
    clouds in keyframe order, on rank 0 (None on the other ranks), or on
    every rank with ``everywhere``.  Collective: every rank calls it."""
    m = kf.t.shape[0]

    def unshard(a):
        g = mesh.all_gather(a) if everywhere else mesh.gather0(a)
        if g is None:
            return None
        # g[r, i] holds keyframe i * n + r.
        return g.transpose(0, 1).reshape(-1, *a.shape[1:])[:m]

    clouds = {name: unshard(getattr(kf, name)) for name in CLOUD_FIELDS}
    if clouds["corner"] is None:
        return None
    return KeyframeStore(R=kf.R, t=kf.t, time=kf.time, chain_R=kf.chain_R,
                         chain_t=kf.chain_t, count=kf.count,
                         overflow=kf.overflow, **clouds)


def from_slam_state(state: pipeline_mod.SlamState, mesh: Mesh
                    ) -> DistSlamState:
    """A single-device SLAM state (given on every rank) as this rank's
    distributed state; the submap cache is dropped."""
    mp = state.mapping
    return DistSlamState(
        odom=state.odom, loops=state.loops, mapping=DistMapState(
            kf=from_keyframe_store(mp.kf, mesh), t_bef=mp.t_bef,
            t_aft=mp.t_aft, ground_ref=mp.ground_ref,
            ground_ref_ok=mp.ground_ref_ok, initialized=mp.initialized))


def to_slam_state(state: DistSlamState, cfg: PipelineConfig, mesh: Mesh,
                  everywhere: bool = False):
    """The single-device SLAM state (with an empty, stale submap cache) on
    rank 0, or on every rank with ``everywhere``; None on the others.  The
    checkpoints and maps of a mesh run are written from it, so they are
    those of a single-device run.  Collective."""
    kf = to_keyframe_store(state.mapping.kf, mesh, everywhere)
    if kf is None:
        return None
    mp = state.mapping
    return pipeline_mod.SlamState(
        odom=state.odom, loops=state.loops, mapping=mapping_mod.MapState(
            kf=kf, cache=mapping_mod.init_cache(cfg.mapping, kf.t.device),
            t_bef=mp.t_bef, t_aft=mp.t_aft, ground_ref=mp.ground_ref,
            ground_ref_ok=mp.ground_ref_ok, initialized=mp.initialized))


# ---------------------------------------------------------------------------
# Sharded submap assembly
# ---------------------------------------------------------------------------

def extract_submap_dist(kf: DistKeyframes, center, cfg: MappingConfig,
                        mesh: Mesh):
    """Distributed ``mapping.extract_submap`` with the single-device
    selection: the poses are replicated, so every rank runs the same global
    dedup and nearest-``search_num`` selection, then transforms only the
    selected keyframes it owns, voxelises them to ``max(cap / n, scan
    cap)`` and one all-gather concatenates the ranks' submaps.  The
    selected keyframe set equals the single-device one; only the voxel
    partition differs (a voxel holding points of keyframes on two ranks
    yields a centroid on each).  Returns ((corner, valid), (surf, valid)),
    replicated, of ``n * cap`` rows each."""
    if cfg.submap_mode != "radius":
        raise ValueError("the mesh path assembles radius submaps only, got "
                         f"submap_mode={cfg.submap_mode!r}")
    n = mesh.size
    m = kf.t.shape[0]
    dev = kf.t.device
    n_sel = min(cfg.search_num, m)
    # Each rank owns ~n_sel/n of the selection (the cyclic layout spreads a
    # trajectory-ordered run evenly); 2x margin for imbalance.
    own_cap = min(n_sel, max(1, 2 * (-(-n_sel // n))))
    # Floored at one scan's cap: a rank holding a single selected keyframe
    # must not truncate its cloud.
    c_cap = max(cfg.submap_corner_cap // n, cfg.scan_corner_cap)
    s_cap = max(cfg.submap_surf_cap // n, cfg.scan_surf_cap)

    kf_ok = torch.arange(m, device=dev) < kf.count
    d2 = torch.sum((kf.t - center[None]) ** 2, dim=-1)
    rep = dedup_positions(kf.t, kf_ok, center, cfg.surrounding_leaf)
    d2 = torch.where(rep, d2, torch.full_like(d2, math.inf))
    neg, sel = _first_k(-d2, n_sel)                    # global indices
    sel_ok = (-neg) <= cfg.search_radius ** 2
    own = (sel % n) == mesh.rank
    own_d2 = torch.where(own & sel_ok, -neg, torch.full_like(neg, math.inf))
    o_neg, osel = _first_k(-own_d2, own_cap)            # into sel
    o_ok = torch.isfinite(o_neg)
    gsel = sel[osel]
    lsel = gsel // n

    def gather(cloud, valid, cap, leaf):
        world = se3.transform_points(Pose(kf.R[gsel], kf.t[gsel]),
                                     cloud[lsel])
        v = valid[lsel] & o_ok[:, None]
        pts, pv = voxel_downsample(world.reshape(-1, 3), v.reshape(-1),
                                   leaf, cap, origin=center)
        return (mesh.all_gather(pts).reshape(-1, 3),
                mesh.all_gather(pv).reshape(-1))

    return (gather(kf.corner, kf.corner_valid, c_cap, cfg.corner_leaf),
            gather(kf.surf, kf.surf_valid, s_cap, cfg.surf_leaf))


def _append_clouds_dist(kf: DistKeyframes, k: int, is_new: bool, c_pts,
                        c_ok, s_pts, s_ok, mesh: Mesh) -> DistKeyframes:
    """Write keyframe ``k``'s clouds into its owner's local slot, in
    place."""
    if is_new and k % mesh.size == mesh.rank:
        slot = k // mesh.size
        kf.corner[slot] = c_pts
        kf.corner_valid[slot] = c_ok
        kf.surf[slot] = s_pts
        kf.surf_valid[slot] = s_ok
    return kf


def gather_keyframe_clouds(kf: DistKeyframes, idxs, mesh: Mesh):
    """Replicated (K, cap, 3) clouds and validity of the keyframes ``idxs``:
    each rank contributes the rows it owns, zeros elsewhere, and one
    all-reduce sums them.  Moves the window, not the store."""
    idxs = torch.as_tensor(idxs, device=kf.t.device).long()
    own = (idxs % mesh.size) == mesh.rank
    slot = idxs // mesh.size

    def pick(cloud, valid):
        g = cloud[slot] * own[:, None, None].to(cloud.dtype)
        gv = (valid[slot] & own[:, None]).to(torch.int32)
        return mesh.all_reduce(g), mesh.all_reduce(gv) > 0

    c, cv = pick(kf.corner, kf.corner_valid)
    s, sv = pick(kf.surf, kf.surf_valid)
    return c, cv, s, sv


# ---------------------------------------------------------------------------
# Distributed mapping step
# ---------------------------------------------------------------------------

def mesh_map_hooks(mesh: Mesh) -> mapping_mod.MapHooks:
    """``mapping.mapping_step``'s hooks over the ranks: the submap rebuilt
    every step by ``extract_submap_dist`` (no cache, no voxel overflow
    count), the LM over the ranks, decisions read through ``Mesh.read``,
    a keyframe's clouds written by their owner."""

    def submap(state: DistMapState, center, cfg: MappingConfig):
        c, s = extract_submap_dist(state.kf, center, cfg, mesh)
        return state, c, s, torch.zeros((), dtype=torch.int32,
                                        device=center.device)

    def scan_to_map(*args):
        return mapping_dist.scan_to_map_sharded(*args, mesh)

    def write_clouds(kf, k, c_pts, c_ok, s_pts, s_ok):
        _append_clouds_dist(kf, k, True, c_pts, c_ok, s_pts, s_ok, mesh)

    return mapping_mod.MapHooks(submap=submap, scan_to_map=scan_to_map,
                                read=mesh.read, write_clouds=write_clouds)


def mapping_step_dist(state: DistMapState, corner_cloud: FeatureCloud,
                      surf_cloud: FeatureCloud, outlier_cloud: FeatureCloud,
                      odom_pose: Pose, scan_time, cfg: MappingConfig,
                      mesh: Mesh, imu_rpy=None,
                      ground_cloud: FeatureCloud | None = None):
    """``mapping.mapping_step`` over the ranks (``mesh_map_hooks``): the
    same replicated guess, scan downsample, trust region, ground anchor,
    attitude blend and keyframe gate; the submap assembled and the LM
    solved over the ranks.  The store is written in place.  Returns (new
    state, mapped pose, diag)."""
    return mapping_mod.mapping_step(
        state, corner_cloud, surf_cloud, outlier_cloud, odom_pose, scan_time,
        cfg, imu_rpy=imu_rpy, ground_cloud=ground_cloud,
        hooks=mesh_map_hooks(mesh))


# ---------------------------------------------------------------------------
# Distributed loop closure
# ---------------------------------------------------------------------------

def _detect_dist(kf: DistKeyframes, cfg: LoopClosureConfig) -> torch.Tensor:
    """``loopclosure.detect`` on the replicated pose arrays."""
    return loop_mod.detect(kf, cfg)


def close_and_correct_dist(kf: DistKeyframes, loops: LoopFactors,
                           cfg: LoopClosureConfig, pg_cfg: PoseGraphConfig,
                           mesh: Mesh):
    """``loopclosure.close_and_correct`` over the ranks: detection on the
    replicated poses, the current keyframe and the ±``history_num`` window
    gathered by a masked all-reduce, the ICP on every rank (the same clouds,
    so the same result), and on acceptance the pose graph re-solved over the
    ranks (``posegraph_dist.optimize_sharded``).  Only the replicated poses
    move: the sharded clouds are in the scan frame.  Returns (store,
    factors, corrected latest pose, diag); a corrected store is a new
    store."""
    dev = kf.t.device
    count = mesh.read(kf.count, "keyframe count")
    cur = max(count - 1, 0)
    cand = _detect_dist(kf, cfg)
    c = mesh.read(cand, "loop candidate")
    if c < 0 or cur < 1:
        diag = loop_mod.LoopDiag(candidate=cand,
                                 fitness=torch.zeros((), device=dev),
                                 closed=torch.tensor(False, device=dev))
        return kf, loops, Pose(kf.R[cur], kf.t[cur]), diag

    offs = torch.arange(-cfg.history_num, cfg.history_num + 1, device=dev)
    raw = c + offs
    hist = torch.clamp(raw, 0, cur)
    idxs = torch.cat([torch.tensor([cur], device=dev), hist])
    c_g, cv_g, s_g, sv_g = gather_keyframe_clouds(kf, idxs, mesh)

    pose0 = Pose(kf.R[cur], kf.t[cur])
    cur_pts = torch.cat([se3.transform_points(pose0, c_g[0]),
                         se3.transform_points(pose0, s_g[0])], dim=0)
    cur_val = torch.cat([cv_g[0], sv_g[0]], dim=0)
    # The history window without the drifted current pass
    # (loopclosure.window_cloud).
    in_range = (raw >= 0) & (raw < count) \
        & (kf.time[cur] - kf.time[hist] > cfg.min_time_gap)
    poses = Pose(kf.R[hist], kf.t[hist])
    pts = torch.cat([se3.transform_points(poses, c_g[1:]),
                     se3.transform_points(poses, s_g[1:])], dim=1)
    val = torch.cat([cv_g[1:] & in_range[:, None],
                     sv_g[1:] & in_range[:, None]], dim=1)
    hist_pts, hist_val = voxel_representative(
        pts.reshape(-1, 3), val.reshape(-1), cfg.submap_leaf, cfg.hist_cap)

    res = icp_ops.icp(cur_pts, cur_val, hist_pts, hist_val,
                      Pose.identity(device=dev),
                      max_corr_dist=cfg.icp_max_corr_dist,
                      max_iters=cfg.icp_max_iters, eps=cfg.icp_eps)
    accept = res.has_converged & (res.fitness < cfg.fitness_thresh)
    diag = loop_mod.LoopDiag(candidate=cand, fitness=res.fitness,
                             closed=accept)
    if not mesh.read(accept, "loop acceptance"):
        return kf, loops, Pose(kf.R[cur], kf.t[cur]), diag

    T_cor = se3.compose(res.pose, Pose(kf.R[cur], kf.t[cur]))
    Z = se3.relative(T_cor, Pose(kf.R[c], kf.t[c]))
    loops = posegraph.add_loop_factor(loops, cur, c, Z, res.fitness)
    R_out, t_out = posegraph_dist.optimize_sharded(
        kf.R, kf.t, kf.count, kf.chain_R, kf.chain_t, loops,
        Pose(kf.R[0], kf.t[0]), pg_cfg, mesh)
    kf = kf._replace(R=R_out, t=t_out)
    return kf, loops, Pose(kf.R[cur], kf.t[cur]), diag


# ---------------------------------------------------------------------------
# The drivers: the single device's, on the mesh's backend
# ---------------------------------------------------------------------------

class MeshBackend(pipeline_mod.Backend):
    """``pipeline.Backend`` over the ranks of ``mesh``: the state is a
    ``DistSlamState``, mapping runs through ``mesh_map_hooks``, loop
    closure through ``close_and_correct_dist``; no decimation (as in the
    JAX package)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.map_hooks = mesh_map_hooks(mesh)

    def init_state(self, cfg: PipelineConfig, device=None):
        return init_dist_state(cfg, self.mesh)

    def from_single(self, state):
        return from_slam_state(state, self.mesh)

    def snapshot(self, state, cfg: PipelineConfig):
        """Rank 0's single-device state; None on the others.
        Collective."""
        return to_slam_state(state, cfg, self.mesh)

    def close_loop(self, map_state, loops, cfg: PipelineConfig):
        kf, loops, corrected, ldiag = close_and_correct_dist(
            map_state.kf, loops, cfg.loop, cfg.posegraph, self.mesh)
        if self.mesh.read(ldiag.closed, "loop closed"):
            map_state = map_state._replace(kf=kf, t_aft=corrected)
        return map_state, loops

    def maybe_decimate(self, state, cfg: PipelineConfig, margin: int = 16):
        return state, False

    def relocalize(self, state, cfg: PipelineConfig):
        """Rank 0 relocalizes the single-device snapshot and broadcasts the
        replicated result (``t_bef``, ``t_aft``, ``initialized``, and the
        diagnostics) to every rank.  Returns (state, diag)."""
        mesh = self.mesh
        single = self.snapshot(state, cfg)
        dev = state.odom.xi.device
        flat = torch.zeros(29, device=dev)
        if mesh.rank == 0:
            st, d = reloc_mod.relocalize_slam_state(single, cfg)
            mp = st.mapping
            flat = torch.cat([mp.t_bef.R.reshape(-1), mp.t_bef.t,
                              mp.t_aft.R.reshape(-1), mp.t_aft.t,
                              torch.stack([mp.initialized.float(),
                                           d.accepted.float(),
                                           d.candidate.float(), d.fitness,
                                           d.n_candidates.float()])])
        flat = mesh.broadcast(flat)
        mp = state.mapping._replace(
            t_bef=Pose(flat[:9].reshape(3, 3), flat[9:12]),
            t_aft=Pose(flat[12:21].reshape(3, 3), flat[21:24]),
            initialized=flat[24] > 0.5)
        diag = reloc_mod.RelocDiag(
            accepted=flat[25] > 0.5, candidate=flat[26].to(torch.int32),
            fitness=flat[27], n_candidates=flat[28].to(torch.int32))
        return state._replace(mapping=mp), diag


def slam_scan_step_dist(state: DistSlamState, points, valid, ring,
                        cfg: PipelineConfig, mesh: Mesh, scan_time,
                        run_mapping: bool, run_loop: bool = False,
                        imu_integral: Optional[deskew_ops.ImuIntegral] = None,
                        bootstrap: bool = False):
    """``pipeline.slam_scan_step`` on every rank (``MeshBackend``): the
    frontend and odometry replicated (the same scan on every rank), mapping
    and the pose graph over the ranks; the IMU path and the scan-1
    ``bootstrap`` included."""
    return pipeline_mod.slam_scan_step(
        state, points, valid, ring, cfg, scan_time, run_mapping, run_loop,
        imu_integral, bootstrap, backend=MeshBackend(mesh))


def slam_scan_block_dist(state: DistSlamState, points, valid, ring,
                         cfg: PipelineConfig, mesh: Mesh, scan_times,
                         run_loop: bool = False, imu_integrals=None,
                         bootstrap: bool = False):
    """``pipeline.slam_scan_block`` over the ranks: B consecutive scans,
    mapping (and, with ``run_loop``, a loop-closure attempt) on the block's
    first scan, outputs stacked on a leading axis.  ``bootstrap`` (the first
    block of a run) needs B >= 2."""
    return pipeline_mod.slam_scan_block(
        state, points, valid, ring, cfg, scan_times, run_loop,
        imu_integrals, bootstrap, backend=MeshBackend(mesh))


def run_slam_sequence_dist(scans, cfg: PipelineConfig, mesh: Mesh,
                           times=None, imu_integrals=None):
    """``pipeline.run_slam_sequence`` over the ranks (the same scans on
    every rank; no decimation).  Returns (fused trajectory Pose (K, ...),
    final state)."""
    return pipeline_mod.run_slam_sequence(
        scans, cfg, times, imu_integrals=imu_integrals,
        backend=MeshBackend(mesh))
