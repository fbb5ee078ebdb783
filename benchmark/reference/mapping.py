"""Scan-to-map refinement, keyframe store and keyframe decimation (port of
``legoloam_tpu/models/mapping.py``; reference
``src/mapOptmization.cpp:376-1522``).

The keyframe store is a preallocated ring of fixed-cap clouds and poses;
keyframe inserts write it IN PLACE (the JAX package donates the store to the
same effect), so ``mapping_step`` mutates the ``MapState`` it is given.  The
submap is an incrementally folded, Morton-sorted voxel cache; the scan-to-map
LM is the reference's 6-DOF Gauss-Newton on 5-NN line/plane fits, with the
5-NN from kernel K3 (``knn_cuda``).

As in the JAX package's compiled step, every decision stays on the device:
the scan-to-map LM is its ``max_iterations`` iterations unrolled with a
freeze mask, and the keyframe insert writes at a device-side index
selected by the keyframe gate.  The one host read is the submap cache's
branch (rebuild, fold or skip, ``submap_decision``): a rebuild gathers the
whole radius of the store, so the branches are not all computed under a
``where``.  ``mapping_step`` is ``mapping_prepare``, that read,
``submap_update`` and ``mapping_finish``; the per-scan step runs the parts
as CUDA graph segments (``models/step_graph.py``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .config import MappingConfig
from .device import at, const
from . import lm, se3, smallalg
from .features import FeatureCloud
from .knn import knn_exact
from .se3 import Pose
from .voxel import voxel_cells, voxel_downsample


class KeyframeStore(NamedTuple):
    R: torch.Tensor            # (M, 3, 3)
    t: torch.Tensor            # (M, 3)
    time: torch.Tensor         # (M,)
    chain_R: torch.Tensor      # (M, 3, 3) between-factor from the previous kf
    chain_t: torch.Tensor      # (M, 3)
    corner: torch.Tensor       # (M, Ck, 3) scan-frame corner clouds
    corner_valid: torch.Tensor
    surf: torch.Tensor         # (M, Cs, 3) scan-frame surf(+outlier) clouds
    surf_valid: torch.Tensor
    count: torch.Tensor        # () int32
    overflow: torch.Tensor     # () int32 warranted keyframes dropped (full)


class SubmapCache(NamedTuple):
    c_pts: torch.Tensor
    c_cnt: torch.Tensor
    c_valid: torch.Tensor
    s_pts: torch.Tensor
    s_cnt: torch.Tensor
    s_valid: torch.Tensor
    origin: torch.Tensor         # (3,) Morton origin = pose at last rebuild
    merged: torch.Tensor         # () int32 keyframes folded in so far
    stale: torch.Tensor          # () bool
    prune_r: torch.Tensor        # () adaptive prune radius
    voxel_overflow: torch.Tensor  # () int32


class MapState(NamedTuple):
    kf: KeyframeStore
    cache: SubmapCache
    t_bef: Pose
    t_aft: Pose
    ground_ref: torch.Tensor
    ground_ref_ok: torch.Tensor
    initialized: torch.Tensor


class MappingDiag(NamedTuple):
    n_corner_res: torch.Tensor
    n_surf_res: torch.Tensor
    iters: torch.Tensor
    new_keyframe: torch.Tensor
    n_submap_corner: torch.Tensor
    n_submap_surf: torch.Tensor
    kf_overflow: torch.Tensor
    submap_overflow: torch.Tensor


def _scalar(v, dtype, device):
    return torch.full((), v, dtype=dtype, device=device)


def init_state(cfg: MappingConfig, device=None) -> MapState:
    m = cfg.max_keyframes
    f = dict(device=device)
    b = dict(dtype=torch.bool, device=device)
    eye = torch.eye(3, **f).expand(m, 3, 3).clone()
    kf = KeyframeStore(
        R=eye, t=torch.zeros((m, 3), **f), time=torch.zeros((m,), **f),
        chain_R=eye.clone(), chain_t=torch.zeros((m, 3), **f),
        corner=torch.zeros((m, cfg.scan_corner_cap, 3), **f),
        corner_valid=torch.zeros((m, cfg.scan_corner_cap), **b),
        surf=torch.zeros((m, cfg.scan_surf_cap, 3), **f),
        surf_valid=torch.zeros((m, cfg.scan_surf_cap), **b),
        count=_scalar(0, torch.int32, device),
        overflow=_scalar(0, torch.int32, device))
    return MapState(kf=kf, cache=init_cache(cfg, device),
                    t_bef=Pose.identity(device=device),
                    t_aft=Pose.identity(device=device),
                    ground_ref=_scalar(0.0, torch.float32, device),
                    ground_ref_ok=_scalar(False, torch.bool, device),
                    initialized=_scalar(False, torch.bool, device))


def init_cache(cfg: MappingConfig, device=None) -> SubmapCache:
    """An empty submap cache, marked stale."""
    f = dict(device=device)
    b = dict(dtype=torch.bool, device=device)
    cc, sc = cfg.submap_corner_cap, cfg.submap_surf_cap
    return SubmapCache(
        c_pts=torch.zeros((cc, 3), **f), c_cnt=torch.zeros((cc,), **f),
        c_valid=torch.zeros((cc,), **b),
        s_pts=torch.zeros((sc, 3), **f), s_cnt=torch.zeros((sc,), **f),
        s_valid=torch.zeros((sc,), **b),
        origin=torch.zeros((3,), **f),
        merged=_scalar(0, torch.int32, device),
        stale=_scalar(True, torch.bool, device),
        prune_r=_scalar(cfg.search_radius + cfg.submap_rebuild_dist,
                        torch.float32, device),
        voxel_overflow=_scalar(0, torch.int32, device))


# ---------------------------------------------------------------------------
# Submap assembly
# ---------------------------------------------------------------------------

def _pos_cell(t: torch.Tensor, center: torch.Tensor, leaf: float):
    """``leaf``-grid cell of each position relative to ``center``'s cell,
    packed into one int (7 bits/axis, clamped at ±63 cells)."""
    q = voxel_cells(t, leaf) - voxel_cells(center[None], leaf)
    q = torch.clamp(q, -63, 63) + 64
    return (q[:, 0] << 14) | (q[:, 1] << 7) | q[:, 2]


def dedup_positions(t, ok, center, leaf: float):
    """One representative (the lowest-index keyframe) per ``leaf``-sized
    position voxel on the absolute grid (mapOptmization.cpp:1009-1010)."""
    key = torch.where(ok, _pos_cell(t, center, leaf),
                      torch.full_like(ok, 0x7FFFFFFF, dtype=torch.int32))
    sk, perm = torch.sort(key, stable=True)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=t.device),
                       sk[1:] != sk[:-1]])
    rep = first & (sk != 0x7FFFFFFF)
    return torch.zeros(t.shape[:1], dtype=torch.bool,
                       device=t.device).scatter(0, perm, rep)


def extract_submap(kf: KeyframeStore, center, cfg: MappingConfig,
                   return_counts: bool = False, return_overflow: bool = False):
    """Nearest position-deduped keyframes within the search radius (or the
    ``search_num`` most recent, ``submap_mode="recent"``), transformed to
    world and voxel-downsampled into Morton-ordered fixed-cap submaps."""
    m = kf.t.shape[0]
    dev = kf.t.device
    if cfg.submap_mode == "recent":
        S = min(cfg.search_num, m)
        sel = kf.count.long() - S + torch.arange(S, device=dev)
        sel_ok = sel >= 0
        sel = torch.clamp(sel, 0, m - 1)
    elif cfg.submap_mode == "radius":
        kf_ok = torch.arange(m, device=dev) < kf.count
        d2 = torch.sum((kf.t - center[None, :]) ** 2, dim=-1)
        rep = dedup_positions(kf.t, kf_ok, center, cfg.surrounding_leaf)
        d2 = torch.where(rep, d2, torch.full_like(d2, math.inf))
        # Stable descending order of -d2 = lax.top_k's lowest-index ties.
        neg, order = torch.sort(-d2, descending=True, stable=True)
        S = min(cfg.search_num, m)
        sel, sel_ok = order[:S], (-neg[:S]) <= cfg.search_radius ** 2
    else:
        raise ValueError(f"submap_mode must be 'radius' or 'recent', "
                         f"got {cfg.submap_mode!r}")

    def gather(cloud, valid):
        world = se3.transform_points(Pose(kf.R[sel], kf.t[sel]), cloud[sel])
        v = valid[sel] & sel_ok[:, None]
        return world.reshape(-1, 3), v.reshape(-1)

    cpts, cval = gather(kf.corner, kf.corner_valid)
    spts, sval = gather(kf.surf, kf.surf_valid)
    sub_c = voxel_downsample(cpts, cval, cfg.corner_leaf,
                             cfg.submap_corner_cap, origin=center,
                             return_counts=return_counts,
                             return_overflow=return_overflow)
    sub_s = voxel_downsample(spts, sval, cfg.surf_leaf, cfg.submap_surf_cap,
                             origin=center, return_counts=return_counts,
                             return_overflow=return_overflow)
    return sub_c, sub_s


# The submap cache's branches (``submap_decision``).
REBUILD, FOLD, SKIP = 0, 1, 2


def submap_decision(cache: SubmapCache, kf: KeyframeStore, center,
                    cfg: MappingConfig) -> torch.Tensor:
    """Which branch ``update_submap_cache`` takes, as a () int32 on the
    device: REBUILD when stale / moved ``submap_rebuild_dist`` / more than
    a batch behind (always in ``submap_mode="recent"``), else FOLD when a
    batch is pending (every pending keyframe while the map is young; with
    a batch of 1 always, re-voxelising the cache even with nothing pending,
    as the JAX package does), else SKIP."""
    B = max(int(cfg.submap_merge_batch), 1)
    if cfg.submap_mode == "recent":
        return torch.full((), REBUILD, dtype=torch.int32,
                          device=kf.t.device)
    pending = kf.count - cache.merged
    moved = torch.linalg.norm(center - cache.origin) > cfg.submap_rebuild_dist
    rebuild = cache.stale | moved | (pending > B)
    fold = (pending >= B) | ((kf.count <= 2 * B) & (pending >= 1))
    if B == 1:
        fold = torch.ones_like(fold)
    return torch.where(rebuild, REBUILD,
                       torch.where(fold, FOLD, SKIP)).to(torch.int32)


def update_submap_cache(cache: SubmapCache, kf: KeyframeStore, center,
                        cfg: MappingConfig, branch=None) -> SubmapCache:
    """Bring the cached submap up to date with the keyframe store: full
    rebuild when stale / moved ``submap_rebuild_dist`` / more than a batch
    behind, else fold pending keyframes every ``submap_merge_batch``
    insertions (every one while the map is young).  ``branch`` (REBUILD,
    FOLD or SKIP) is ``submap_decision``'s, read back when not given."""
    if branch is None:
        branch = int(submap_decision(cache, kf, center, cfg).item())
    B = max(int(cfg.submap_merge_batch), 1)
    m = kf.t.shape[0]
    dev = kf.t.device
    max_prune = cfg.search_radius + cfg.submap_rebuild_dist
    if branch == REBUILD:
        (c, cv, cc, c_of), (s, sv, sc, s_of) = extract_submap(
            kf, center, cfg, return_counts=True, return_overflow=True)
        return SubmapCache(
            c_pts=c, c_cnt=cc, c_valid=cv, s_pts=s, s_cnt=sc, s_valid=sv,
            origin=center.clone(), merged=kf.count.clone(),
            stale=_scalar(False, torch.bool, dev),
            prune_r=_scalar(max_prune, torch.float32, dev),
            voxel_overflow=cache.voxel_overflow + c_of + s_of)
    if branch == SKIP:
        return cache._replace(stale=_scalar(False, torch.bool, dev))
    n_fold = torch.clamp(kf.count - cache.merged, max=B)
    ar = torch.arange(B, device=dev)
    idxs = torch.clamp(cache.merged.long() + ar, max=m - 1)
    take = ar < n_fold
    # Fold a pending keyframe only if it is its position cell's
    # representative (no earlier keyframe in the cell), as extract_submap's
    # dedup would choose.
    cells = _pos_cell(kf.t, cache.origin, cfg.surrounding_leaf)
    earlier = torch.arange(m, device=dev)[None, :] < idxs[:, None]
    is_rep = ~torch.any(earlier & (cells[None, :] == cells[idxs][:, None]),
                        dim=1)
    has_new = take & is_rep
    R, t = kf.R[idxs], kf.t[idxs]
    prune_r2 = cache.prune_r ** 2

    def merge(cached_pts, cached_cnt, cached_valid, clouds, clouds_valid,
              leaf, cap):
        world = se3.transform_points(Pose(R, t), clouds)
        new_ok = (clouds_valid & has_new[:, None]).reshape(-1)
        pts = torch.cat([cached_pts, world.reshape(-1, 3)], dim=0)
        w = torch.cat([cached_cnt, new_ok.to(cached_cnt.dtype)], dim=0)
        ok = torch.cat([cached_valid, new_ok], dim=0)
        ok = ok & (torch.sum((pts - cache.origin) ** 2, dim=-1) < prune_r2)
        return voxel_downsample(pts, ok, leaf, cap, origin=cache.origin,
                                weights=w, return_counts=True,
                                return_overflow=True)

    c, cv, cc, c_of = merge(cache.c_pts, cache.c_cnt, cache.c_valid,
                            kf.corner[idxs], kf.corner_valid[idxs],
                            cfg.corner_leaf, cfg.submap_corner_cap)
    s, sv, sc, s_of = merge(cache.s_pts, cache.s_cnt, cache.s_valid,
                            kf.surf[idxs], kf.surf_valid[idxs],
                            cfg.surf_leaf, cfg.submap_surf_cap)
    # Adaptive prune radius: shrink near the voxel caps, recover below.
    occ = torch.maximum(torch.sum(cv) / float(cfg.submap_corner_cap),
                        torch.sum(sv) / float(cfg.submap_surf_cap))
    new_r = torch.where(occ > 0.9, cache.prune_r * 0.95,
                        torch.clamp(cache.prune_r * 1.02, max=max_prune))
    new_r = torch.clamp(new_r, min=cfg.search_radius)
    return SubmapCache(
        c_pts=c, c_cnt=cc, c_valid=cv, s_pts=s, s_cnt=sc, s_valid=sv,
        origin=cache.origin, merged=cache.merged + n_fold,
        stale=_scalar(False, torch.bool, dev),
        prune_r=new_r.to(torch.float32),
        voxel_overflow=cache.voxel_overflow + c_of + s_of)


# ---------------------------------------------------------------------------
# Scan-to-map LM
# ---------------------------------------------------------------------------

def _knn5(p, pv, sub, sv, cfg: MappingConfig):
    """5-NN by the exact search (``nn_max_dist``, the SQUARED 5th-NN
    threshold, mapOptmization.cpp:1101,1183, is applied by the callers)."""
    return knn_exact(p, pv, sub, sv, k=5)


class _CorrGeom(NamedTuple):
    c_t1: torch.Tensor
    c_t2: torch.Tensor
    c_gate: torch.Tensor
    s_n: torch.Tensor
    s_off: torch.Tensor
    s_gate: torch.Tensor


def _fit_corner(p_world, q_valid, sub, sub_valid, cfg: MappingConfig):
    """cornerOptimization fit half (mapOptmization.cpp:1093-1127)."""
    d, i = _knn5(p_world, q_valid, sub, sub_valid, cfg)
    gate = q_valid & (d[:, 4] < cfg.nn_max_dist)
    c, v1, evals = lm.pca_line(sub[i])
    line_ok = evals[:, 2] > cfg.line_eig_ratio * evals[:, 1]
    return c + 0.1 * v1, c - 0.1 * v1, gate & line_ok


def _fit_surf(p_world, q_valid, sub, sub_valid, cfg: MappingConfig):
    """surfOptimization fit half (mapOptmization.cpp:1176-1207)."""
    d, i = _knn5(p_world, q_valid, sub, sub_valid, cfg)
    gate = q_valid & (d[:, 4] < cfg.nn_max_dist)
    n, off, max_off = lm.fit_plane_lstsq(sub[i])
    return n, off, gate & (max_off <= cfg.plane_fit_tol)


def _corner_residuals_from(p_world, t1, t2, gate, cfg: MappingConfig):
    dir_, ld2 = lm.point_to_line(p_world, t1, t2)
    w = 1.0 - cfg.robust_weight_scale * torch.abs(ld2)
    ok = gate & (w > cfg.robust_weight_min) & (ld2 > 0)
    w = torch.where(ok, w, torch.zeros_like(w))
    return dir_ * w[:, None], ld2 * w, ok


def _surf_residuals_from(p_world, n, off, gate, cfg: MappingConfig):
    pd2 = torch.sum(n * p_world, dim=-1) + off
    rng = torch.linalg.norm(p_world, dim=-1)
    w = 1.0 - cfg.robust_weight_scale * torch.abs(pd2) / torch.sqrt(
        torch.clamp(torch.sqrt(torch.clamp(rng, min=1e-9)), min=1e-9))
    ok = gate & (w > cfg.robust_weight_min) & (torch.abs(pd2) > 0)
    w = torch.where(ok, w, torch.zeros_like(w))
    return n * w[:, None], pd2 * w, ok


def _host(x: torch.Tensor, what: str = ""):
    """The host value (``bool``, ``int`` or ``float``) of a 0-d tensor that
    a decision reads; ``what`` names it (``parallel.mesh.Mesh.read`` checks
    it across ranks)."""
    return x.item()


def scan_to_map(guess: Pose, corner, corner_valid, surf, surf_valid,
                sub_c, sub_cv, sub_s, sub_sv, cfg: MappingConfig,
                reduce_fn=None):
    """scan2MapOptimization (mapOptmization.cpp:1329-1350): Gauss-Newton
    with 5-NN fits refreshed every ``corr_refresh_every`` iterations,
    rotation linearised about the current pose position, an odometry prior
    anchored at the guess, and the eigenvalue-100 degeneracy clamp.
    Returns (pose, iterations, n corner residuals, n surf residuals).

    The JAX ``while_loop`` is its ``max_iterations`` iterations unrolled:
    an iteration after the exit (too few residuals, the convergence test,
    or a submap below ``min_*_map``) runs and keeps its old values by
    ``where``, so the results, the iteration count included, are the
    loop's, with no host read.

    ``reduce_fn``: the sum over ranks of a tensor, for the scan rows
    sharded over a mesh with the submap replicated
    (``parallel.mapping_dist.scan_to_map_sharded``).  The residual counts
    are reduced before the residual gate and the normal equations before
    the prior is added, so every rank solves the same system."""
    dev = corner.device
    map_ok = (torch.sum(sub_cv) >= cfg.min_corner_map) \
        & (torch.sum(sub_sv) >= cfg.min_surf_map)
    if cfg.prior_trans_std > 0 and cfg.prior_rot_std_deg > 0:
        w_rot = 1.0 / math.radians(cfg.prior_rot_std_deg) ** 2
        w_trans = 1.0 / cfg.prior_trans_std ** 2
        prior_w = const((w_rot,) * 3 + (w_trans,) * 3, dev)
    else:
        prior_w = torch.zeros(6, device=dev)

    T = guess
    xi_acc = torch.zeros(6, device=dev)
    deg = lm.identity_degeneracy(6, dev)
    geom = None
    n_c = n_s = torch.zeros((), dtype=torch.int64, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    done = ~map_ok
    for i in range(cfg.max_iterations):
        if i % cfg.corr_refresh_every == 0:
            # After the exit the search has no live query, so K3 skips
            # every tile (and the CPU's plain version the whole search).
            pc_w = se3.transform_points(T, corner)
            ps_w = se3.transform_points(T, surf)
            t1, t2, c_gate = _fit_corner(pc_w, corner_valid & ~done, sub_c,
                                         sub_cv, cfg)
            n, off, s_gate = _fit_surf(ps_w, surf_valid & ~done, sub_s,
                                       sub_sv, cfg)
            geom = _CorrGeom(t1, t2, c_gate, n, off, s_gate)
        pc_w = se3.transform_points(T, corner)
        ps_w = se3.transform_points(T, surf)
        cdir, cres, c_ok = _corner_residuals_from(pc_w, geom.c_t1, geom.c_t2,
                                                  geom.c_gate, cfg)
        sdir, sres, s_ok = _surf_residuals_from(ps_w, geom.s_n, geom.s_off,
                                                geom.s_gate, cfg)
        p_all = torch.cat([pc_w, ps_w], dim=0)
        dir_all = torch.cat([cdir, sdir], dim=0)
        res_all = torch.cat([cres, sres], dim=0)
        ok_all = torch.cat([c_ok, s_ok], dim=0)
        nc_i, ns_i = torch.sum(c_ok), torch.sum(s_ok)
        if reduce_fn is not None:
            nc_i, ns_i = reduce_fn(torch.stack([nc_i, ns_i]))
        enough = nc_i + ns_i >= cfg.min_residuals
        lin_center = T.t
        J = torch.cat([torch.linalg.cross(p_all - lin_center[None, :],
                                          dir_all), dir_all], dim=1)
        AtA, AtB = lm.assemble_normal_equations(J, res_all, ok_all & enough,
                                                1.0)
        if reduce_fn is not None:
            sums = reduce_fn(torch.cat([AtA.reshape(-1), AtB]))
            AtA, AtB = sums[:36].reshape(6, 6), sums[36:]
        AtA = AtA + torch.diag(prior_w)
        AtB = AtB - prior_w * xi_acc
        delta, deg_i = lm.solve_assembled(AtA, AtB, deg, i == 0,
                                          cfg.degeneracy_eig_thresh)
        active = ~done
        moves = active & enough
        T = se3.where_pose(moves, se3.retract_about(T, delta, lin_center), T)
        xi_acc = torch.where(moves, xi_acc + delta, xi_acc)
        deg = lm.DegeneracyState(*(torch.where(active, a, b)
                                   for a, b in zip(deg_i, deg)))
        n_c = torch.where(active, nc_i, n_c)
        n_s = torch.where(active, ns_i, n_s)
        iters = iters + active.to(torch.int32)
        rot_deg = torch.rad2deg(torch.linalg.norm(delta[:3]))
        t_cm = torch.linalg.norm(delta[3:]) * 100.0
        done = done | ~enough | ((rot_deg < cfg.conv_rot_deg)
                                 & (t_cm < cfg.conv_trans_cm))
    return T, iters, n_c, n_s


def _ground_anchor(T: Pose, ground: FeatureCloud, ref_h, ref_ok,
                   cfg: MappingConfig):
    """Rotate roll/pitch about the pose position + shift z so the scan's
    ground plane matches the anchor height; the first good fit captures the
    reference height."""
    dev = T.t.device
    gw = se3.transform_points(T, ground.xyz)
    v = ground.valid
    n_pts = torch.sum(v)
    w = v.to(gw.dtype)
    c = torch.sum(gw * w[:, None], dim=0) / torch.clamp(n_pts, min=1)
    q = (gw - c) * w[:, None]
    _, evecs = smallalg.eigh3x3(q.T @ q)
    n = evecs[:, 0]
    n = n * torch.sign(n[2] + 1e-12)
    max_tilt = math.cos(math.radians(cfg.ground_anchor_max_tilt_deg))
    ok = (n_pts >= cfg.ground_anchor_min_pts) & (n[2] > max_tilt)

    ez = const((0.0, 0.0, 1.0), dev)
    axis = torch.linalg.cross(n, ez)
    sin_a = torch.linalg.norm(axis)
    angle = torch.arcsin(torch.clamp(sin_a, -1.0, 1.0))
    axis = axis / torch.clamp(sin_a, min=1e-12)
    Rc = se3.so3_exp(axis * angle * cfg.ground_anchor)
    t_rot = T.t
    T_rot = Pose(Rc @ T.R, se3.rotate_vec(Rc, T.t - t_rot) + t_rot)
    h = c[2] + (se3.rotate_vec(Rc, c - t_rot) + t_rot - c)[2]
    new_ref = torch.where(ref_ok, ref_h, h)
    dz = (new_ref - h) * cfg.ground_anchor
    T_anch = Pose(T_rot.R, T_rot.t + ez * dz)
    T_out = se3.where_pose(ok, T_anch, T)
    return (T_out, torch.where(ref_ok, ref_h, torch.where(ok, h, ref_h)),
            ref_ok | ok)


def _trust_region(guess: Pose, T: Pose, cfg: MappingConfig) -> Pose:
    """Scale the LM's correction relative to the guess down to the per-step
    caps, keeping its direction."""
    xi = se3.se3_log(se3.relative(guess, T))
    rot = torch.linalg.norm(xi[:3])
    trans = torch.linalg.norm(xi[3:])
    one = torch.ones_like(rot)
    max_rot = math.radians(cfg.max_step_rot_deg)
    scale = torch.minimum(one, torch.minimum(
        torch.where(rot > 0, max_rot / torch.clamp(rot, min=1e-12), one),
        torch.where(trans > 0,
                    cfg.max_step_trans / torch.clamp(trans, min=1e-12), one)))
    return se3.compose(guess, se3.se3_exp(xi * scale))


# ---------------------------------------------------------------------------
# Full mapping step
# ---------------------------------------------------------------------------

class MapHooks(NamedTuple):
    """The parts of a mapping step that run differently over a mesh
    (``parallel.pipeline_dist.mesh_map_hooks``); ``LOCAL`` is the single
    device's.

    decide(state, center, cfg) -> the submap branch as a () tensor, or
        None where there is no choice;
    submap(state, center, cfg, branch) -> (state, (corner, valid),
        (surf, valid), voxel overflow): the submap the LM matches against;
    scan_to_map: ``scan_to_map``'s arguments and result;
    read(x, what): the host value of a 0-d tensor a decision reads;
    write_clouds(kf, k, write, corner, valid, surf, valid): keyframe k's
        clouds into the store, in place, where the () bool ``write`` is set
        (``k`` a () int64 tensor)."""

    decide: Callable
    submap: Callable
    scan_to_map: Callable
    read: Callable
    write_clouds: Callable


def _cache_decision(state: MapState, center, cfg: MappingConfig):
    return submap_decision(state.cache, state.kf, center, cfg)


def _cached_submap(state: MapState, center, cfg: MappingConfig, branch):
    """The single device's submap: the incrementally folded cache."""
    cache = update_submap_cache(state.cache, state.kf, center, cfg, branch)
    return (state._replace(cache=cache), (cache.c_pts, cache.c_valid),
            (cache.s_pts, cache.s_valid), cache.voxel_overflow)


def put_row(arr: torch.Tensor, k: torch.Tensor, write: torch.Tensor,
            val) -> None:
    """``arr[k] = val`` in place where ``write`` is set (else ``arr[k]`` is
    written back unchanged), with ``k`` a () int64 device index."""
    k1 = k.reshape(1)
    old = arr.index_select(0, k1)
    arr.index_copy_(0, k1, torch.where(write, val, old[0]).unsqueeze(0))


def _write_clouds(kf: KeyframeStore, k, write, c_pts, c_ok, s_pts, s_ok):
    put_row(kf.corner, k, write, c_pts)
    put_row(kf.corner_valid, k, write, c_ok)
    put_row(kf.surf, k, write, s_pts)
    put_row(kf.surf_valid, k, write, s_ok)


LOCAL = MapHooks(decide=_cache_decision, submap=_cached_submap,
                 scan_to_map=scan_to_map, read=_host,
                 write_clouds=_write_clouds)


class MapPrep(NamedTuple):
    """A mapping step's first part: the guess, the downsampled scan clouds
    and the submap branch (None where there is no choice)."""

    guess: Pose
    c_pts: torch.Tensor
    c_ok: torch.Tensor
    s_pts: torch.Tensor
    s_ok: torch.Tensor
    branch: torch.Tensor | None


def mapping_prepare(state: MapState, corner_cloud: FeatureCloud,
                    surf_cloud: FeatureCloud, outlier_cloud: FeatureCloud,
                    odom_pose: Pose, cfg: MappingConfig,
                    hooks: MapHooks = LOCAL) -> MapPrep:
    """transformAssociateToMap, downsampleCurrentScan and the submap
    decision."""
    dev = odom_pose.t.device
    guess = se3.where_pose(
        state.initialized,
        se3.project_through_correction(odom_pose, state.t_bef, state.t_aft),
        odom_pose)
    # downsampleCurrentScan, Morton-ordered about the sensor.
    zero3 = torch.zeros(3, device=dev)
    c_pts, c_ok = voxel_downsample(corner_cloud.xyz, corner_cloud.valid,
                                   cfg.corner_leaf, cfg.scan_corner_cap,
                                   origin=zero3)
    surf_all = torch.cat([surf_cloud.xyz, outlier_cloud.xyz], dim=0)
    surf_all_ok = torch.cat([surf_cloud.valid, outlier_cloud.valid], dim=0)
    s_pts, s_ok = voxel_downsample(surf_all, surf_all_ok, cfg.surf_leaf,
                                   cfg.scan_surf_cap, origin=zero3)
    return MapPrep(guess=guess, c_pts=c_pts, c_ok=c_ok, s_pts=s_pts,
                   s_ok=s_ok, branch=hooks.decide(state, guess.t, cfg))


def mapping_finish(state: MapState, prep: MapPrep, submap, odom_pose: Pose,
                   scan_time, cfg: MappingConfig, imu_rpy=None,
                   ground_cloud: FeatureCloud | None = None,
                   hooks: MapHooks = LOCAL):
    """The LM against ``submap`` ((corner, valid), (surf, valid), voxel
    overflow), the trust region, ground anchor and attitude blend, and the
    keyframe insert (in place, at a device-side index).  ``scan_time`` is a
    () tensor on the device.  Returns (new state, mapped pose, diag)."""
    dev = odom_pose.t.device
    guess = prep.guess
    (sub_c, sub_cv), (sub_s, sub_sv), sub_overflow = submap
    T_lm, iters, n_c, n_s = hooks.scan_to_map(
        guess, prep.c_pts, prep.c_ok, prep.s_pts, prep.s_ok, sub_c, sub_cv,
        sub_s, sub_sv, cfg)
    T = _trust_region(guess, T_lm, cfg) if cfg.max_step_trans > 0 else T_lm
    T = se3.where_pose(state.kf.count >= cfg.min_lm_keyframes, T, guess)

    ground_ref, ground_ref_ok = state.ground_ref, state.ground_ref_ok
    if ground_cloud is not None and cfg.ground_anchor > 0:
        T, ground_ref, ground_ref_ok = _ground_anchor(
            T, ground_cloud, ground_ref, ground_ref_ok, cfg)
    if imu_rpy is not None:
        # transformUpdate (mapOptmization.cpp:463-496): roll and pitch
        # blended toward the IMU attitude.
        roll, pitch, yaw = se3.mat_to_euler_zyx(T.R)
        w = cfg.imu_blend
        roll = (1.0 - w) * roll + w * imu_rpy[0]
        pitch = (1.0 - w) * pitch + w * imu_rpy[1]
        T = Pose(se3.euler_zyx_to_mat(roll, pitch, yaw), T.t)
    T = Pose(se3.so3_project(T.R), T.t)

    # saveKeyFramesAndFactor: a keyframe when moved >= keyframe_dist (the
    # first frame always); a warranted keyframe with the store full is
    # counted in ``overflow``, never silent.
    kf = state.kf
    m = kf.t.shape[0]
    last = torch.clamp(kf.count.long() - 1, min=0)
    moved = torch.linalg.norm(T.t - at(kf.t, last)) >= cfg.keyframe_dist
    has_room = kf.count < m
    is_new = ~state.initialized | (moved & has_room)
    overflow_now = state.initialized & moved & ~has_room
    # The between-factor from the previous keyframe, captured now.
    meas = se3.relative(Pose(at(kf.R, last), at(kf.t, last)), T)
    k = torch.clamp(kf.count.long(), max=m - 1)
    write = is_new & has_room
    put_row(kf.R, k, write, T.R)
    put_row(kf.t, k, write, T.t)
    put_row(kf.time, k, write, scan_time.to(kf.time.dtype))
    put_row(kf.chain_R, k, write, meas.R)
    put_row(kf.chain_t, k, write, meas.t)
    hooks.write_clouds(kf, k, write, prep.c_pts, prep.c_ok, prep.s_pts,
                       prep.s_ok)
    kf = kf._replace(count=kf.count + is_new.to(torch.int32),
                     overflow=kf.overflow + overflow_now.to(torch.int32))

    new_state = state._replace(
        kf=kf, t_bef=odom_pose, t_aft=T, ground_ref=ground_ref,
        ground_ref_ok=ground_ref_ok,
        initialized=torch.ones((), dtype=torch.bool, device=dev))
    diag = MappingDiag(
        n_corner_res=n_c, n_surf_res=n_s, iters=iters, new_keyframe=is_new,
        n_submap_corner=torch.sum(sub_cv), n_submap_surf=torch.sum(sub_sv),
        kf_overflow=overflow_now, submap_overflow=sub_overflow)
    return new_state, T, diag


def submap_update(state: MapState, prep: MapPrep, cfg: MappingConfig, branch,
                  hooks: MapHooks = LOCAL):
    """The submap for ``prep``'s guess, the cache brought up to date by
    ``branch``: (state, submap)."""
    state, c, s, of = hooks.submap(state, prep.guess.t, cfg, branch)
    return state, (c, s, of)


def mapping_step(state: MapState, corner_cloud: FeatureCloud,
                 surf_cloud: FeatureCloud, outlier_cloud: FeatureCloud,
                 odom_pose: Pose, scan_time, cfg: MappingConfig,
                 imu_rpy=None, ground_cloud: FeatureCloud | None = None,
                 hooks: MapHooks = LOCAL):
    """One mapping update (mapOptmization.cpp:1487-1522).  The keyframe
    store of ``state`` is written in place; returns (new state, mapped pose,
    diag).  ``imu_rpy``: the IMU attitude at scan end, toward which roll and
    pitch are blended by ``cfg.imu_blend``.  ``hooks``: where the submap,
    the LM and the keyframe's clouds go (a mesh's, with a
    ``pipeline_dist.DistMapState``)."""
    dev = odom_pose.t.device
    scan_time = torch.as_tensor(scan_time, dtype=torch.float32, device=dev)
    prep = mapping_prepare(state, corner_cloud, surf_cloud, outlier_cloud,
                           odom_pose, cfg, hooks)
    branch = None if prep.branch is None \
        else hooks.read(prep.branch, "submap branch")
    state, submap = submap_update(state, prep, cfg, branch, hooks)
    return mapping_finish(state, prep, submap, odom_pose, scan_time, cfg,
                          imu_rpy, ground_cloud, hooks)


# ---------------------------------------------------------------------------
# Keyframe decimation
# ---------------------------------------------------------------------------

def decimate_keyframes(kf: KeyframeStore, loops, keep_recent: int = 512):
    """Halve a (nearly) full keyframe store: keep keyframe 0 (the prior's
    anchor), the ``keep_recent`` most recent and every second older one,
    compacted to the front in order.  Chain measurements are re-derived
    between the now-adjacent survivors from the current poses; each loop
    factor's endpoints move to their nearest surviving predecessors with the
    measurement compensated, Z' = (T_ai⁻¹ T_i) Z (T_j⁻¹ T_aj), and a factor
    whose endpoints collapse onto one node is invalidated and counted in
    ``dropped``.  Returns a new ``(kf, loops)``; the submap cache must be
    marked stale (indices moved)."""
    M = kf.t.shape[0]
    dev = kf.t.device
    idx = torch.arange(M, device=dev)
    count = kf.count.long()
    keep = (idx < count) & ((idx >= count - keep_recent) | (idx % 2 == 0))
    n_keep = torch.sum(keep).to(torch.int32)
    # New slot -> old index: a stable sort puts the survivors first.
    src = torch.sort((~keep).to(torch.int32), stable=True).indices
    gone = idx >= n_keep

    def take(arr, inert=0):
        g = arr[src]
        g[gone] = inert
        return g

    eye = torch.eye(3, dtype=kf.R.dtype, device=dev)
    R_new, t_new = take(kf.R, eye), take(kf.t)
    meas = se3.relative(Pose(torch.roll(R_new, 1, 0), torch.roll(t_new, 1, 0)),
                        Pose(R_new, t_new))
    chain_ok = ~gone & (idx > 0)
    kf_out = KeyframeStore(
        R=R_new, t=t_new, time=take(kf.time),
        chain_R=torch.where(chain_ok[:, None, None], meas.R, eye),
        chain_t=torch.where(chain_ok[:, None], meas.t, 0.0),
        corner=take(kf.corner), corner_valid=take(kf.corner_valid, False),
        surf=take(kf.surf), surf_valid=take(kf.surf_valid, False),
        count=n_keep, overflow=kf.overflow)

    # old2new[i]: the new slot of i's nearest surviving predecessor.
    old2new = torch.clamp(torch.cumsum(keep.to(torch.int64), 0) - 1, min=0)
    li, lj = loops.i.long(), loops.j.long()
    ni, nj = old2new[li], old2new[lj]
    ai, aj = src[ni], src[nj]                 # the anchors' old indices
    Z = Pose(loops.R, loops.t)
    Z_new = se3.compose(
        se3.relative(Pose(kf.R[ai], kf.t[ai]), Pose(kf.R[li], kf.t[li])),
        se3.compose(Z, se3.relative(Pose(kf.R[lj], kf.t[lj]),
                                    Pose(kf.R[aj], kf.t[aj]))))
    v = loops.valid
    collapsed = v & (ni == nj)
    loops_out = loops._replace(
        i=torch.where(v, ni.to(torch.int32), loops.i),
        j=torch.where(v, nj.to(torch.int32), loops.j),
        R=torch.where(v[:, None, None], Z_new.R, loops.R),
        t=torch.where(v[:, None], Z_new.t, loops.t),
        valid=v & ~collapsed,
        dropped=loops.dropped + torch.sum(collapsed).to(torch.int32))
    return kf_out, loops_out
