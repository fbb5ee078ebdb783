"""Two-step LM scan-to-scan odometry (port of
``legoloam_tpu/models/odometry.py``; reference
``src/featureAssociation.cpp:1044-1725``).

The scan motion is one se(3) twist ξ (a point at scan fraction s has
scan-start coordinates exp(s·ξ)·p).  Step A solves [roll, pitch, t_z] from
ground/planar matches, step B [yaw, t_x, t_y] from edge matches, each as
``max_iterations`` unrolled damped GN iterations with a convergence freeze
mask — tensor-only control flow, no host synchronisation.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..config import OdometryConfig
from ..device import const
from ..ops import lm, se3
from ..ops.class_nn_cuda import class_nn
from ..ops.features import FeatureCloud, ScanFeatures
from ..ops.se3 import Pose

_SURF_DOF = (0, 1, 5)    # [wx(roll), wy(pitch), vz]
_CORNER_DOF = (2, 3, 4)  # [wz(yaw), vx, vy]


class OdometryState(NamedTuple):
    pose: Pose
    xi: torch.Tensor             # (6,) twist of the previous scan
    last_corner: FeatureCloud
    last_surf: FeatureCloud
    last_outlier: FeatureCloud
    last_flat: FeatureCloud
    initialized: torch.Tensor    # () bool


class OdometryDiag(NamedTuple):
    n_surf_corr: torch.Tensor
    n_corner_corr: torch.Tensor
    surf_iters: torch.Tensor
    corner_iters: torch.Tensor
    feat_overflow: torch.Tensor  # (5,) int32


def empty_cloud(cap: int, device=None) -> FeatureCloud:
    return FeatureCloud(
        xyz=torch.zeros((cap, 3), device=device),
        ring=torch.zeros((cap,), device=device),
        rel_time=torch.zeros((cap,), device=device),
        valid=torch.zeros((cap,), dtype=torch.bool, device=device))


def init_state(odom_cfg, feat_cfg, device=None) -> OdometryState:
    return OdometryState(
        pose=Pose.identity(device=device),
        xi=torch.zeros(6, device=device),
        last_corner=empty_cloud(feat_cfg.max_less_sharp, device),
        last_surf=empty_cloud(feat_cfg.max_less_flat, device),
        last_outlier=empty_cloud(feat_cfg.max_outlier, device),
        last_flat=empty_cloud(feat_cfg.max_flat, device),
        initialized=torch.tensor(False, device=device))


def _warp_to_start(xi, cloud: FeatureCloud):
    """p_start = exp(s ξ) p (TransformToStart)."""
    return se3.apply(se3.se3_exp(cloud.rel_time[:, None] * xi[None, :]),
                     cloud.xyz)


def _warp_to_end(xi, cloud: FeatureCloud) -> FeatureCloud:
    """p_end = exp((s-1) ξ) p (TransformToEnd)."""
    p = se3.se3_exp((cloud.rel_time[:, None] - 1.0) * xi[None, :])
    return cloud._replace(xyz=se3.apply(p, cloud.xyz),
                          rel_time=torch.zeros_like(cloud.rel_time))


class _Corr(NamedTuple):
    n: torch.Tensor      # (F, 3) plane normal
    off: torch.Tensor    # (F,) plane offset
    t1: torch.Tensor     # (F, 3) line anchor 1
    t2: torch.Tensor     # (F, 3) line anchor 2
    valid: torch.Tensor  # (F,)


def _find_surf_corr(p_warped, q_valid, last: FeatureCloud,
                    cfg: OdometryConfig) -> _Corr:
    """findCorrespondingSurfFeatures (featureAssociation.cpp:1155-1232):
    j = NN; l = nearest same-or-lower ring; m = nearest strictly-higher
    ring; plane through (j, l, m)."""
    Q = p_warped.shape[0]
    gate = cfg.nearest_sq_dist
    ninf = torch.full((1, Q), -math.inf, device=p_warped.device)
    d0, i0 = class_nn(p_warped, last.xyz, last.valid, last.ring,
                      ninf, -ninf, ninf, q_tile=512)
    j_ok = q_valid & (d0[0] < gate)
    ring_j = last.ring[i0[0]][None, :]
    lo = torch.cat([ring_j - cfg.ring_window, ring_j + 0.5])
    hi = torch.cat([ring_j, ring_j + cfg.ring_window])
    ex = torch.cat([d0, ninf])
    d2, i2 = class_nn(p_warped, last.xyz, last.valid, last.ring,
                      lo, hi, ex, q_tile=512, n_classes=2)
    t1 = last.xyz[i0[0]]
    t2 = last.xyz[i2[0]]
    t3 = last.xyz[i2[1]]
    n, _ = lm.point_to_plane(p_warped, t1, t2, t3)
    off = -torch.sum(n * t1, dim=-1)
    ok = j_ok & (d2[0] < gate) & (d2[1] < gate)
    if cfg.surf_tripod_max_dz > 0:
        # Height-consistency gate on the tripod (see the JAX module).
        zs = torch.stack([t1[:, 2], t2[:, 2], t3[:, 2]], dim=1)
        spread = zs.amax(dim=1) - zs.amin(dim=1)
        qz = torch.abs(p_warped[:, 2] - t1[:, 2])
        ok = ok & (spread < cfg.surf_tripod_max_dz) \
            & (qz < cfg.surf_tripod_max_dz)
    return _Corr(n=n, off=off, t1=t1, t2=t3, valid=ok)


def _find_corner_corr(p_warped, q_valid, last: FeatureCloud,
                      cfg: OdometryConfig) -> _Corr:
    """findCorrespondingCornerFeatures (featureAssociation.cpp:1044-1121):
    j = NN; m = nearest point on a different ring within ±2.5; line (j, m)."""
    Q = p_warped.shape[0]
    gate = cfg.nearest_sq_dist
    ninf = torch.full((1, Q), -math.inf, device=p_warped.device)
    d0, i0 = class_nn(p_warped, last.xyz, last.valid, last.ring,
                      ninf, -ninf, ninf, q_tile=512)
    j_ok = q_valid & (d0[0] < gate)
    ring_j = last.ring[i0[0]][None, :]
    lo = torch.cat([ring_j - cfg.ring_window, ring_j + 0.5])
    hi = torch.cat([ring_j - 0.5, ring_j + cfg.ring_window])
    ex = torch.full((2, Q), -math.inf, device=p_warped.device)
    d2, i2 = class_nn(p_warped, last.xyz, last.valid, last.ring,
                      lo, hi, ex, q_tile=512, n_classes=2)
    pick_low = d2[0] <= d2[1]
    dm = torch.where(pick_low, d2[0], d2[1])
    im = torch.where(pick_low, i2[0], i2[1])
    t1 = last.xyz[i0[0]]
    t2 = last.xyz[im]
    return _Corr(n=torch.zeros_like(t1), off=torch.zeros_like(t1[:, 0]),
                 t1=t1, t2=t2, valid=j_ok & (dm < gate))


def _residuals(p_warped, corr: _Corr, is_line: bool):
    if is_line:
        return lm.point_to_line(p_warped, corr.t1, corr.t2)
    return corr.n, torch.sum(corr.n * p_warped, dim=-1) + corr.off


def _robust_weight(dist, p_warped, iter_count: int, cfg: OdometryConfig,
                   is_line: bool):
    """featureAssociation.cpp:1137-1146 (corner), 1251-1260 (surf); the surf
    weight divides by ‖p‖^¼ as the JAX package does (ROADMAP queue 3)."""
    if is_line:
        s = 1.0 - cfg.robust_weight_scale * torch.abs(dist)
    else:
        rng = torch.linalg.norm(p_warped, dim=-1)
        s = 1.0 - cfg.robust_weight_scale * torch.abs(dist) / torch.sqrt(
            torch.clamp(torch.sqrt(torch.clamp(rng, min=1e-9)), min=1e-9))
    if iter_count < cfg.robust_after_iter:
        s = torch.ones_like(s)
    keep = (s > cfg.robust_weight_min) & (torch.abs(dist) > 0)
    return torch.where(keep, s, torch.zeros_like(s)), keep


def _lm_loop(cloud: FeatureCloud, last: FeatureCloud, xi0, cfg,
             find_corr, dof: tuple, is_line: bool):
    """One of the two LM solves, unrolled with a convergence freeze mask."""
    dev = xi0.device
    dof_idx = const(dof, dev, torch.int64)
    deg = lm.identity_degeneracy(3, dev)
    xi = xi0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    corr = None
    n_used = torch.zeros((), dtype=torch.int32, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(cfg.max_iterations):
        p_warped = _warp_to_start(xi, cloud)
        if i % cfg.corr_refresh_every == 0 or corr is None:
            corr = find_corr(p_warped, cloud.valid, last, cfg)
        direction, dist = _residuals(p_warped, corr, is_line)
        w, keep = _robust_weight(dist, p_warped, i, cfg, is_line)
        row_ok = corr.valid & keep & cloud.valid & ~done
        s = cloud.rel_time[:, None]
        Jw = s * torch.linalg.cross(p_warped, direction)
        Jv = s * direction
        J = torch.cat([Jw, Jv], dim=1)[:, dof_idx] * w[:, None]
        delta, deg = lm.solve_normal_equations(
            J, dist * w, row_ok, cfg.step_damping, deg, i == 0,
            cfg.degeneracy_eig_thresh)
        delta = delta * (~done)
        xi = xi.index_add(0, dof_idx, delta)
        rot = delta[:1] if is_line else delta[:2]
        trans = delta[1:] if is_line else delta[2:]
        rot_deg = torch.rad2deg(torch.linalg.norm(rot))
        t_cm = torch.linalg.norm(trans) * 100.0
        n_used = torch.where(done, n_used, torch.sum(row_ok, dtype=torch.int32))
        iters = iters + (~done).to(torch.int32)
        done = done | ((rot_deg < cfg.conv_rot_deg)
                       & (t_cm < cfg.conv_trans_cm))
    return xi, iters, n_used


def odometry_step(state: OdometryState, feats: ScanFeatures,
                  cfg: OdometryConfig, xi_seed=None, imu_rot=None
                  ) -> Tuple[OdometryState, Pose, OdometryDiag]:
    """One scan's features -> (new state, world pose at scan end, diag).
    ``xi_seed`` overrides the constant-velocity prior (the IMU initial
    guess, featureAssociation.cpp:1639-1664).  ``imu_rot``, the gyro's
    rotation over the scan, pulls the solved rotation toward it by
    ``cfg.imu_rotation_blend`` (PluginIMURotation,
    featureAssociation.cpp:955-1013)."""
    xi0 = state.xi if xi_seed is None else xi_seed
    can_solve = (state.initialized
                 & (state.last_corner.count >= cfg.min_corner_last)
                 & (state.last_surf.count >= cfg.min_surf_last))
    xi_a, it_a, n_surf = _lm_loop(feats.flat, state.last_surf, xi0, cfg,
                                  _find_surf_corr, _SURF_DOF, is_line=False)
    xi_b, it_b, n_corner = _lm_loop(feats.sharp, state.last_corner, xi_a,
                                    cfg, _find_corner_corr, _CORNER_DOF,
                                    is_line=True)
    xi = torch.where(can_solve, xi_b, xi0)
    if imu_rot is not None and cfg.imu_rotation_blend > 0:
        b = cfg.imu_rotation_blend
        xi = torch.cat([(1.0 - b) * xi[:3] + b * imu_rot, xi[3:]])

    # integrateTransformation (featureAssociation.cpp:1697-1725), with the
    # accumulated rotation kept orthonormal.
    integrated = se3.compose(state.pose, se3.se3_exp(xi))
    integrated = Pose(se3.so3_project(integrated.R), integrated.t)
    new_pose = se3.where_pose(state.initialized, integrated, state.pose)

    # publishCloudsLast: warp this scan's broad sets to scan end.
    xi_warp = cfg.warp_blend * xi + (1.0 - cfg.warp_blend) * state.xi
    xi_warp = torch.where(state.initialized, xi_warp, xi)
    new_state = OdometryState(
        pose=new_pose, xi=xi,
        last_corner=_warp_to_end(xi_warp, feats.less_sharp),
        last_surf=_warp_to_end(xi_warp, feats.less_flat),
        last_outlier=_warp_to_end(xi_warp, feats.outlier),
        last_flat=_warp_to_end(xi_warp, feats.flat),
        initialized=torch.ones((), dtype=torch.bool, device=xi.device))
    diag = OdometryDiag(n_surf_corr=n_surf, n_corner_corr=n_corner,
                        surf_iters=it_a, corner_iters=it_b,
                        feat_overflow=feats.overflow)
    return new_state, new_pose, diag
