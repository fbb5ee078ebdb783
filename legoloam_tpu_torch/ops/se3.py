"""Batched SE(3)/SO(3) utilities (port of ``legoloam_tpu/ops/se3.py``).

Poses are ``Pose(R, t)`` with ``R: (..., 3, 3)`` and ``t: (..., 3)``, float32,
broadcasting over leading batch dims.  The JAX package expands 3x3 products by
hand to keep them off the TPU's matrix unit; here they are plain ``@`` in full
float32 (TF32 is disabled in the package ``__init__``).

Frame convention: single lidar frame (x forward, y left, z up).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pose(NamedTuple):
    """Rigid transform p_world = R @ p_local + t, broadcastable over batch."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(batch: tuple = (), device=None,
                 dtype=torch.float32) -> "Pose":
        R = torch.eye(3, dtype=dtype, device=device).expand(
            *batch, 3, 3).clone()
        t = torch.zeros(*batch, 3, dtype=dtype, device=device)
        return Pose(R, t)


def where_pose(cond: torch.Tensor, a: Pose, b: Pose) -> Pose:
    """Elementwise select between two poses on a scalar bool tensor."""
    return Pose(torch.where(cond, a.R, b.R), torch.where(cond, a.t, b.t))


def rotate_vec(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R (..., 3, 3) @ v (..., 3)``."""
    return (R @ v[..., None])[..., 0]


def so3_project(R: torch.Tensor) -> torch.Tensor:
    """One symmetric-Newton step toward the nearest rotation:
    R <- R (3I − RᵀR) / 2 (orthonormality insurance on accumulated
    rotations)."""
    RtR = R.transpose(-1, -2) @ R
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    return R @ (1.5 * eye - 0.5 * RtR)


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b: apply b first, then a."""
    return Pose(a.R @ b.R, rotate_vec(a.R, b.t) + a.t)


def inverse(p: Pose) -> Pose:
    Rt = p.R.transpose(-1, -2)
    return Pose(Rt, -rotate_vec(Rt, p.t))


def transform_points(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose (batch ``...``) to a cloud ``(..., N, 3)``."""
    return pts @ p.R.transpose(-1, -2) + p.t[..., None, :]


def apply(p: Pose, x: torch.Tensor) -> torch.Tensor:
    """Apply pose to per-item points ``(..., 3)`` (pose batch dims match)."""
    return rotate_vec(p.R, x) + p.t


def relative(a: Pose, b: Pose) -> Pose:
    """a⁻¹ ∘ b — the motion taking frame a to frame b."""
    return compose(inverse(a), b)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, numerically safe at ||w|| -> 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse of so3_exp.  Safe for theta in [0, pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w_vee = vee(R - R.transpose(-1, -2)) * 0.5
    sin_theta = torch.sin(theta)
    small = theta < 1e-4
    scale = torch.where(small, 1.0 + theta * theta / 6.0,
                        theta / torch.where(small, torch.ones_like(sin_theta),
                                            sin_theta))
    w = w_vee * scale[..., None]
    near_pi = theta > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0))
    one = torch.ones_like(theta)
    sx = torch.where(R[..., 2, 1] - R[..., 1, 2] >= 0, one, -one)
    sy = torch.where(R[..., 0, 2] - R[..., 2, 0] >= 0, one, -one)
    sz = torch.where(R[..., 1, 0] - R[..., 0, 1] >= 0, one, -one)
    axis = axis * torch.stack([sx, sy, sz], dim=-1)
    w_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


def so3_interp(Ra: torch.Tensor, Rb: torch.Tensor,
               s: torch.Tensor) -> torch.Tensor:
    """Geodesic interpolation R(s) = Ra exp(s log(RaᵀRb))."""
    dR = Ra.transpose(-1, -2) @ Rb
    return Ra @ so3_exp(so3_log(dR) * s[..., None])


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V(w) used in the se(3) exponential."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-12
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    W = hat(w)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def se3_exp(xi: torch.Tensor) -> Pose:
    """xi = (..., 6) [w | v] twist -> Pose."""
    w, v = xi[..., :3], xi[..., 3:]
    return Pose(so3_exp(w), rotate_vec(_left_jacobian(w), v))


def se3_log(p: Pose) -> torch.Tensor:
    from . import smallalg

    w = so3_log(p.R)
    v = smallalg.solve3(_left_jacobian(w), p.t)
    return torch.cat([w, v], dim=-1)


def retract(p: Pose, xi: torch.Tensor) -> Pose:
    """Left-multiplicative update: exp(xi) ∘ p."""
    return compose(se3_exp(xi), p)


def retract_about(p: Pose, xi: torch.Tensor, center: torch.Tensor) -> Pose:
    """Left-multiplicative update whose rotation acts about ``center``:
    x -> exp(ω)·(x − center) + center + v (pairs with Jacobians built from
    centred point coordinates)."""
    Rd = so3_exp(xi[:3])
    td = center + xi[3:] - rotate_vec(Rd, center)
    return compose(Pose(Rd, td), p)


# ---------------------------------------------------------------------------
# Euler (ZYX yaw-pitch-roll, lidar frame)
# ---------------------------------------------------------------------------

def _rot(a, rows):
    a = torch.as_tensor(a, dtype=torch.float32)
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    env = {"c": c, "s": s, "-s": -s, "o": o, "z": z}
    return torch.stack([torch.stack([env[e] for e in row], -1)
                        for row in rows], -2)


def rot_x(a):
    return _rot(a, (("o", "z", "z"), ("z", "c", "-s"), ("z", "s", "c")))


def rot_y(a):
    return _rot(a, (("c", "z", "s"), ("z", "o", "z"), ("-s", "z", "c")))


def rot_z(a):
    return _rot(a, (("c", "-s", "z"), ("s", "c", "z"), ("z", "z", "o")))


def euler_zyx_to_mat(roll, pitch, yaw) -> torch.Tensor:
    """R = Rz(yaw) Ry(pitch) Rx(roll)."""
    return rot_z(yaw) @ rot_y(pitch) @ rot_x(roll)


def mat_to_euler_zyx(R: torch.Tensor):
    """Inverse of euler_zyx_to_mat (gimbal-safe for |pitch| < pi/2)."""
    pitch = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


# ---------------------------------------------------------------------------
# Reference-frame comparison helpers
# ---------------------------------------------------------------------------

# The reference's camera convention: p_cam = (p_lidar.y, p_lidar.z, p_lidar.x)
# (src/featureAssociation.cpp:500-502); as a rotation, lidar -> camera.
_SWAP = ((0.0, 1.0, 0.0), (0.0, 0.0, 1.0), (1.0, 0.0, 0.0))


def lidar_to_camera(p: Pose) -> Pose:
    """Express a lidar-frame pose in the reference's camera convention."""
    S = torch.tensor(_SWAP, dtype=p.t.dtype, device=p.t.device)
    return Pose(S @ p.R @ S.T, torch.einsum("ij,...j->...i", S, p.t))


def camera_to_lidar(p: Pose) -> Pose:
    S = torch.tensor(_SWAP, dtype=p.t.dtype, device=p.t.device)
    return Pose(S.T @ p.R @ S, torch.einsum("ji,...j->...i", S, p.t))


def project_through_correction(t_now: Pose, t_bef: Pose, t_aft: Pose) -> Pose:
    """``transformAssociateToMap``: T_aft ∘ T_bef⁻¹ ∘ T_now."""
    return compose(t_aft, compose(inverse(t_bef), t_now))
