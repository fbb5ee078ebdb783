"""IMU integration and per-point motion de-skew (port of
``legoloam_tpu/ops/deskew.py``; reference ``src/featureAssociation.cpp:
391-619``: ``imuHandler``, ``AccumulateIMUShiftAndRotation``,
``adjustDistortion``, ``VeloToStartIMU``, ``TransformToStartIMU``).

The IMU window covering a scan arrives as fixed-shape tensors; integration
is a cumulative sum and the per-point lookup one ``searchsorted`` over all
cells.  De-skew removes only the nonlinear part of intra-scan motion, the
deviation from constant velocity at the scan-start velocity (the linear
part is what the odometry's per-point warp estimates):

    shift_from_start(t) = shift(t) - shift(t0) - velo(t0) (t - t0)
    p_corrected = R(t0)ᵀ R(t) p + R(t0)ᵀ shift_from_start(t)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import const
from .se3 import euler_zyx_to_mat, rotate_vec

GRAVITY = 9.81


class ImuWindow(NamedTuple):
    """Fixed-size window of IMU samples covering (at least) one scan."""

    time: torch.Tensor   # (L,) seconds, nondecreasing over valid entries
    rpy: torch.Tensor    # (L, 3) world attitude roll/pitch/yaw
    acc: torch.Tensor    # (L, 3) specific force, sensor frame (with gravity)
    gyro: torch.Tensor   # (L, 3) angular rate, sensor frame
    valid: torch.Tensor  # (L,) bool


class ImuIntegral(NamedTuple):
    """Integrated IMU quantities at each sample (world frame)."""

    time: torch.Tensor   # (L,)
    rpy: torch.Tensor    # (L, 3)
    velo: torch.Tensor   # (L, 3) world velocity
    shift: torch.Tensor  # (L, 3) world position offset
    ang: torch.Tensor    # (L, 3) integrated gyro angles (odometry seed)
    valid: torch.Tensor


def integrate_imu(w: ImuWindow) -> ImuIntegral:
    """``AccumulateIMUShiftAndRotation`` (featureAssociation.cpp:392-429)
    as cumulative sums: a_w = R(rpy) f + g, with integration across gaps
    longer than 0.1 s suppressed by zeroing dt (featureAssociation.cpp:
    413-428)."""
    R = euler_zyx_to_mat(w.rpy[:, 0], w.rpy[:, 1], w.rpy[:, 2])
    g = const((0.0, 0.0, -GRAVITY), w.acc.device)
    a_world = rotate_vec(R, w.acc) + g
    dt = torch.diff(w.time, prepend=w.time[:1])
    dt = torch.where(w.valid & (dt > 0) & (dt < 0.1), dt, 0.0)[:, None]
    velo = torch.cumsum(a_world * dt, dim=0)
    velo_prev = torch.cat([torch.zeros_like(velo[:1]), velo[:-1]], dim=0)
    shift = torch.cumsum(velo_prev * dt + 0.5 * a_world * dt ** 2, dim=0)
    ang = torch.cumsum(w.gyro * dt, dim=0)
    return ImuIntegral(time=w.time, rpy=w.rpy, velo=velo, shift=shift,
                       ang=ang, valid=w.valid)


def _interp(integral: ImuIntegral, t: torch.Tensor):
    """Linear interpolation of rpy/velo/shift/ang at times ``t`` (any
    shape), clamped to the nearest sample outside the window (the
    reference's behaviour when its pointer reaches the newest sample,
    featureAssociation.cpp:533-545)."""
    L = integral.time.shape[0]
    tt = torch.where(integral.valid, integral.time,
                     torch.full_like(integral.time, float("inf")))
    hi = torch.clamp(torch.searchsorted(tt, t.contiguous(), right=True),
                     1, L - 1)
    lo = hi - 1
    t_lo, t_hi = tt[lo], tt[hi]
    denom = torch.where(t_hi > t_lo, t_hi - t_lo, torch.ones_like(t_hi))
    f = torch.clamp((t - t_lo) / denom, 0.0, 1.0)
    f = torch.where(torch.isfinite(t_hi), f, torch.zeros_like(f))[..., None]

    def lerp(a):
        return a[lo] + f * (a[hi] - a[lo])

    return (lerp(integral.rpy), lerp(integral.velo), lerp(integral.shift),
            lerp(integral.ang))


class DeskewResult(NamedTuple):
    xyz: torch.Tensor                   # (N, H, 3) scan-start frame
    rpy_start: torch.Tensor             # (3,) IMU attitude at scan start
    velo_start: torch.Tensor            # (3,) world velocity at scan start
    ang_delta: torch.Tensor             # (3,) gyro delta over the scan
    shift_from_start_end: torch.Tensor  # (3,) nonlinear shift at scan end


def deskew_image(xyz, rel_time, cell_valid, scan_start_time,
                 integral: ImuIntegral, scan_period: float = 0.1
                 ) -> DeskewResult:
    """De-skew a dense (N, H, 3) image with the integrated IMU state
    (``adjustDistortion`` + ``TransformToStartIMU``,
    featureAssociation.cpp:491-619)."""
    t0 = torch.as_tensor(scan_start_time, dtype=torch.float32,
                         device=xyz.device).reshape(1)
    t_pt = t0 + rel_time * scan_period
    rpy_p, _, shift_p, _ = _interp(integral, t_pt)
    rpy_s, velo_s, shift_s, ang_s = (a[0] for a in _interp(integral, t0))
    _, _, shift_e, ang_e = (a[0] for a in _interp(integral,
                                                    t0 + scan_period))
    shift_from_start = shift_p - shift_s - velo_s * (t_pt - t0)[..., None]
    R_sT = euler_zyx_to_mat(rpy_s[0], rpy_s[1], rpy_s[2]).T
    R_p = euler_zyx_to_mat(rpy_p[..., 0], rpy_p[..., 1], rpy_p[..., 2])
    p_corr = rotate_vec(R_sT, rotate_vec(R_p, xyz)) \
        + rotate_vec(R_sT, shift_from_start)
    return DeskewResult(
        xyz=torch.where(cell_valid[..., None], p_corr, xyz),
        rpy_start=rpy_s, velo_start=velo_s, ang_delta=ang_e - ang_s,
        shift_from_start_end=shift_e - shift_s - velo_s * scan_period)
