"""IMU integration, de-skew and synthetic IMU samples: the port against the
JAX package on the same numpy inputs, and the contracts of
tests/test_deskew.py on the port.

Tolerances: ``make_imu`` times exact, attitudes 1e-6 rad, specific force
1e-5 m/s², gyro rates 1e-4 rad/s (a finite rotation difference over 5 ms
divides float32 rounding by 0.005); integrated velocity, shift and angles
1e-5; de-skewed cells 1e-4 m (float32 products at up to ~60 m ranges).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu.config import VLP16
from legoloam_tpu.ops import deskew as jdsk
from legoloam_tpu.ops import projection, se3
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch.ops import deskew as tdsk
from legoloam_tpu_torch.ops.se3 import Pose as TPose
from legoloam_tpu_torch.utils import synthetic as tsyn
from legoloam_tpu_torch.utils.interop import slam_state_from_numpy

from _torch_parity import npy, tt


def _window(times, rpy, acc, gyro):
    """An ImuWindow of numpy arrays padded to a multiple of 64 samples."""
    n = len(times)
    L = max(64, ((n + 63) // 64) * 64)
    pad = L - n
    f32 = np.float32
    return jdsk.ImuWindow(
        time=np.pad(np.asarray(times, f32), (0, pad),
                    constant_values=times[-1] + 1e3),
        rpy=np.pad(np.asarray(rpy, f32), ((0, pad), (0, 0))),
        acc=np.pad(np.asarray(acc, f32), ((0, pad), (0, 0))),
        gyro=np.pad(np.asarray(gyro, f32), ((0, pad), (0, 0))),
        valid=np.arange(L) < n)


def _integrals(win):
    """(JAX integral as numpy, port integral) of one numpy window."""
    j = jdsk.integrate_imu(jdsk.ImuWindow(*(jnp.asarray(a) for a in win)))
    t = tdsk.integrate_imu(slam_state_from_numpy(win, "cpu"))
    return jdsk.ImuIntegral(*(np.asarray(a) for a in j)), t


@pytest.mark.parametrize("n,radius,rate", [(10, 15.0, 0.01),
                                           (97, 30.0, 0.009)])
def test_make_imu_matches_jax(n, radius, rate):
    jp = jsyn.circle_trajectory(n, radius=radius, angular_rate=rate)
    tp = TPose(tt(jp.R), tt(jp.t))
    got = tsyn.make_imu(tp, scan_period=0.1)
    want = jsyn.make_imu(jp, scan_period=0.1)
    for (name, tol), a, b in zip((("time", 0.0), ("rpy", 1e-6),
                                  ("acc", 1e-5), ("gyro", 1e-4)), got, want):
        assert a.shape == np.asarray(b).shape, name
        assert np.abs(npy(a) - np.asarray(b)).max() <= tol, name


def test_integration_matches_jax_and_constant_acceleration():
    """Level sensor accelerating at 2 m/s² in +x: the same integral as the
    JAX package, velocity ramps and shift is quadratic."""
    ts = np.arange(0.0, 0.5, 0.005)
    n = len(ts)
    a = 2.0
    win = _window(ts, np.zeros((n, 3)),
                  np.tile([a, 0.0, tdsk.GRAVITY], (n, 1)), np.zeros((n, 3)))
    j, t = _integrals(win)
    for f in ("velo", "shift", "ang"):
        np.testing.assert_allclose(npy(getattr(t, f)), getattr(j, f),
                                   atol=1e-5, err_msg=f)
    t_total = ts[-1] - ts[0]
    np.testing.assert_allclose(npy(t.velo)[n - 1], [a * t_total, 0, 0],
                               atol=0.02)
    np.testing.assert_allclose(npy(t.shift)[n - 1],
                               [0.5 * a * t_total ** 2, 0, 0], atol=0.02)


def test_deskew_identity_when_static():
    ts = np.arange(0.0, 0.3, 0.005)
    n = len(ts)
    _, integ = _integrals(_window(ts, np.zeros((n, 3)),
                                  np.tile([0, 0, tdsk.GRAVITY], (n, 1)),
                                  np.zeros((n, 3))))
    rel = torch.linspace(0, 1, 1800)[None, :].expand(16, 1800)
    out = tdsk.deskew_image(torch.ones((16, 1800, 3)), rel,
                            torch.ones((16, 1800), dtype=torch.bool), 0.1,
                            integ)
    np.testing.assert_allclose(npy(out.xyz), 1.0, atol=1e-4)
    np.testing.assert_allclose(npy(out.ang_delta), 0.0, atol=1e-6)


def test_deskew_rotation_matches_jax_and_removes_distortion():
    """Sensor pitching at 0.6 rad/s over a flat plane: the port de-skews
    every cell as the JAX package does, and the ground returns to the
    start-frame plane z = -h."""
    h, rate = 0.8, 0.6
    scene = jsyn.Scene(
        boxes=jnp.array([[900.0, 900.0, 0.0, 901.0, 901.0, 1.0]]),
        cylinders=jnp.array([[900.0, 0.0, 0.1, 1.0]]))
    pose0 = Pose(jnp.eye(3), jnp.array([0.0, 0.0, h]))
    pose1 = Pose(se3.rot_y(jnp.float32(rate * 0.1)),
                 jnp.array([0.0, 0.0, h]))
    pts, valid, ring = jsyn.raycast_scan(scene, pose0, VLP16,
                                         next_pose=pose1, motion=True)
    img = projection.project_scan(pts, valid, VLP16, ring=ring)
    ts = np.arange(-0.05, 0.25, 0.005)
    n = len(ts)
    rpy = np.stack([np.zeros(n), np.maximum(ts, 0.0) * rate, np.zeros(n)], 1)
    acc = np.stack([-tdsk.GRAVITY * np.sin(rpy[:, 1]), np.zeros(n),
                    tdsk.GRAVITY * np.cos(rpy[:, 1])], 1)
    gyro = np.stack([np.zeros(n), np.full(n, rate) * (ts >= 0),
                     np.zeros(n)], 1)
    win = _window(ts, rpy, acc, gyro)
    j_int, t_int = _integrals(win)
    want = jdsk.deskew_image(img.xyz, img.rel_time, img.valid,
                             jnp.float32(0.0),
                             jdsk.ImuIntegral(*map(jnp.asarray, j_int)))
    got = tdsk.deskew_image(tt(img.xyz), tt(img.rel_time), tt(img.valid),
                            0.0, t_int)
    np.testing.assert_allclose(npy(got.xyz), np.asarray(want.xyz), atol=1e-4)
    for f in ("rpy_start", "velo_start", "ang_delta",
              "shift_from_start_end"):
        np.testing.assert_allclose(npy(getattr(got, f)),
                                   np.asarray(getattr(want, f)), atol=1e-5,
                                   err_msg=f)
    fixed_z = npy(got.xyz[..., 2])[np.asarray(img.valid)]
    assert np.abs(fixed_z + h).max() < 0.02
    np.testing.assert_allclose(npy(got.ang_delta), [0, rate * 0.1, 0],
                               atol=0.01)


def test_deskew_removes_nonlinear_translation():
    """Acceleration from rest: a point measured at scan end moves by
    0.5 a T² (the constant-velocity deviation), rotations untouched."""
    ts = np.arange(0.0, 0.2, 0.005)
    n = len(ts)
    a = 3.0
    _, integ = _integrals(_window(ts, np.zeros((n, 3)),
                                  np.tile([a, 0.0, tdsk.GRAVITY], (n, 1)),
                                  np.zeros((n, 3))))
    xyz = torch.zeros((16, 1800, 3))
    xyz[..., 0] = 10.0
    out = tdsk.deskew_image(xyz, torch.ones((16, 1800)),
                            torch.ones((16, 1800), dtype=torch.bool), 0.0,
                            integ)
    np.testing.assert_allclose(npy(out.xyz[..., 0]), 10.0 + 0.5 * a * 0.01,
                               atol=2e-3)
