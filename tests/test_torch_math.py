"""se3 / smallalg / lm: the port against the JAX package on seeded inputs,
to 1e-5 (float32 rounding of the different evaluation orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu.ops import lm as jlm
from legoloam_tpu.ops import se3 as jse3
from legoloam_tpu.ops import smallalg as jsa
from legoloam_tpu_torch.ops import lm as tlm
from legoloam_tpu_torch.ops import se3 as tse3
from legoloam_tpu_torch.ops import smallalg as tsa

from _torch_parity import npy, tt

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


def _close(a, b, **kw):
    np.testing.assert_allclose(npy(a), np.asarray(b), **(kw or TOL))


@pytest.mark.parametrize("scale", [1e-7, 1e-3, 0.5, 2.5])
def test_so3_exp_log(scale):
    w = _rand((64, 3), 0, scale)
    _close(tse3.so3_exp(tt(w)), jse3.so3_exp(w))
    R = np.asarray(jse3.so3_exp(w))
    _close(tse3.so3_log(tt(R)), jse3.so3_log(R), rtol=1e-4, atol=1e-5)


def test_se3_exp_log_compose_inverse():
    xi = _rand((32, 6), 1, 0.4)
    tp = tse3.se3_exp(tt(xi))
    jp = jse3.se3_exp(xi)
    _close(tp.R, jp.R)
    _close(tp.t, jp.t)
    _close(tse3.se3_log(tp), jse3.se3_log(jp), rtol=1e-4, atol=1e-5)
    xi2 = _rand((32, 6), 2, 0.4)
    tq, jq = tse3.se3_exp(tt(xi2)), jse3.se3_exp(xi2)
    for a, b in zip(tse3.compose(tp, tq), jse3.compose(jp, jq)):
        _close(a, b)
    for a, b in zip(tse3.relative(tp, tq), jse3.relative(jp, jq)):
        _close(a, b)
    pts = _rand((32, 50, 3), 3, 20.0)
    _close(tse3.transform_points(tp, tt(pts)),
           jse3.transform_points(jp, pts), rtol=1e-5, atol=1e-4)
    c = _rand((3,), 4, 30.0)
    for a, b in zip(tse3.retract_about(tse3.Pose(tp.R[0], tp.t[0]),
                                       tt(xi2[0]), tt(c)),
                    jse3.retract_about(jse3.Pose(jp.R[0], jp.t[0]),
                                       xi2[0], c)):
        _close(a, b, rtol=1e-5, atol=1e-4)


def test_interp_euler_project():
    Ra = np.asarray(jse3.so3_exp(_rand((16, 3), 5, 0.8)))
    Rb = np.asarray(jse3.so3_exp(_rand((16, 3), 6, 0.8)))
    s = np.linspace(0, 1, 16).astype(np.float32)
    _close(tse3.so3_interp(tt(Ra), tt(Rb), tt(s)), jse3.so3_interp(Ra, Rb, s))
    r, p, y = _rand((3, 16), 7, 0.5)
    _close(tse3.euler_zyx_to_mat(tt(r), tt(p), tt(y)),
           jse3.euler_zyx_to_mat(r, p, y))
    for a, b in zip(tse3.mat_to_euler_zyx(tt(Ra)), jse3.mat_to_euler_zyx(Ra)):
        _close(a, b)
    _close(tse3.rot_z(tt(y)), jse3.rot_z(y))
    E = Ra * (1 - 3e-3) + _rand((16, 3, 3), 8, 3e-4)
    _close(tse3.so3_project(tt(E)), jse3.so3_project(E))


def test_det_drift_over_long_compositions():
    """800 chained compositions with per-step so3_project stay on SO(3), as
    in the JAX package (tests/test_rotation_precision.py)."""
    steps = tse3.se3_exp(tt(_rand((800, 6), 9, 0.05)))
    T = tse3.Pose.identity()
    for k in range(800):
        T = tse3.compose(T, tse3.Pose(steps.R[k], steps.t[k]))
        T = tse3.Pose(tse3.so3_project(T.R), T.t)
    R = T.R.double()
    assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5
    assert float((R.T @ R - torch.eye(3, dtype=torch.float64)).abs().max()) \
        < 1e-5


def _spd(n, d, seed):
    A = _rand((n, d, d), seed)
    return (A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(d)).astype(np.float32)


def test_smallalg():
    A = _spd(64, 3, 10)
    b = _rand((64, 3), 11)
    _close(tsa.solve3(tt(A), tt(b)), jsa.solve3(A, b), rtol=1e-4, atol=1e-5)
    ev_t, V_t = tsa.eigh3x3(tt(A))
    ev_j, V_j = jsa.eigh3x3(A)
    _close(ev_t, ev_j, rtol=1e-5, atol=1e-5)
    # Eigenvectors up to sign: compare the projectors v vᵀ.
    for k in range(3):
        vt, vj = npy(V_t)[..., k], np.asarray(V_j)[..., k]
        np.testing.assert_allclose(vt[:, :, None] * vt[:, None, :],
                                   vj[:, :, None] * vj[:, None, :],
                                   rtol=1e-4, atol=1e-4)
    A6 = _spd(16, 6, 12)
    b6 = _rand((16, 6), 13)
    _close(tsa.solve6_spd(tt(A6), tt(b6)), jsa.solve6_spd(A6, b6),
           rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d,thresh", [(3, 10.0), (6, 100.0)])
def test_lm_solve_with_degeneracy(d, thresh):
    J = _rand((200, d), 14)
    J[:, -1] *= 0.01            # a weak direction that the clamp removes
    r = _rand((200,), 15)
    ok = np.random.RandomState(16).rand(200) > 0.2
    dt, degt = tlm.solve_normal_equations(
        tt(J), tt(r), tt(ok), 0.5, tlm.identity_degeneracy(d), True, thresh)
    dj, degj = jlm.solve_normal_equations(
        jnp.asarray(J), jnp.asarray(r), jnp.asarray(ok), 0.5,
        jlm.identity_degeneracy(d), True, thresh)
    assert bool(degt.is_degenerate) == bool(degj.is_degenerate)
    _close(degt.P, degj.P, rtol=1e-4, atol=1e-5)
    _close(dt, dj, rtol=1e-4, atol=1e-5)


def test_lm_geometry():
    p, t1, t2, t3 = (_rand((128, 3), s, 10.0) for s in (17, 18, 19, 20))
    for a, b in zip(tlm.point_to_plane(*map(tt, (p, t1, t2, t3))),
                    jlm.point_to_plane(p, t1, t2, t3)):
        _close(a, b, rtol=1e-5, atol=1e-4)
    for a, b in zip(tlm.point_to_line(*map(tt, (p, t1, t2))),
                    jlm.point_to_line(p, t1, t2)):
        _close(a, b, rtol=1e-5, atol=1e-4)
    # Neighbour sets: noisy planes and lines 60 m from the origin.
    base = _rand((128, 1, 3), 21, 1.0) + np.float32(60.0)
    plane = base + _rand((128, 5, 3), 22, 0.3) * np.array(
        [1, 1, 0.01], np.float32)
    n_t, d_t, off_t = tlm.fit_plane_lstsq(tt(plane))
    n_j, d_j, off_j = jlm.fit_plane_lstsq(plane)
    sign = np.sign(np.sum(npy(n_t) * np.asarray(n_j), axis=-1))[:, None]
    _close(npy(n_t) * sign, n_j, rtol=1e-4, atol=1e-4)
    _close(npy(d_t) * sign[:, 0], d_j, rtol=1e-4, atol=1e-3)
    # |n·x + d| at 60 m cancels to a few float32 ulps of 60 (~4e-6 each).
    _close(off_t, off_j, rtol=1e-3, atol=3e-5)
    line = base + _rand((128, 5, 1), 23, 0.5) * np.array(
        [1, 0.2, 0.1], np.float32) + _rand((128, 5, 3), 24, 0.01)
    c_t, v_t, e_t = tlm.pca_line(tt(line))
    c_j, v_j, e_j = jlm.pca_line(line)
    _close(c_t, c_j)
    _close(np.abs(npy(v_t)), np.abs(np.asarray(v_j)), rtol=1e-4, atol=1e-4)
    # The two small eigenvalues of a thin line's covariance come from
    # Cardano's arccos near ±1, accurate to ~sqrt(eps)·λmax in float32.
    _close(e_t[:, 2], np.asarray(e_j)[:, 2], rtol=1e-4, atol=1e-6)
    _close(e_t[:, :2], np.asarray(e_j)[:, :2], rtol=0, atol=1e-4)
