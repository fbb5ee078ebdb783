"""The link-space pose-graph solver and the loop-factor store: the port
against the JAX package on the same numpy graphs, and the contracts of
tests/test_posegraph.py on the port.

Tolerance: optimised positions within 5e-5 m and rotation entries within
1e-5 of the JAX package's (eight GN steps of float32 CG whose sums the two
packages take in different orders; the port's range sums are a matrix
product where JAX scatter-adds and takes a cumulative sum).  The factor store is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu.config import PoseGraphConfig
from legoloam_tpu.models import posegraph as jpg
from legoloam_tpu.ops import se3 as jse3
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu_torch.models import posegraph as tpg
from legoloam_tpu_torch.ops.se3 import Pose as TPose

from _torch_parity import npy, port_cfg, to_numpy_tree, tt

CFG = PoseGraphConfig()
TCFG = port_cfg(CFG)
M = 32  # node capacity


def _chain(meas_R, meas_t, n):
    R = [np.eye(3, dtype=np.float32)]
    t = [np.zeros(3, np.float32)]
    for k in range(1, n):
        R.append(R[-1] @ meas_R[k])
        t.append(R[-2] @ meas_t[k] + t[-1])
    return np.stack(R), np.stack(t)


def _pad(a, n, fill):
    out = np.broadcast_to(fill, (M,) + fill.shape).copy()
    out[:n] = a
    return out


def _graph(kind):
    """(R, t, n, chain_R, chain_t, loop list, prior) as numpy arrays."""
    rs = np.random.RandomState(0)
    eye, z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    loops = []
    if kind == "fixed_point":
        n = 10
        meas_R = [eye] + [np.asarray(jse3.so3_exp(jnp.asarray(
            0.1 * rs.randn(3), jnp.float32))) for _ in range(1, n)]
        meas_t = [z3] + [np.array([1.0, 0.1, 0.0], np.float32)] * (n - 1)
        R0, t0 = _chain(meas_R, meas_t, n)
    elif kind == "perturbed":
        n = 8
        meas_R = [eye] * n
        meas_t = [z3] + [np.array([1.0, 0.0, 0.0], np.float32)] * (n - 1)
        R0, t0 = _chain(meas_R, meas_t, n)
        t0 = t0 + (0.3 * rs.randn(n, 3)).astype(np.float32)
        t0[0] = 0.0
    elif kind in ("square_loop", "two_loops"):
        n = 21
        meas_R, meas_t = [eye], [z3]
        for k in range(1, n):
            turn = np.pi / 2 if k % 5 == 0 else 0.0
            meas_R.append(np.asarray(jse3.rot_z(jnp.float32(turn + 0.03))))
            meas_t.append(np.array([2.0, 0.0, 0.0], np.float32))
        R0, t0 = _chain(meas_R, meas_t, n)
        loops.append((0, n - 1, eye, z3, 1e-6))
        if kind == "two_loops":
            loops.append((15, 4, eye, np.array([0.5, 0.0, 0.0], np.float32),
                          1e-3))
    else:  # empty
        n = 1
        meas_R, meas_t = [eye] * 2, [z3] * 2
        R0, t0 = eye[None], z3[None]
    return (_pad(R0, n, eye), _pad(t0, n, z3), n,
            _pad(np.stack(meas_R)[:n], n, eye),
            _pad(np.stack(meas_t)[:n], n, z3), loops, (R0[0], t0[0]))


def _solve_both(kind, cap=8):
    R, t, n, cR, ct, loops, prior = _graph(kind)
    jl, tl = jpg.init_loop_factors(cap), tpg.init_loop_factors(cap)
    for i, j, ZR, Zt, var in loops:
        jl = jpg.add_loop_factor(jl, i, j, Pose(jnp.asarray(ZR),
                                                jnp.asarray(Zt)),
                                 jnp.float32(var))
        tl = tpg.add_loop_factor(tl, i, j, TPose(tt(ZR), tt(Zt)), var)
    jR, jt = jpg.optimize(jnp.asarray(R), jnp.asarray(t), jnp.int32(n),
                          jnp.asarray(cR), jnp.asarray(ct), jl,
                          Pose(*map(jnp.asarray, prior)), CFG)
    tR, tT = tpg.optimize(tt(R), tt(t), torch.tensor(n, dtype=torch.int32),
                          tt(cR), tt(ct), tl, TPose(*map(tt, prior)), TCFG)
    return (np.asarray(jR), np.asarray(jt)), (npy(tR), npy(tT)), (R, t, n)


@pytest.mark.parametrize("kind", ["fixed_point", "perturbed", "square_loop",
                                  "two_loops", "empty"])
def test_optimize_matches_jax(kind):
    (jR, jt), (tR, tT), _ = _solve_both(kind)
    assert np.isfinite(tR).all() and np.isfinite(tT).all()
    np.testing.assert_allclose(tT, jt, atol=5e-5)
    np.testing.assert_allclose(tR, jR, atol=1e-5)


def test_consistent_chain_is_fixed_point():
    _, (tR, tT), (R, t, n) = _solve_both("fixed_point")
    np.testing.assert_allclose(tT[:n], t[:n], atol=1e-3)
    np.testing.assert_allclose(tR[:n], R[:n], atol=1e-3)


def test_perturbed_init_recovers_chain():
    _, (_, tT), (_, _, n) = _solve_both("perturbed")
    np.testing.assert_allclose(tT[:n], np.stack(
        [[k, 0.0, 0.0] for k in range(n)]), atol=5e-3)


def test_loop_closure_distributes_drift():
    """Square loop with 0.03 rad of yaw drift per edge: a tight loop factor
    with the true relative pose pulls the end back to the start, and the
    start stays anchored."""
    _, (_, tT), (_, t, n) = _solve_both("square_loop")
    drift_err = np.linalg.norm(t[n - 1])
    assert drift_err > 0.5
    assert np.linalg.norm(tT[n - 1]) < 0.1 * drift_err
    assert np.linalg.norm(tT[0]) < 1e-2


def test_optimize_empty_graph_is_noop():
    _, (_, tT), _ = _solve_both("empty", cap=4)
    assert np.isfinite(tT).all()
    np.testing.assert_allclose(tT[0], 0.0, atol=1e-4)


def test_loop_factor_store_matches_jax():
    """Appends, the cap and the ``dropped`` count, field for field."""
    jl, tl = jpg.init_loop_factors(2), tpg.init_loop_factors(2)
    for k in range(4):
        Z = jse3.se3_exp(jnp.asarray([0.0, 0.0, 0.1 * k, k, 0.0, 0.0],
                                     jnp.float32))
        jl = jpg.add_loop_factor(jl, k, k + 1, Z, jnp.float32(0.1 + k))
        tl = tpg.add_loop_factor(tl, k, k + 1, TPose(tt(Z.R), tt(Z.t)),
                                 0.1 + k)
    for name, a, b in zip(jl._fields, to_numpy_tree(jl), tl):
        assert np.array_equal(npy(b), np.asarray(a)), name
    assert int(tl.count) == 2 and int(tl.dropped) == 2


def test_adjoint_and_residual_match_jax():
    rs = np.random.RandomState(3)
    xi = rs.randn(4, 6).astype(np.float32)
    p = jse3.se3_exp(jnp.asarray(xi))
    q = jse3.se3_exp(jnp.asarray(xi[::-1].copy()))
    z = jse3.se3_exp(jnp.asarray(0.1 * xi))
    tp, tq, tz = (TPose(tt(a.R), tt(a.t)) for a in (p, q, z))
    np.testing.assert_allclose(npy(tpg._adjoint(tp)),
                               np.asarray(jpg._adjoint(p)), atol=1e-5)
    np.testing.assert_allclose(npy(tpg._between_residual(tp, tq, tz)),
                               np.asarray(jpg._between_residual(p, q, z)),
                               atol=1e-4)

