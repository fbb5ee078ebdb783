"""Loop closure: ``voxel_representative``, ``detect``, ICP and
``close_and_correct`` in the port against the JAX package on one drifted
keyframe store (tests/test_loopclosure.py's, built by the JAX package and
carried across), with that file's contracts on the port.

Tolerances: ``voxel_representative``, the candidate, ``closed`` and the
factor count are exact.  ICP poses agree to 1e-3 m / 1e-3 (rotation
entries), fitness to 1e-3 relative, correspondence counts to 0.5%: float32
sums taken in another order move a near-tie of the nearest-neighbour
search now and then (on this store 1.9e-4 m at convergence; a 10-iteration
run, not one of the cases, read 1.4e-3 m).
Corrected keyframe positions agree to 1e-3 m.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu.config import DEFAULT
from legoloam_tpu.models import loopclosure as jloop
from legoloam_tpu.models import mapping as jmap
from legoloam_tpu.models import posegraph as jpg
from legoloam_tpu.ops import icp as jicp
from legoloam_tpu.ops import voxel as jvox
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch.models import loopclosure as tloop
from legoloam_tpu_torch.models import posegraph as tpg
from legoloam_tpu_torch.ops import icp as ticp
from legoloam_tpu_torch.ops import voxel as tvox
from legoloam_tpu_torch.ops.se3 import Pose as TPose
from legoloam_tpu_torch.utils.interop import slam_state_from_numpy

from _torch_parity import npy, port_cfg, to_jax_tree, to_numpy_tree, tt

MAP_CFG = dataclasses.replace(
    DEFAULT.mapping, max_keyframes=32, scan_corner_cap=256, scan_surf_cap=2048,
    submap_corner_cap=4096, submap_surf_cap=8192)
LOOP_CFG = dataclasses.replace(DEFAULT.loop, enabled=True, cur_cap=2048,
                               hist_cap=16384)
# A soft chain lets one loop factor dominate a 12-node graph
# (tests/test_loopclosure.py).
SOFT_PG = dataclasses.replace(DEFAULT.posegraph, odom_rot_var=1e-3,
                              odom_trans_var=1e-2)
TRUE_LAST = np.array([0.0, 0.2, 0.8])


@functools.lru_cache(maxsize=None)
def drifted_store():
    """tests/test_loopclosure.py's store as numpy: 12 keyframes out and
    back, the last two stored with drift (the last 0.72 m off)."""
    scene = jsyn.default_scene()
    xs = [0, 2, 4, 6, 8, 8, 8, 6, 4, 2, 0.5, 0.0]
    ys = [0, 0, 0, 0, 0, 2, 4, 4, 4, 4, 2.0, 0.2]
    drift = np.zeros((12, 3), np.float32)
    drift[-1] = [0.6, 0.4, 0.0]
    drift[-2] = [0.45, 0.3, 0.0]
    kf = to_numpy_tree(jmap.init_state(MAP_CFG).kf)
    kf = kf._replace(**{f: getattr(kf, f).copy() for f in kf._fields})
    for k in range(12):
        pts, valid, _ = jsyn.raycast_scan(
            scene, Pose(jnp.eye(3), jnp.array([xs[k], ys[k], 0.8])),
            DEFAULT.sensor)
        c, c_ok = jvox.voxel_downsample(pts, valid, 0.2,
                                        MAP_CFG.scan_corner_cap)
        s, s_ok = jvox.voxel_downsample(pts, valid, 0.4,
                                        MAP_CFG.scan_surf_cap)
        t = np.array([xs[k], ys[k], 0.8], np.float32) + drift[k]
        kf.t[k] = t
        kf.time[k] = k * 4.0
        kf.chain_t[k] = t - (kf.t[k - 1] if k else 0.0)
        kf.corner[k], kf.corner_valid[k] = np.asarray(c), np.asarray(c_ok)
        kf.surf[k], kf.surf_valid[k] = np.asarray(s), np.asarray(s_ok)
    return kf._replace(count=np.int32(12))


def _both(kf_np):
    return to_jax_tree(kf_np), slam_state_from_numpy(kf_np, "cpu")


@pytest.mark.parametrize("case", ["history", "random"])
def test_voxel_representative_matches_jax(case):
    if case == "history":
        jkf, _ = _both(drifted_store())
        pts, val = (np.asarray(a) for a in jloop._world_cloud(jkf, 3))
        leaf, cap = 0.4, 2048
    else:
        rs = np.random.RandomState(5)
        pts = (rs.randn(20000, 3) * [20.0, 20.0, 2.0]).astype(np.float32)
        val = rs.rand(20000) > 0.1
        leaf, cap = 0.5, 4096
    jo, jok = jvox.voxel_representative(jnp.asarray(pts), jnp.asarray(val),
                                        leaf, cap)
    to, tok = tvox.voxel_representative(tt(pts), tt(val), leaf, cap)
    assert np.array_equal(npy(tok), np.asarray(jok))
    assert np.array_equal(npy(to), np.asarray(jo))
    assert 0 < int(tok.sum()) < cap


def test_detect_matches_jax():
    jkf, tkf = _both(drifted_store())
    tcfg = port_cfg(LOOP_CFG)
    cand = int(tloop.detect(tkf, tcfg))
    assert cand == int(jloop.detect(jkf, LOOP_CFG)) and cand in (0, 1, 2)
    for change in (dict(search_radius=0.01), dict(min_time_gap=1e6)):
        c = dataclasses.replace(LOOP_CFG, **change)
        assert int(tloop.detect(tkf, port_cfg(c))) == -1 \
            == int(jloop.detect(jkf, c))


@pytest.mark.parametrize("iters,eps", [(100, 1e-6), (3, 0.0)])
def test_icp_matches_jax(iters, eps):
    """Scan 11 onto the history cloud of the candidate: the eps-terminated
    run and a cap-terminated one (eps 0 never fires: ``converged`` False,
    ``has_converged`` True and the fitness under the threshold, as PCL's
    ``hasConverged()`` has it)."""
    jkf, tkf = _both(drifted_store())
    cfg = dataclasses.replace(LOOP_CFG, icp_max_iters=iters, icp_eps=eps)
    cand = int(jloop.detect(jkf, cfg))
    jsrc = jloop._world_cloud(jkf, 11)
    jdst = jloop._history_cloud(jkf, jnp.int32(cand), cfg)
    tsrc = tloop._world_cloud(tkf, 11)
    tdst = tloop._history_cloud(tkf, torch.tensor(cand), port_cfg(cfg))
    for a, b in zip(jdst + jsrc, tdst + tsrc):
        assert np.array_equal(npy(b), np.asarray(a))
    want = jicp.icp(*jsrc, *jdst, Pose.identity(), max_iters=iters, eps=eps,
                    max_corr_dist=cfg.icp_max_corr_dist)
    got = ticp.icp(*tsrc, *tdst, TPose.identity(), max_iters=iters, eps=eps,
                   max_corr_dist=cfg.icp_max_corr_dist)
    np.testing.assert_allclose(npy(got.pose.t), np.asarray(want.pose.t),
                               atol=1e-3)
    np.testing.assert_allclose(npy(got.pose.R), np.asarray(want.pose.R),
                               atol=1e-3)
    assert abs(float(got.fitness) / float(want.fitness) - 1) < 1e-3
    assert abs(int(got.n_corr) - int(want.n_corr)) <= 0.005 * int(
        want.n_corr)
    assert bool(got.has_converged) and bool(want.has_converged)
    assert bool(got.converged) == bool(want.converged) == (eps > 0)
    assert float(got.fitness) < cfg.fitness_thresh


def test_icp_with_no_correspondence_is_finite():
    """Empty source: zero weights give H = 0, the identity rotation, and no
    NaN."""
    _, tkf = _both(drifted_store())
    src, _ = tloop._world_cloud(tkf, 11)
    dst, dst_ok = tloop._world_cloud(tkf, 0)
    res = ticp.icp(src, torch.zeros(src.shape[0], dtype=torch.bool), dst,
                   dst_ok, TPose.identity(), max_iters=5)
    assert torch.isfinite(res.pose.R).all()
    assert torch.isfinite(res.pose.t).all()
    assert torch.equal(res.pose.R, torch.eye(3))
    assert int(res.n_corr) == 0 and not bool(res.has_converged)


def _close_both(kf_np, loop_cfg, pg_cfg):
    jkf, tkf = _both(kf_np)
    j = jloop.close_and_correct(jkf, jpg.init_loop_factors(8), loop_cfg,
                                pg_cfg)
    t = tloop.close_and_correct(tkf, tpg.init_loop_factors(8, "cpu"),
                                port_cfg(loop_cfg), port_cfg(pg_cfg))
    return tuple(to_numpy_tree(x) for x in j), t


@pytest.mark.parametrize("capped", [False, True])
def test_close_and_correct_matches_jax_and_fixes_drift(capped):
    """The drifted revisit closes in both packages (also with an ICP that
    always hits its 3-iteration cap), the revisit keyframe's error shrinks
    by more than half and the anchor stays put."""
    cfg = dataclasses.replace(LOOP_CFG, icp_max_iters=3, icp_eps=0.0) \
        if capped else LOOP_CFG
    kf = drifted_store()
    (jkf, jl, jcor, jdiag), (tkf, tl, tcor, tdiag) = _close_both(kf, cfg,
                                                                 SOFT_PG)
    assert bool(tdiag.closed) and bool(jdiag.closed)
    assert int(tdiag.candidate) == int(jdiag.candidate)
    assert int(tl.count) == int(jl.count) == 1
    assert (int(tl.i[0]), int(tl.j[0])) == (int(jl.i[0]), int(jl.j[0]))
    np.testing.assert_allclose(npy(tkf.t)[:12], jkf.t[:12], atol=1e-3)
    np.testing.assert_allclose(npy(tcor.t), jcor.t, atol=1e-3)
    err_before = np.linalg.norm(kf.t[11] - TRUE_LAST)
    err_after = np.linalg.norm(npy(tkf.t[11]) - TRUE_LAST)
    assert err_after < 0.5 * err_before, (err_before, err_after)
    np.testing.assert_allclose(npy(tkf.t[0]), [0.0, 0.0, 0.8], atol=0.05)


def test_no_false_closure_when_far():
    kf = drifted_store()
    kf = kf._replace(t=kf.t.copy())
    kf.t[11] = [500.0, 500.0, 0.8]
    (jkf, jl, _, jdiag), (tkf, tl, _, tdiag) = _close_both(
        kf, LOOP_CFG, DEFAULT.posegraph)
    assert not bool(tdiag.closed) and not bool(jdiag.closed)
    assert int(tdiag.candidate) == int(jdiag.candidate) == -1
    assert int(tl.count) == 0
    assert np.array_equal(npy(tkf.t), kf.t)
