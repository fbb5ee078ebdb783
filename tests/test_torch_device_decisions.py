"""The decisions the per-scan step keeps on the device, in the port against
the JAX package on the same numpy inputs: the submap cache's branch
(rebuild when stale, moved or more than a batch behind; fold; skip), the
scan-to-map LM unrolled with its freeze mask (the converged exit, the
residual-gate exit, a submap below ``min_*_map``), the keyframe insert at
a device-side index with the store full, and the CG of the pose graph and
the ICP in chunks of iterations.

Tolerances: the cache's branch, validity, counts, ``merged``, ``stale``
and the overflow count exact, centroids to 1e-5 m, the prune radius to
1e-6 m; the LM's pose to 1 mm / 0.01°, its iteration count exact and its
residual counts within 1% (float sums in another order move a gate now and
then); the full store exact; the chunked CG at tests/test_torch_posegraph
.py's bounds and the chunked ICP at tests/test_torch_loopclosure.py's, for
every chunk size.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu.config import DEFAULT
from legoloam_tpu.models import loopclosure as jloop
from legoloam_tpu.models import mapping as jmap
from legoloam_tpu.models import odometry as jodom
from legoloam_tpu.models import pipeline as jpipe
from legoloam_tpu.models import posegraph as jpg
from legoloam_tpu.ops import icp as jicp
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu_torch.models import loopclosure as tloop
from legoloam_tpu_torch.models import mapping as tmap
from legoloam_tpu_torch.models import posegraph as tpg
from legoloam_tpu_torch.ops import icp as ticp
from legoloam_tpu_torch.ops.se3 import Pose as TPose
from legoloam_tpu_torch.utils.interop import slam_state_from_numpy

from _torch_parity import (JCFG, TCFG, jax_run, npy, port_cfg, ring_scans,
                           rot_angle_deg, to_jax_tree, to_numpy_tree, tt)
from test_torch_loopclosure import LOOP_CFG, _both, drifted_store
from test_torch_posegraph import CFG as PG_CFG
from test_torch_posegraph import TCFG as PG_TCFG
from test_torch_posegraph import _graph

MAP = dataclasses.replace(
    DEFAULT.mapping, max_keyframes=32, scan_corner_cap=64, scan_surf_cap=128,
    submap_corner_cap=1024, submap_surf_cap=2048)
TMAP = port_cfg(MAP)


def fill_store(n):
    """A numpy store of ``n`` keyframes 1.5 m apart on a line (distinct
    position cells) with distinct random clouds."""
    rs = np.random.RandomState(0)
    kf = to_numpy_tree(jmap.init_state(MAP).kf)
    kf = kf._replace(**{f: getattr(kf, f).copy() for f in kf._fields})
    for k in range(n):
        kf.t[k] = [1.5 * k, 0.2 * k, 0.0]
        kf.time[k] = float(k)
        kf.corner[k] = rs.rand(MAP.scan_corner_cap, 3) * 4.0
        kf.surf[k] = rs.rand(MAP.scan_surf_cap, 3) * 4.0
        kf.corner_valid[k] = rs.rand(MAP.scan_corner_cap) < 0.8
        kf.surf_valid[k] = rs.rand(MAP.scan_surf_cap) < 0.8
    return kf._replace(count=np.int32(n))


# The cache after a rebuild at 12 keyframes, then (count, merged, stale,
# center shift) and the branch each case must take.
CACHE_CASES = {
    "stale": (20, 12, True, 0.0, tmap.REBUILD),
    "moved": (20, 12, False, MAP.submap_rebuild_dist + 1.0, tmap.REBUILD),
    "behind": (20, 11, False, 0.0, tmap.REBUILD),
    "fold": (20, 12, False, 0.0, tmap.FOLD),
    "young_fold": (14, 12, False, 0.0, tmap.FOLD),
    "skip": (20, 15, False, 0.0, tmap.SKIP),
}


@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_submap_cache_branch_matches_jax(case):
    count, merged, stale, shift, branch = CACHE_CASES[case]
    kf = fill_store(20)
    center = np.array([15.0, 2.0, 0.0], np.float32)
    state = jmap.init_state(MAP)
    cache = to_numpy_tree(jmap.update_submap_cache(
        state.cache, to_jax_tree(kf._replace(count=np.int32(12))),
        jnp.asarray(center), MAP))
    cache = cache._replace(merged=np.int32(merged), stale=np.array(stale))
    kf = kf._replace(count=np.int32(count))
    center = center + np.array([shift, 0.0, 0.0], np.float32)
    want = to_numpy_tree(jmap.update_submap_cache(
        to_jax_tree(cache), to_jax_tree(kf), jnp.asarray(center), MAP))
    t_cache = slam_state_from_numpy(cache, "cpu")
    t_kf = slam_state_from_numpy(kf, "cpu")
    t_center = tt(center)
    assert int(tmap.submap_decision(t_cache, t_kf, t_center, TMAP)) == branch
    got = tmap.update_submap_cache(t_cache, t_kf, t_center, TMAP)
    for pre in ("c", "s"):
        v = getattr(want, f"{pre}_valid")
        assert np.array_equal(npy(getattr(got, f"{pre}_valid")), v), pre
        assert np.array_equal(npy(getattr(got, f"{pre}_cnt")),
                              getattr(want, f"{pre}_cnt")), pre
        np.testing.assert_allclose(npy(getattr(got, f"{pre}_pts"))[v],
                                   getattr(want, f"{pre}_pts")[v], atol=1e-5)
    assert int(got.merged) == int(want.merged)
    assert bool(got.stale) == bool(want.stale) is False
    assert int(got.voxel_overflow) == int(want.voxel_overflow)
    np.testing.assert_allclose(npy(got.origin), want.origin, atol=1e-6)
    np.testing.assert_allclose(float(got.prune_r), float(want.prune_r),
                               atol=1e-6)


def _lm_inputs():
    """Scan 3's downsampled clouds, its guess and the submap of the state
    after scans 0-2 (numpy), through the port's mapping_prepare."""
    states, _ = jax_run(4)
    scans, _ = ring_scans(4)
    feats = jpipe.process_scan(*scans[3], JCFG)
    odom, pose, _ = jodom.odometry_step(to_jax_tree(states[2].odom), feats,
                                        JCFG.odom)
    odom, pose = to_numpy_tree(odom), to_numpy_tree(pose)
    mstate = slam_state_from_numpy(states[2].mapping, "cpu")
    prep = tmap.mapping_prepare(
        mstate, *(slam_state_from_numpy(c, "cpu") for c in (
            odom.last_corner, odom.last_surf, odom.last_outlier)),
        slam_state_from_numpy(pose, "cpu"), TCFG.mapping)
    cache = tmap.update_submap_cache(mstate.cache, mstate.kf, prep.guess.t,
                                     TCFG.mapping)
    return [npy(a) for a in (
        prep.guess.R, prep.guess.t, prep.c_pts, prep.c_ok, prep.s_pts,
        prep.s_ok, cache.c_pts, cache.c_valid, cache.s_pts, cache.s_valid)]


@pytest.mark.parametrize("case", ["converged", "residual_gate", "empty_map"])
def test_scan_to_map_matches_jax(case):
    change = {"converged": {}, "residual_gate": {"min_residuals": 10 ** 9},
              "empty_map": {"min_corner_map": 10 ** 9}}[case]
    jcfg = dataclasses.replace(JCFG.mapping, **change)
    a = _lm_inputs()
    jT, ji, jnc, jns = jmap.scan_to_map(
        Pose(jnp.asarray(a[0]), jnp.asarray(a[1])),
        *(jnp.asarray(x) for x in a[2:]), jcfg)
    tT, ti, tnc, tns = tmap.scan_to_map(
        TPose(tt(a[0]), tt(a[1])), *(tt(x) for x in a[2:]), port_cfg(jcfg))
    assert int(ti) == int(ji)
    assert int(ti) == {"converged": int(ti), "residual_gate": 1,
                       "empty_map": 0}[case]
    if case == "converged":
        assert 1 < int(ti) < jcfg.max_iterations
    for g, w in ((tnc, jnc), (tns, jns)):
        assert abs(int(g) - int(w)) <= max(2, 0.01 * int(w))
    assert np.abs(npy(tT.t) - np.asarray(jT.t)).max() < 1e-3
    assert rot_angle_deg(npy(tT.R), jT.R) < 0.01
    if case != "converged":
        np.testing.assert_array_equal(npy(tT.t), a[1])


def test_keyframe_insert_full_store_matches_jax():
    """A keyframe warranted with the store full: overflow +1, count and
    every row of the store unchanged, in both packages."""
    small = dataclasses.replace(MAP, max_keyframes=16)
    kf = fill_store(16)._replace(**{
        f: getattr(fill_store(16), f)[:16] for f in (
            "R", "t", "time", "chain_R", "chain_t", "corner", "corner_valid",
            "surf", "surf_valid")})
    state = to_numpy_tree(jmap.init_state(small))._replace(
        kf=kf, initialized=np.array(True))
    rs = np.random.RandomState(1)

    def cloud(n):
        return (rs.rand(n, 3).astype(np.float32) * 4.0 + 20.0,
                np.zeros(n, np.float32), np.zeros(n, np.float32),
                np.ones(n, bool))

    clouds = [cloud(n) for n in (64, 128, 64)]
    far = (np.eye(3, dtype=np.float32), np.array([100.0, 0.0, 0.0],
                                                 np.float32))
    jstate, _, jdiag = jmap.mapping_step(
        to_jax_tree(state), *(jodom.FeatureCloud(*map(jnp.asarray, c))
                              for c in clouds),
        Pose(*map(jnp.asarray, far)), jnp.float32(99.0), small)
    jstate = to_numpy_tree(jstate)
    from legoloam_tpu_torch.ops.features import FeatureCloud
    tstate, _, tdiag = tmap.mapping_step(
        slam_state_from_numpy(state, "cpu"),
        *(FeatureCloud(*map(tt, c)) for c in clouds), TPose(*map(tt, far)),
        99.0, port_cfg(small))
    assert bool(tdiag.kf_overflow) == bool(jdiag.kf_overflow) is True
    assert bool(tdiag.new_keyframe) == bool(jdiag.new_keyframe) is False
    assert int(tstate.kf.count) == int(jstate.kf.count) == 16
    assert int(tstate.kf.overflow) == int(jstate.kf.overflow) == 1
    for f in ("R", "t", "time", "chain_R", "chain_t", "corner",
              "corner_valid", "surf", "surf_valid"):
        assert np.array_equal(npy(getattr(tstate.kf, f)),
                              getattr(jstate.kf, f)), f
        assert np.array_equal(npy(getattr(tstate.kf, f)), getattr(kf, f)), f


@pytest.mark.parametrize("chunk", [1, 3, 512])
@pytest.mark.parametrize("kind", ["square_loop", "two_loops"])
def test_chunked_pcg_matches_jax(kind, chunk):
    R, t, n, cR, ct, loops, prior = _graph(kind)
    jl, tl = jpg.init_loop_factors(8), tpg.init_loop_factors(8)
    for i, j, ZR, Zt, var in loops:
        jl = jpg.add_loop_factor(jl, i, j, Pose(jnp.asarray(ZR),
                                                jnp.asarray(Zt)),
                                 jnp.float32(var))
        tl = tpg.add_loop_factor(tl, i, j, TPose(tt(ZR), tt(Zt)), var)
    jR, jt = jpg.optimize(jnp.asarray(R), jnp.asarray(t), jnp.int32(n),
                          jnp.asarray(cR), jnp.asarray(ct), jl,
                          Pose(*map(jnp.asarray, prior)), PG_CFG)
    tR, tT = tpg.optimize(tt(R), tt(t), torch.tensor(n, dtype=torch.int32),
                          tt(cR), tt(ct), tl, TPose(*map(tt, prior)),
                          PG_TCFG, chunk=chunk)
    np.testing.assert_allclose(npy(tT), np.asarray(jt), atol=5e-5)
    np.testing.assert_allclose(npy(tR), np.asarray(jR), atol=1e-5)


@pytest.mark.parametrize("chunk", [1, 7, 64])
@pytest.mark.parametrize("iters,eps", [(100, 1e-6), (3, 0.0)])
def test_chunked_icp_matches_jax(iters, eps, chunk):
    """The eps-terminated run and the cap-terminated one
    (test_loopclosure.py::test_cap_terminated_icp_accepted: eps 0 never
    fires, yet PCL's ``hasConverged()`` holds)."""
    jkf, tkf = _both(drifted_store())
    cfg = dataclasses.replace(LOOP_CFG, icp_max_iters=iters, icp_eps=eps)
    cand = int(jloop.detect(jkf, cfg))
    jsrc = jloop._world_cloud(jkf, 11)
    jdst = jloop._history_cloud(jkf, jnp.int32(cand), cfg)
    tsrc = tloop._world_cloud(tkf, 11)
    tdst = tloop._history_cloud(tkf, torch.tensor(cand), port_cfg(cfg))
    want = jicp.icp(*jsrc, *jdst, Pose.identity(), max_iters=iters, eps=eps,
                    max_corr_dist=cfg.icp_max_corr_dist)
    got = ticp.icp(*tsrc, *tdst, TPose.identity(), max_iters=iters, eps=eps,
                   max_corr_dist=cfg.icp_max_corr_dist, chunk=chunk)
    np.testing.assert_allclose(npy(got.pose.t), np.asarray(want.pose.t),
                               atol=1e-3)
    np.testing.assert_allclose(npy(got.pose.R), np.asarray(want.pose.R),
                               atol=1e-3)
    assert abs(float(got.fitness) / float(want.fitness) - 1) < 1e-3
    assert bool(got.has_converged) and bool(want.has_converged)
    assert bool(got.converged) == bool(want.converged) == (eps > 0)
    if eps == 0.0:
        assert int(got.iters) == iters
    assert float(got.fitness) < cfg.fitness_thresh
