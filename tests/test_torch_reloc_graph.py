"""Relocalization as one program (``models/relocalize.py``): the body
through ``StaticRunner`` (the CUDA graph runner's dataflow, each chain run
again as plain calls) against the eager body, both against the JAX
package's ``relocalize`` on tests/test_torch_relocalize.py's 15-scan map
and small configuration, with the refine ICP in chunks of ``icp.CHUNK``
and of 1 iteration (the same per-iteration loop, other reads).

Tolerances: the static path equals the eager body bitwise; against the
JAX package, tests/test_torch_relocalize.py's (acceptance and the
candidate count exact, the pose within 1e-2 m and 0.1°, the fitness 5%
relative); the heading-batched ICP against one ICP per heading: the same
iterations and hasConverged, poses within 1e-6 m, fitness within 1e-6
relative.  A ``TorchDispatchMode`` (tests/test_torch_step_graph.py's)
counts the host reads: they equal the runner's, at most
``refine_top_k x ceil(icp_max_iters / chunk)``, none in the candidate
selection and the coarse stage.  The small configuration's 8 candidates exceed the map's 3
occupied cells, so the out-of-range hypotheses run too.
"""

import functools
import math

import jax
import numpy as np
import pytest
import torch

from legoloam_tpu.models import pipeline as jpipe
from legoloam_tpu.models import relocalize as jreloc
from legoloam_tpu.ops import se3 as jse3
from legoloam_tpu.ops.se3 import Pose as JPose
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch.models import pipeline as tpipe
from legoloam_tpu_torch.models import relocalize as treloc
from legoloam_tpu_torch.models import step_graph
from legoloam_tpu_torch.ops import icp, knn_cuda, se3
from legoloam_tpu_torch.ops.se3 import Pose
from legoloam_tpu_torch.ops.segments import Eager, leaves
from legoloam_tpu_torch.utils.interop import slam_state_from_numpy

from _torch_parity import npy, rot_angle_deg, to_jax_tree
from test_torch_relocalize import CFG, TCFG, mapped_session
from test_torch_step_graph import HostReads

CHUNKS = (icp.CHUNK, 1)


@functools.lru_cache(maxsize=None)
def _scan():
    """Session 2's first scan: taken at rest at session 1's pose 4."""
    _, poses = mapped_session()
    return tuple(np.asarray(a) for a in jsyn.raycast_scan(
        jsyn.default_scene(), JPose(poses.R[4], poses.t[4]), CFG.sensor))


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX package's session 2: the same scan on the same map, then
    ``relocalize_slam_state``."""
    s1, _ = mapped_session()
    jst = jpipe.init_slam_state(CFG)._replace(
        mapping=to_jax_tree(s1.mapping), loops=to_jax_tree(s1.loops))
    jst, _ = jpipe.slam_scan_step(jst, *_scan(), CFG, 100.0,
                                  run_mapping=False)
    return jax.tree.map(np.asarray, jreloc.relocalize_slam_state(jst, CFG))


@functools.lru_cache(maxsize=None)
def _booted():
    """The port's state on session 1's map after session 2's first scan
    (fresh odometry, the belief still at session 1's end)."""
    s1, _ = mapped_session()
    st = tpipe.init_slam_state(TCFG, device="cpu")._replace(
        mapping=slam_state_from_numpy(s1.mapping, "cpu"),
        loops=slam_state_from_numpy(s1.loops, "cpu"))
    st, _ = tpipe.slam_scan_step(st, *(np.array(a) for a in _scan()),
                                 TCFG, 100.0, run_mapping=False)
    return st


def _reloc(rt, chunk=treloc.REFINE_CHUNK):
    """``relocalize_slam_state`` through ``rt`` with the refine ICP in
    chunks of ``chunk``; returns (state, diag)."""
    old = treloc.REFINE_CHUNK
    treloc.REFINE_CHUNK = chunk
    try:
        return treloc.relocalize_slam_state(_booted(), TCFG, rt=rt)
    finally:
        treloc.REFINE_CHUNK = old


@functools.lru_cache(maxsize=None)
def _eager():
    """The eager body."""
    return _reloc(Eager())


@functools.lru_cache(maxsize=None)
def _static(chunk):
    """Through ``StaticRunner`` with the host reads counted by a
    ``TorchDispatchMode`` (the plain k-NN's own left out: on the card it
    is kernel K3): (state, diag, runner, reads counted)."""
    m = HostReads()
    plain = knn_cuda.knn_plain

    def counted_out(*a, **k):
        m.plain += 1
        try:
            return plain(*a, **k)
        finally:
            m.plain -= 1

    knn_cuda.knn_plain = counted_out
    srt = step_graph.StaticRunner()
    try:
        with m:
            st, diag = _reloc(srt, chunk)
    finally:
        knn_cuda.knn_plain = plain
    return st, diag, srt, m.reads


@pytest.mark.parametrize("chunk", CHUNKS)
def test_static_path_matches_eager_and_jax(chunk):
    est, ediag = _eager()
    sst, sdiag, srt, reads = _static(chunk)
    assert all(torch.equal(a, b) for a, b in zip(leaves(sdiag),
                                                  leaves(ediag)))
    assert all(torch.equal(a, b) for a, b in zip(leaves(sst.mapping),
                                                  leaves(est.mapping)))
    # The reads: the runner's own, the refine ICP's stop flags only.
    assert reads == srt.reads
    k_ref = min(TCFG.reloc.refine_top_k,
                TCFG.reloc.n_candidates * TCFG.reloc.yaw_hypotheses)
    assert k_ref <= srt.reads <= k_ref * math.ceil(
        TCFG.reloc.icp_max_iters / chunk)
    # The coarse body was replayed, not run again eagerly.
    assert srt.replays >= TCFG.reloc.n_candidates - 2
    jst, jdiag = _jax()
    assert bool(sdiag.accepted) and bool(jdiag.accepted)
    assert int(sdiag.n_candidates) == int(jdiag.n_candidates)
    assert abs(float(sdiag.fitness) / float(jdiag.fitness) - 1) < 0.05
    t_aft = sst.mapping.t_aft
    np.testing.assert_allclose(npy(t_aft.t), jst.mapping.t_aft.t, atol=1e-2)
    assert rot_angle_deg(npy(t_aft.R), jst.mapping.t_aft.R) < 0.1
    _, poses = mapped_session()
    gt = jse3.relative(JPose(poses.R[0], poses.t[0]),
                       JPose(poses.R[4], poses.t[4]))
    assert float(np.linalg.norm(npy(t_aft.t) - np.asarray(gt.t))) < 0.5


def test_heading_batched_icp_matches_one_icp_per_heading():
    """One candidate's headings as one batched ICP (one k-NN search of
    n_yaw x cur_cap queries an iteration) against each heading's ICP
    alone, at the coarse and the full depth."""
    st = _booted()
    rc = TCFG.reloc
    kf = st.mapping.kf
    od = st.odom
    s = treloc._search(kf, torch.cat([od.last_corner.xyz, od.last_surf.xyz]),
                       torch.cat([od.last_corner.valid, od.last_surf.valid]),
                       st.mapping.t_aft, rc)
    idx = s.cand[0]
    hist, hist_val = treloc._window(kf, idx, rc)
    n_yaw = rc.yaw_hypotheses
    yaws = torch.arange(n_yaw) * (2.0 * math.pi / n_yaw)
    R = se3.so3_exp(yaws[:, None] * torch.tensor([0.0, 0.0, 1.0])) \
        @ kf.R[idx]
    T_h = Pose(R, kf.t[idx].expand(n_yaw, 3))
    src = se3.transform_points(T_h, s.pts.expand(n_yaw, *s.pts.shape))
    src_val = s.val.expand(n_yaw, *s.val.shape)
    frozen = torch.tensor([False, False, True, False])[:n_yaw]
    corr = rc.icp_max_corr_dist ** 2
    for iters in (rc.coarse_iters, rc.icp_max_iters):
        bst = icp.icp_iterate(
            icp.icp_start(Pose.identity((n_yaw,)), frozen, iters), src,
            src_val, hist, hist_val, iters, iters, rc.icp_eps, corr)
        bres = icp.icp_result(bst, src, src_val, hist, hist_val, corr)
        for h in range(n_yaw):
            one = icp.icp_iterate(
                icp.icp_start(Pose.identity(), frozen[h], iters), src[h],
                src_val[h], hist, hist_val, iters, iters, rc.icp_eps, corr)
            res = icp.icp_result(one, src[h], src_val[h], hist, hist_val,
                                 corr)
            assert int(bres.iters[h]) == int(res.iters)
            assert bool(bres.has_converged[h]) == bool(res.has_converged)
            assert float((bres.pose.t[h] - res.pose.t).abs().max()) < 1e-6
            assert float((bres.pose.R[h] - res.pose.R).abs().max()) < 1e-6
            assert abs(float(bres.fitness[h]) - float(res.fitness)) \
                <= 1e-6 * abs(float(res.fitness))
        assert int(bres.iters[2]) == 0 and int(bres.iters.max()) > 0


def test_out_of_range_candidates_get_an_infinite_fitness():
    """``n_candidates`` (8) above the map's occupied cells (3): the extra
    candidates' hypotheses run frozen with an infinite fitness, as in JAX
    (the same candidate count and acceptance), and the search still
    lands."""
    _, diag, srt, _ = _static(icp.CHUNK)
    (s,) = [out for (key, _), (_, out) in srt.segs.items()
            if key[:2] == ("reloc", "search")]
    rc = TCFG.reloc
    n_ok = int(s.cand_ok.sum())
    assert 0 < n_ok < rc.n_candidates and bool(s.cand_ok[:n_ok].all())
    fits = s.fits.reshape(rc.n_candidates, rc.yaw_hypotheses)
    assert bool(torch.isinf(fits[n_ok:]).all())
    assert bool(torch.isfinite(fits[:n_ok]).any())
    _, jdiag = _jax()
    assert int(diag.n_candidates) == int(jdiag.n_candidates) == n_ok
    assert bool(diag.accepted) == bool(jdiag.accepted)
