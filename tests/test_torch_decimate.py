"""Keyframe-store saturation: the overflow count, ``decimate_keyframes``
and ``maybe_decimate``, in the port against the JAX package on the same
numpy store and loop factors, with tests/test_decimate.py's contracts on
the port.

Tolerances: counts, kept indices, validity, loop endpoints and ``dropped``
are exact, and so are the moved clouds and times; re-derived chain
measurements and remapped loop measurements agree to 1e-5, the survivors'
poses are copied exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu.config import DEFAULT
from legoloam_tpu.models import mapping as jmap
from legoloam_tpu.models import posegraph as jpg
from legoloam_tpu.ops import se3 as jse3
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu_torch.models import mapping as tmap
from legoloam_tpu_torch.models import pipeline as tpipe
from legoloam_tpu_torch.models import posegraph as tpg
from legoloam_tpu_torch.ops import se3 as tse3
from legoloam_tpu_torch.ops.features import FeatureCloud
from legoloam_tpu_torch.ops.se3 import Pose as TPose
from legoloam_tpu_torch.utils.interop import slam_state_from_numpy

from _torch_parity import npy, port_cfg, to_jax_tree, to_numpy_tree, tt

SMALL = dataclasses.replace(
    DEFAULT.mapping, max_keyframes=16, scan_corner_cap=64, scan_surf_cap=128,
    submap_corner_cap=1024, submap_surf_cap=2048, decimate_keep_recent=4)
TSMALL = port_cfg(SMALL)
# (i, j, variance): two dropped nodes, a collapsing pair, two survivors,
# a factor into the recent window.
LOOPS = [(3, 9, 0.01), (2, 3, 0.01), (0, 14, 0.02), (5, 12, 0.05)]


def fill_store(n, rotate=False):
    """A numpy store: line trajectory with distinct random clouds, chain =
    the true relatives (with small random attitudes when ``rotate``)."""
    rs = np.random.RandomState(0)
    kf = to_numpy_tree(jmap.init_state(SMALL).kf)
    kf = kf._replace(**{f: getattr(kf, f).copy() for f in kf._fields})
    for k in range(n):
        R = np.asarray(jse3.so3_exp(jnp.asarray(
            0.05 * rs.randn(3), jnp.float32))) if rotate else np.eye(3)
        t = np.array([k * 1.0, 0.1 * k, 0.0], np.float32)
        kf.R[k], kf.t[k], kf.time[k] = R, t, float(k)
        prev = (kf.R[k - 1], kf.t[k - 1]) if k else (np.eye(3), np.zeros(3))
        kf.chain_R[k] = prev[0].T @ R
        kf.chain_t[k] = prev[0].T @ (t - prev[1])
        kf.corner[k] = rs.rand(SMALL.scan_corner_cap, 3) * 2.0
        kf.surf[k] = rs.rand(SMALL.scan_surf_cap, 3) * 2.0
        kf.corner_valid[k] = kf.surf_valid[k] = True
    return kf._replace(count=np.int32(n))


def _loops_both(kf, factors, cap=8):
    jl, tl = jpg.init_loop_factors(cap), tpg.init_loop_factors(cap)
    for i, j, var in factors:
        Z = jse3.compose(jse3.relative(Pose(kf.R[i], kf.t[i]),
                                       Pose(kf.R[j], kf.t[j])),
                         jse3.se3_exp(jnp.asarray([0.0, 0.0, 0.02, 0.1,
                                                   -0.05, 0.0])))
        jl = jpg.add_loop_factor(jl, i, j, Z, jnp.float32(var))
        tl = tpg.add_loop_factor(tl, i, j, TPose(tt(Z.R), tt(Z.t)), var)
    return jl, tl


def _decimate_both(n=16, factors=LOOPS, rotate=True, keep_recent=4):
    kf = fill_store(n, rotate)
    jl, tl = _loops_both(kf, factors)
    jkf, jl2 = jmap.decimate_keyframes(to_jax_tree(kf), jl,
                                       keep_recent=keep_recent)
    tkf, tl2 = tmap.decimate_keyframes(slam_state_from_numpy(kf, "cpu"), tl,
                                       keep_recent=keep_recent)
    return kf, to_numpy_tree(jkf), to_numpy_tree(jl2), tkf, tl2


@pytest.mark.parametrize("n,keep_recent", [(16, 4), (13, 4), (16, 32),
                                           (1, 4)])
def test_decimate_matches_jax(n, keep_recent):
    _, jkf, jl, tkf, tl = _decimate_both(n, keep_recent=keep_recent)
    exact = ("R", "t", "time", "corner", "corner_valid", "surf",
             "surf_valid", "count", "overflow")
    for f in exact:
        assert np.array_equal(npy(getattr(tkf, f)), getattr(jkf, f)), f
    for f in ("chain_R", "chain_t"):
        np.testing.assert_allclose(npy(getattr(tkf, f)), getattr(jkf, f),
                                   atol=1e-5, err_msg=f)
    for f in ("i", "j", "valid", "count", "dropped", "var"):
        assert np.array_equal(npy(getattr(tl, f)), getattr(jl, f)), f
    for f in ("R", "t"):
        np.testing.assert_allclose(npy(getattr(tl, f)), getattr(jl, f),
                                   atol=1e-5, err_msg=f)


def test_decimate_halves_and_keeps_anchor_and_recent():
    kf, _, _, tkf, _ = _decimate_both(rotate=False)
    # keep: 12..15 (recent) + the even ones of 0..11 -> 6 + 4 = 10
    assert int(tkf.count) == 10
    assert np.array_equal(npy(tkf.t[0]), kf.t[0])
    assert np.array_equal(npy(tkf.t[9]), kf.t[15])
    assert npy(tkf.time[:10]).tolist() == [0, 2, 4, 6, 8, 10, 12, 13, 14, 15]
    assert np.array_equal(npy(tkf.corner[1]), kf.corner[2])
    assert not bool(tkf.corner_valid[10:].any())


def test_decimate_chain_reconstructs_poses():
    """Composing the re-derived chain from the anchor reproduces every
    surviving pose."""
    _, _, _, tkf, _ = _decimate_both()
    T = TPose(tkf.R[0], tkf.t[0])
    for s in range(1, int(tkf.count)):
        T = tse3.compose(T, TPose(tkf.chain_R[s], tkf.chain_t[s]))
        np.testing.assert_allclose(npy(T.t), npy(tkf.t[s]), atol=1e-5)


def test_decimate_loop_factor_remap_preserves_constraint():
    """A factor between two dropped nodes (3 -> anchor 2, new slot 1;
    9 -> anchor 8, new slot 4) carries its error over by conjugation:
    E' = O_j⁻¹ E O_j with O_j = T_j⁻¹ T_aj."""
    kf, _, _, tkf, tl = _decimate_both(factors=[(3, 9, 0.01)])
    ni, nj = int(tl.i[0]), int(tl.j[0])
    assert bool(tl.valid[0]) and (ni, nj) == (1, 4)
    P = [TPose(tt(kf.R[k]), tt(kf.t[k])) for k in range(16)]
    _, tl0 = _loops_both(kf, [(3, 9, 0.01)])
    Z = TPose(tl0.R[0], tl0.t[0])
    E = tse3.compose(tse3.inverse(Z), tse3.relative(P[3], P[9]))
    O = tse3.relative(P[9], P[8])
    want = tse3.compose(tse3.inverse(O), tse3.compose(E, O))
    got = tse3.compose(tse3.inverse(TPose(tl.R[0], tl.t[0])),
                       tse3.relative(TPose(tkf.R[ni], tkf.t[ni]),
                                     TPose(tkf.R[nj], tkf.t[nj])))
    np.testing.assert_allclose(npy(got.t), npy(want.t), atol=1e-5)
    np.testing.assert_allclose(npy(got.R), npy(want.R), atol=1e-5)


def test_decimate_collapsed_factor_dropped_and_counted():
    _, _, _, _, tl = _decimate_both(factors=[(2, 3, 0.01)])
    assert not bool(tl.valid[0]) and int(tl.dropped) == 1


def test_overflow_counted_not_silent():
    """A keyframe warranted while the store is full is counted in
    ``overflow`` and flagged in the diag."""
    st = tmap.init_state(TSMALL, "cpu")
    st = st._replace(kf=slam_state_from_numpy(fill_store(16), "cpu"),
                     initialized=torch.tensor(True))

    def cloud(n):
        return FeatureCloud(xyz=torch.full((n, 3), 20.0),
                            ring=torch.zeros(n), rel_time=torch.zeros(n),
                            valid=torch.ones(n, dtype=torch.bool))

    far = TPose(torch.eye(3), torch.tensor([100.0, 0.0, 0.0]))
    st2, _, diag = tmap.mapping_step(st, cloud(256), cloud(1024), cloud(256),
                                     far, 99.0, TSMALL)
    assert int(st2.kf.count) == 16 and bool(diag.kf_overflow)
    assert int(st2.kf.overflow) == 1


def test_maybe_decimate_fires_within_margin():
    """Below the margin nothing happens; within it the store is decimated,
    the factors remapped and the submap cache marked stale."""
    cfg = port_cfg(DEFAULT).replace(mapping=TSMALL)
    st = tpipe.init_slam_state(cfg, device="cpu")
    kf = slam_state_from_numpy(fill_store(16, rotate=True), "cpu")
    _, tl = _loops_both(fill_store(16, rotate=True), LOOPS,
                        cap=cfg.posegraph.max_loop_factors)
    low = st._replace(mapping=st.mapping._replace(
        kf=kf._replace(count=torch.tensor(7, dtype=torch.int32)),
        cache=st.mapping.cache._replace(stale=torch.tensor(False))))
    assert tpipe.maybe_decimate(low, cfg, margin=8) == (low, False)
    full = low._replace(mapping=low.mapping._replace(kf=kf), loops=tl)
    out, fired = tpipe.maybe_decimate(full, cfg, margin=8)
    assert fired is True
    want_kf, want_l = tmap.decimate_keyframes(kf, tl, keep_recent=4)
    assert int(out.mapping.kf.count) == int(want_kf.count) == 10
    assert torch.equal(out.mapping.kf.t, want_kf.t)
    assert torch.equal(out.loops.i, want_l.i)
    assert bool(out.mapping.cache.stale)
