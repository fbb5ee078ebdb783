"""k-NN parity: the port's plain k-NN (kernel K3's plain version) against the
JAX package's ``voxel.knn`` and ``knn_pallas`` in interpret mode, on
Morton-sorted inputs 0-90 m from the origin (as tools/check_tpu_kernels.py).

Tolerance: distances to 1e-4 relative (both recompute the winners'
distances in difference form; the Pallas kernel selects by packed
int32 keys); index sets equal except at near-ties, where the 5th-neighbour
distances agree to 2% and the sets agree on >= 98% of rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu.ops.knn_pallas import knn_pallas
from legoloam_tpu.ops.voxel import knn as jknn
from legoloam_tpu.ops.voxel import voxel_downsample as jvoxel
from legoloam_tpu_torch.ops import _native, knn_cuda
from legoloam_tpu_torch.ops import voxel as tvoxel

from _torch_parity import npy, tt

N_Q, N_R = 512, 4096


def _sets(offset, seed=0):
    rng = np.random.RandomState(seed)
    center = np.array([offset, offset * 0.5, 0.0], np.float32)
    raw = rng.randn(12000, 3).astype(np.float32) * np.array(
        [12.0, 12.0, 1.0], np.float32) + center
    ref, rv = jvoxel(jnp.asarray(raw), jnp.ones(12000, bool), 0.4, N_R,
                     origin=jnp.asarray(center))
    q = (rng.randn(N_Q, 3).astype(np.float32) * np.array(
        [10.0, 10.0, 1.0], np.float32) + center)
    qv = rng.rand(N_Q) > 0.05
    return q, qv, np.asarray(ref), np.asarray(rv)


def _compare(d_t, i_t, d_j, i_j, rows):
    d_t, i_t = npy(d_t)[rows], npy(i_t)[rows]
    d_j, i_j = np.asarray(d_j)[rows], np.asarray(i_j)[rows]
    same = np.array([set(a) == set(b) for a, b in zip(i_t, i_j)])
    assert same.mean() >= 0.98, same.mean()
    np.testing.assert_allclose(d_t[same], d_j[same], rtol=1e-4, atol=1e-6)
    # A swapped neighbour is a near-tie: the k-th distances still agree.
    np.testing.assert_allclose(d_t[~same][:, -1], d_j[~same][:, -1],
                               rtol=2e-2, atol=1e-4)


@pytest.mark.parametrize("offset", [0.0, 60.0, 90.0])
def test_knn_plain_matches_jax(offset):
    q, qv, ref, rv = _sets(offset)
    d_t, i_t = tvoxel.knn(tt(q), tt(qv), tt(ref), tt(rv), 5)
    d_x, i_x = jknn(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(ref),
                    jnp.asarray(rv), k=5)
    d_p, i_p = knn_pallas(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(ref),
                          jnp.asarray(rv), k=5, gate=1.0, interpret=True)
    assert (npy(d_t)[~qv] >= 1e29).all()
    assert (npy(i_t) < N_R).all() and rv[npy(i_t)[qv]].all()
    _compare(d_t, i_t, d_x, i_x, qv)
    gated = qv & (np.asarray(d_x)[:, 4] < 1.0)
    assert gated.sum() > 50
    _compare(d_t, i_t, d_p, i_p, gated)


def test_knn_wrapper_on_cpu_is_the_plain_version():
    q, qv, ref, rv = _sets(60.0, seed=1)
    _native.reset_counts()
    d_a, i_a = knn_cuda.knn(tt(q), tt(qv), tt(ref), tt(rv), 5, gate=1.0)
    d_b, i_b = tvoxel.knn(tt(q), tt(qv), tt(ref), tt(rv), 5)
    assert torch.equal(d_a, d_b) and torch.equal(i_a, i_b)
    assert knn_cuda.KERNEL.launches == 0


def test_chunk_boxes_cover_valid_refs():
    """The per-chunk boxes the kernel culls with hold every valid reference
    of their chunk; chunks without one are empty (lo > hi)."""
    q, qv, ref, rv = _sets(90.0, seed=2)
    rv = rv.copy()
    rv[: 2 * knn_cuda.RC] = False
    lo, hi = knn_cuda.chunk_boxes(tt(ref), tt(rv))
    lo, hi = npy(lo), npy(hi)
    assert lo.shape == ((N_R + knn_cuda.RC - 1) // knn_cuda.RC, 3)
    c = np.arange(N_R) // knn_cuda.RC
    assert (ref[rv] >= lo[c[rv]]).all() and (ref[rv] <= hi[c[rv]]).all()
    assert (lo[:2] > hi[:2]).all()


def test_recentre_matches_plain_frame():
    q, qv, ref, rv = _sets(60.0, seed=3)
    qc, rc = tvoxel.recentre(tt(q), tt(ref), tt(rv))
    box = ref[rv]
    c = 0.5 * (box.min(0) + box.max(0))
    np.testing.assert_allclose(npy(rc), ref - c, atol=1e-5)
    np.testing.assert_allclose(npy(qc), q - c, atol=1e-5)
