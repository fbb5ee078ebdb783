"""k-NN parity: the port's plain k-NN (kernel K3's plain version) against the
JAX package's ``voxel.knn`` and ``knn_pallas`` in interpret mode, on
Morton-sorted inputs 0-90 m from the origin (as tools/check_tpu_kernels.py).

Tolerance: distances to 1e-4 relative (both recompute the winners'
distances in difference form; the Pallas kernel selects by packed
int32 keys); index sets equal except at near-ties, where the 5th-neighbour
distances agree to 2% and the sets agree on >= 98% of rows.
"""

import re
from pathlib import Path

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


def _masked_sets():
    q, qv, ref, rv = _sets(60.0, seed=4)
    rv = rv.copy()
    rv[256:512] = False                           # one empty chunk
    qv = qv.copy()
    qv[64:128] = False                            # one empty tile
    lo_r, hi_r = ref[rv].min(0), ref[rv].max(0)
    c = np.float32(0.5) * (lo_r + hi_r)
    return q, qv, ref, rv, q - c, ref - c


@pytest.mark.parametrize("gate", [1.0, None])
def test_gated_pairs_matches_brute_count(gate):
    """K3's bound counts the (valid query, valid reference) pairs within the
    gate; a loop over the valid queries, with difference-form float32
    distances in numpy, counts the same.  Exact (integer counts)."""
    q, qv, ref, rv, qc, rc = _masked_sets()
    want = 0
    for p in qc[qv]:
        diff = p - rc[rv]
        d = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) \
            + diff[:, 2] * diff[:, 2]
        want += len(d) if gate is None else int((d <= np.float32(gate ** 2))
                                                .sum())
    got = knn_cuda.gated_pairs(tt(q), tt(qv), tt(ref), tt(rv), gate)
    assert got == want
    assert 0 < got <= int(qv.sum()) * int(rv.sum())
    if gate is not None:
        assert got < knn_cuda.tile_pairs(tt(q), tt(qv), tt(ref), tt(rv), gate)


@pytest.mark.parametrize("gate", [1.0, None])
def test_tile_pairs_matches_brute_count(gate):
    """The first kernel's work counts (64-query tile, 256-reference chunk)
    pairs within the gate; a loop over every pair, with the boxes taken from
    the points in numpy float32, counts the same.  Exact (integer counts)."""
    q, qv, ref, rv, qc, rc = _masked_sets()
    tq, rcn = knn_cuda.TILE_TQ, knn_cuda.TILE_RC
    want = 0
    for t in range(0, N_Q, tq):
        pts = qc[t:t + tq][qv[t:t + tq]]
        for s in range(0, N_R, rcn):
            rpts = rc[s:s + rcn][rv[s:s + rcn]]
            if len(pts) == 0 or len(rpts) == 0:
                continue
            g = np.maximum(np.maximum(pts.min(0) - rpts.max(0),
                                      rpts.min(0) - pts.max(0)), 0)
            g = g * g
            if gate is None or (g[0] + g[1]) + g[2] <= np.float32(gate ** 2):
                want += tq * rcn
    got = knn_cuda.tile_pairs(tt(q), tt(qv), tt(ref), tt(rv), gate)
    assert got == want
    assert 0 < got < N_Q * N_R


def test_sentinel_never_enters():
    """The kernel writes invalid references as (kFar, kFar, kFar) in the
    recentred frame: for any query within 1e6 m the float32 difference-form
    distance to it is finite and above the empty-slot value kBig, so an
    invalid reference never displaces a slot nor passes a gate."""
    src = (Path(knn_cuda.__file__).parents[1] / "csrc" / "knn.cu").read_text()
    far = float(re.search(r"kFar = ([0-9.e+]+)f;", src).group(1))
    big = float(re.search(r"kBig = ([0-9.e+]+)f;", src).group(1))
    assert big == knn_cuda.BIG
    p = torch.tensor([[-1e6, -1e6, -1e6], [0.0, 0.0, 0.0], [1e6, 1e6, 1e6],
                      [1e6, -1e6, 0.5]], dtype=torch.float32)
    dx = p - torch.tensor(far, dtype=torch.float32)
    d = (dx[:, 0] * dx[:, 0] + dx[:, 1] * dx[:, 1]) + dx[:, 2] * dx[:, 2]
    assert torch.isfinite(d).all() and (d > big).all()


def _merge_topk(d_parts, i_parts, k):
    """Merge partial top-k lists (P, Q, k) into one (Q, k) by the pair
    (distance, index) in lexicographic order: the kernel's merge of its
    warps' lists, in plain form."""
    d = d_parts.permute(1, 0, 2).reshape(d_parts.shape[1], -1)
    i = i_parts.permute(1, 0, 2).reshape(i_parts.shape[1], -1)
    i, o = torch.sort(i, dim=1, stable=True)
    d = torch.gather(d, 1, o)
    d, o = torch.sort(d, dim=1, stable=True)
    return d[:, :k], torch.gather(i, 1, o)[:, :k]


def _tie_refs(seed=7, r_n=2500):
    """References with duplicated points within a chunk, across chunks that
    go to different warps and across chunks of one warp."""
    rng = np.random.RandomState(seed)
    ref = (rng.randn(r_n, 3) * 2.0).astype(np.float32)
    rc, w = knn_cuda.RC, knn_cuda.WARPS
    ref[rc:2 * rc] = ref[:rc]
    ref[w * rc:w * rc + 40] = ref[:40]
    ref[300:310] = ref[310:320]
    rv = rng.rand(r_n) > 0.1
    q = ref[rng.randint(0, r_n, 300)].copy()
    q[::2] += (rng.randn(150, 3) * 0.01).astype(np.float32)
    qv = rng.rand(300) > 0.05
    return q, qv, ref, rv


@pytest.mark.parametrize("case", ["morton", "ties", "few_valid"])
def test_split_merge_equals_exact(case):
    """The kernel's split, in plain form: warp w searches chunks w, w+WARPS,
    ... of RC references; the partial top-k lists merged by (distance,
    index) equal the exact search's (distance, index) pairs, ties to the
    lower index, (1e30, 0) beyond the valid references.  Exact (bitwise)."""
    if case == "morton":
        q, qv, ref, rv = _sets(30.0, seed=5)
    else:
        q, qv, ref, rv = _tie_refs()
        if case == "few_valid":
            rv = np.zeros_like(rv)
            rv[[3, knn_cuda.RC + 3, 2 * knn_cuda.RC + 3]] = True
    k = 5
    q, qv, ref, rv = tt(q), tt(qv), tt(ref), tt(rv)
    d_all, i_all = knn_cuda.knn_exact(q, qv, ref, rv, k)
    warp = (torch.arange(ref.shape[0]) // knn_cuda.RC) % knn_cuda.WARPS
    parts = [knn_cuda.knn_exact(q, qv, ref, rv & (warp == w), k)
             for w in range(knn_cuda.WARPS)]
    # A group's search recentres on its own references: take each group's
    # winners' distances from the full search's frame, as the kernel does.
    d_parts, i_parts = [], []
    qc, rcen = tvoxel.recentre(q, ref, rv)
    for d_w, i_w in parts:
        diff = qc[:, None] - rcen[i_w]
        d_f = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
            + diff[..., 2] * diff[..., 2]
        d_parts.append(torch.where(d_w >= 1e29, d_w, d_f))
        i_parts.append(i_w)
    d_m, i_m = _merge_topk(torch.stack(d_parts), torch.stack(i_parts), k)
    assert torch.equal(d_m, d_all) and torch.equal(i_m, i_all)
    if case == "ties":
        ties = (d_all[:, 1:] == d_all[:, :-1]) & (d_all[:, 1:] < 1e29)
        assert int(ties.sum()) > 20
        assert (i_all[:, 1:][ties] > i_all[:, :-1][ties]).all()
    if case == "few_valid":
        assert (d_all[:, 3:] == 1e30).all() and (i_all[:, 3:] == 0).all()
    if case != "morton":
        return
    # The exact search agrees with the JAX package's k-NN on the valid rows
    # (which drops a duplicate point and fills missing slots with 1e6-far
    # references, see ROADMAP queue 3, so only away from ties).
    d_x, _ = jknn(jnp.asarray(npy(q)), jnp.asarray(npy(qv)),
                  jnp.asarray(npy(ref)), jnp.asarray(npy(rv)), k=min(k, 3))
    np.testing.assert_allclose(npy(d_all)[npy(qv), :3],
                               np.asarray(d_x)[npy(qv)], rtol=1e-4, atol=1e-6)
