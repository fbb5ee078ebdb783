"""Kernel K4 (``ops/class_nn_cuda.py``, ``csrc/class_nn.cu``) on the CPU: the
wrapper is the plain version (``voxel.class_nn``) there, the plain contract
against a numpy brute force, the kernel's split geometry and its design
(splits merged by (value, index), the fast chunk's cap and skip) in plain
form, and the constant the kernel shares with the plain version.

Points have small integer coordinates, so every distance is exact in
float32 whatever the order of the sums: ties are exact and results equal
bitwise.  The kernel itself runs only on the card (``chip_smoke.py``'s
``[class_nn]``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from legoloam_tpu_torch.models import odometry
from legoloam_tpu_torch.ops import _native, class_nn_cuda, voxel

BIG = np.float32(1e30)
INF = float("inf")


def _cloud(n, rng, rings=8, span=6):
    """Integer points, ordered by ring key (the feature clouds' order)."""
    key = np.sort(rng.integers(0, rings, n)).astype(np.float32)
    xyz = rng.integers(-span, span + 1, (n, 3)).astype(np.float32)
    return xyz, key


def _brute(q, ref, rv, key, lo, hi, ex):
    """The plain contract, one (class, query) at a time, in float64 (exact
    for these points): the nearest in-class reference beyond the exclusion,
    the lowest index on ties; (1e30, 0) with no candidate, where every value
    is 1e30 after the penalty.  Invalid references sit at 1e6."""
    ref_m = np.where(rv[:, None], ref, 1e6).astype(np.float64)
    c_n, q_n = lo.shape
    d_out = np.zeros((c_n, q_n), np.float32)
    i_out = np.zeros((c_n, q_n), np.int64)
    for c in range(c_n):
        for i in range(q_n):
            d = ((q[i].astype(np.float64) - ref_m) ** 2).sum(1)
            ok = (key >= lo[c, i]) & (key <= hi[c, i]) & (d > ex[c, i])
            if not ok.any():
                d_out[c, i], i_out[c, i] = BIG, 0
                continue
            j = int(np.flatnonzero(ok)[np.argmin(d[ok])])
            d_out[c, i], i_out[c, i] = d[j], j
    return d_out, i_out


def _windows(q_key, n_classes):
    """The odometry's ring windows around each query's ring."""
    if n_classes == 1:
        return q_key[None] - 1.0, q_key[None] + 1.0
    return (np.stack([q_key - 2.5, q_key + 0.5]),
            np.stack([q_key, q_key + 2.5]))


def _case(name, seed=0, q_n=300, r_n=700):
    rng = np.random.default_rng(seed)
    ref, key = _cloud(r_n, rng)
    q, q_key = _cloud(q_n, rng)
    rv = np.ones(r_n, bool)
    if name == "open":
        lo = np.full((1, q_n), -INF, np.float32)
        return q, ref, rv, key, lo, -lo, lo.copy()
    n_classes = 2 if name.endswith("2") else 1
    lo, hi = _windows(q_key, n_classes)
    ex = np.full((n_classes, q_n), -INF, np.float32)
    if name.startswith("exclusion"):
        d0, _ = _brute(q, ref, rv, key, np.full((1, q_n), -INF, np.float32),
                       np.full((1, q_n), INF, np.float32),
                       np.full((1, q_n), -INF, np.float32))
        ex[0] = d0[0]
    if name.startswith("invalid"):
        rv = rng.random(r_n) > 0.3
    return q, ref, rv, key, lo.astype(np.float32), hi.astype(np.float32), ex


def _plain(q, ref, rv, key, lo, hi, ex):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, ref, rv, key, lo, hi, ex)]
    return voxel.class_nn(*t, q_tile=128, n_classes=lo.shape[0])


@pytest.mark.parametrize("name", ["open", "windows1", "windows2",
                                  "exclusion1", "exclusion2"])
def test_plain_matches_brute_force(name):
    """Exact ties go to the lowest index; the exclusion ``d <= ex`` is
    strict (the exclusion cases exclude each query's nearest distance, so
    every reference at that distance, duplicates included)."""
    args = _case(name)
    d, i = _plain(*args)
    d_b, i_b = _brute(*args)
    assert np.array_equal(d.numpy(), d_b) and np.array_equal(i.numpy(), i_b)
    if name.startswith("exclusion"):
        assert (d[0].numpy() > args[6][0]).all()


def test_plain_breaks_ties_to_the_lowest_index():
    rng = np.random.default_rng(1)
    ref, key = _cloud(200, rng)
    ref[150:200] = ref[0:50]
    key[150:200] = key[0:50]
    q = ref[[0, 10, 49, 160, 199]]
    lo = np.full((1, 5), -INF, np.float32)
    d, i = _plain(q, ref, np.ones(200, bool), key, lo, -lo, lo.copy())
    assert (d == 0).all() and i.tolist() == [[0, 10, 49, 10, 49]]


def test_no_candidate_row_is_big_at_index_zero():
    """A class window that holds no reference: (1e30, 0), as the penalised
    row's minimum is 1e30 everywhere and torch.min takes the first."""
    q, ref, rv, key, lo, hi, ex = _case("windows2")
    lo[:, ::3], hi[:, ::3] = 50.0, 60.0          # no key in [50, 60]
    lo[1, 1::3], hi[1, 1::3] = 4.0, 3.0          # an empty window
    d, i = _plain(q, ref, rv, key, lo, hi, ex)
    empty = np.zeros(lo.shape, bool)
    empty[:, ::3] = True
    empty[1, 1::3] = True
    assert (d.numpy()[empty] == BIG).all() and (i.numpy()[empty] == 0).all()
    d_b, i_b = _brute(q, ref, rv, key, lo, hi, ex)
    assert np.array_equal(d.numpy(), d_b) and np.array_equal(i.numpy(), i_b)


def test_invalid_refs_win_only_without_a_valid_candidate():
    """Invalid references sit at 1e6: a row returns one only where its class
    holds no valid reference, and such a row returns the invalid in-class
    reference nearest to the query's side of (1e6, 1e6, 1e6)."""
    q, ref, rv, key, lo, hi, ex = _case("invalid1")
    rv[key == 3] = False                       # ring 3: invalid only
    lo[0, :50], hi[0, :50] = 3.0, 3.0
    d, i = _plain(q, ref, rv, key, lo, hi, ex)
    d_b, i_b = _brute(q, ref, rv, key, lo, hi, ex)
    won_invalid = ~rv[i.numpy()[0]]
    in_class = (key[None] >= lo[0][:, None]) & (key[None] <= hi[0][:, None])
    has_valid = (in_class & rv[None]).any(1)
    assert won_invalid[:50].all() and not won_invalid[has_valid].any()
    assert np.array_equal(i.numpy()[0][has_valid], i_b[0][has_valid])
    assert np.array_equal(d.numpy()[0][has_valid], d_b[0][has_valid])


def test_wrapper_on_cpu_is_the_plain_version():
    _native.reset_counts()
    for name in ("open", "windows2", "exclusion1"):
        t = [torch.from_numpy(np.ascontiguousarray(a)) for a in _case(name)]
        c = t[4].shape[0]
        d_w, i_w = class_nn_cuda.class_nn(*t, q_tile=512, n_classes=c)
        d_p, i_p = voxel.class_nn(*t, q_tile=512, n_classes=c)
        assert torch.equal(d_w, d_p) and torch.equal(i_w, i_p)
    assert _native.counts()["class_nn"] == 0


def test_odometry_searches_through_the_wrapper():
    assert odometry.class_nn is class_nn_cuda.class_nn


def test_kernel_big_is_the_plain_penalty():
    """The kernel's penalty and no-candidate value is the plain version's
    ``BIG``, and its query tile is the wrapper's ``TQ`` (the geometry's
    tile count)."""
    src = (Path(class_nn_cuda.__file__).parents[1] / "csrc"
           / "class_nn.cu").read_text()
    big = float(re.search(r"kBig = ([0-9.e+]+)f;", src).group(1))
    assert np.float32(big) == np.float32(voxel.BIG)
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    qt = int(re.search(r"kQT = (\d+);", src).group(1))
    assert threads * qt == class_nn_cuda.TQ


@pytest.mark.parametrize("q_n,r_n", [(512, 2048), (1024, 8192),
                                     (4096, 16384), (8192, 65536),
                                     (900, 3001), (10, 50), (70000, 100)])
def test_split_geometry(q_n, r_n):
    """At most one split a chunk and MAX_SPLITS partials; the blocks of the
    large searches fill 132 SMs at BLOCKS_PER_SM without a second wave."""
    s = class_nn_cuda.splits(q_n, r_n, 132)
    tiles = -(-q_n // class_nn_cuda.TQ)
    slots = 132 * class_nn_cuda.BLOCKS_PER_SM
    assert 1 <= s <= min(class_nn_cuda.MAX_SPLITS,
                         -(-r_n // class_nn_cuda.RC))
    if r_n >= class_nn_cuda.RC * class_nn_cuda.MAX_SPLITS:
        assert tiles * s >= min(slots, tiles * class_nn_cuda.MAX_SPLITS)
    if tiles * s > slots:
        assert s == 1 or tiles * (s - 1) < slots


def test_needed_ops_matches_brute_count():
    q, ref, rv, key, lo, hi, ex = _case("windows2")
    inside = [(key[None] >= lo[c][:, None]) & (key[None] <= hi[c][:, None])
              for c in range(2)]
    want = 9 * int((inside[0] | inside[1]).sum()) \
        + 2 * int(inside[0].sum() + inside[1].sum())
    got = class_nn_cuda.needed_ops(torch.from_numpy(key),
                                   torch.from_numpy(lo), torch.from_numpy(hi),
                                   2, q_block=64)
    assert got == want


def _kernel_model(q, ref, rv, key, lo, hi, ex, n_splits, tq=64, wq=16,
                  rc=32):
    """The kernel's design in plain form, for fast pairs.  Per tile of ``tq``
    queries: the chunks of ``rc`` references it needs (chunk 0 and those
    whose keys meet a class window of the tile), split by ordinal into
    ``n_splits`` ranges.  Each (tile, split) starts from torch.min's
    identity (inf, 0); each of its chunks caps the running (value, index)
    at (1e30, the chunk's first index), then, for each group of ``wq``
    queries (a warp) whose windows its keys meet, takes in-class references
    by a strict compare in index order.  The splits' partials are merged by
    (value, index) and clamped at 0."""
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (q, ref, rv, key, lo, hi, ex)]
    q, ref, rv, key, lo, hi, ex = t
    ref_m = torch.where(rv[:, None], ref, torch.full_like(ref, 1e6))
    c_n, q_n, r_n = lo.shape[0], q.shape[0], ref.shape[0]
    starts = list(range(0, r_n, rc))

    def meets(base, sl):
        k = key[base:base + rc]
        return bool(((k.max() >= lo[:, sl].amin(1))
                     & (k.min() <= hi[:, sl].amax(1))).any())

    best = torch.full((n_splits, c_n, q_n), INF)
    idx = torch.zeros((n_splits, c_n, q_n), dtype=torch.int64)
    for t0 in range(0, q_n, tq):
        tile = slice(t0, min(t0 + tq, q_n))
        need = [b for b in starts if b == 0 or meets(b, tile)]
        for s in range(n_splits):
            share = need[len(need) * s // n_splits:
                         len(need) * (s + 1) // n_splits]
            for base in share:
                rs = slice(base, min(base + rc, r_n))
                for w0 in range(tile.start, tile.stop, wq):
                    sl = slice(w0, min(w0 + wq, tile.stop))
                    b, i = best[s, :, sl], idx[s, :, sl]
                    cap = b > BIG
                    b[cap], i[cap] = float(BIG), base
                    if not meets(base, sl):
                        continue
                    k = key[rs]
                    d = ((q[sl, None] - ref_m[None, rs]) ** 2).sum(-1)
                    for j in range(d.shape[1]):
                        take = ((k[j] >= lo[:, sl]) & (k[j] <= hi[:, sl])
                                & (d[None, :, j] > ex[:, sl])
                                & (d[None, :, j] < b))
                        b[take] = d[:, j].expand_as(b)[take]
                        i[take] = base + j
    out_d, out_i = best[0], idx[0]
    for b, i in zip(best[1:], idx[1:]):
        take = (b < out_d) | ((b == out_d) & (i < out_i))
        out_d, out_i = torch.where(take, b, out_d), torch.where(take, i, out_i)
    return torch.clamp(out_d, min=0.0), out_i


@pytest.mark.parametrize("name", ["open", "windows1", "windows2",
                                  "exclusion2", "invalid1"])
@pytest.mark.parametrize("n_splits", [1, 3, 7])
def test_kernel_design_equals_plain(name, n_splits):
    """Skipped chunks, caps, the warps' skips and the split merge change
    nothing: the model equals the plain version bitwise (ring-ordered
    clouds, so most chunks of the windowed cases are skipped; windows that
    hold no key included)."""
    args = list(_case(name, seed=2, q_n=150, r_n=400))
    if name != "open":
        args[4][:, ::5], args[5][:, ::5] = 50.0, 60.0
    d_m, i_m = _kernel_model(*args, n_splits)
    d_p, i_p = _plain(*args)
    assert torch.equal(d_m, d_p) and torch.equal(i_m, i_p)
