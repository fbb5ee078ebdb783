"""Kernel K5 (``ops/link_scan_cuda.py``, ``csrc/link_scan.cu``) on the CPU:
the kernel's order in plain form (tiles staged up to the node count, each
column summed row by row from 0.0, the tail past the node count, the range
differences) against a float32 sequential accumulate, bitwise; the wrapper
on CPU tensors is the plain lines; the pose graph's CG and update go
through the wrapper; and the constants the kernel shares with the wrapper.

The yardstick is ``np.add.accumulate`` in float32 after a leading zero row:
one rounding a row in row order from 0.0, as CUDA's ``torch.cumsum`` sums a
column.  CPU ``torch.cumsum`` may carry a float32 sum in double, so it is
not the yardstick here.  The kernel itself runs only on the card
(``chip_smoke.py``'s ``[link_scan]``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from legoloam_tpu_torch.config import PoseGraphConfig
from legoloam_tpu_torch.models import posegraph
from legoloam_tpu_torch.ops import _native, link_scan_cuda
from legoloam_tpu_torch.ops.se3 import Pose

COLS = link_scan_cuda.COLS
M = 4096        # the DEFAULT keyframe store
L = 64          # loop slots


# ---------------------------------------------------------------------------
# The kernel's order in plain form
# ---------------------------------------------------------------------------

def _count(n, m):
    return min(max(int(n), 0), m)


def model_scan(v, n, tile=link_scan_cuda.TILE, group=link_scan_cuda.GROUP):
    """``scan_rows``: rows [0, n) staged a tile at a time, column by column
    (no row at or past n read), the last tile padded with zero rows to a
    whole group; each column's running sum from 0.0 carried across tiles
    over every staged row, padding included, written back in place; the
    rows below n copied out.  Returns (running sums of rows < n, the final
    sum a column)."""
    q = np.zeros((n, COLS), np.float32)
    acc = np.zeros(COLS, np.float32)
    for r0 in range(0, n, tile):
        rows = min(tile, n - r0)
        padded = -(-rows // group) * group
        buf = np.zeros((COLS, padded), np.float32)
        buf[:, :rows] = v[r0:r0 + rows].T
        for i in range(padded):
            acc = acc + buf[:, i]       # six float32 adds, one a column
            buf[:, i] = acc
        q[r0:r0 + rows] = buf[:, :rows].T
    return q, acc


def model_rows(v, n):
    """``link_scan_rows``: the running sums below n, zeros from n on."""
    m = v.shape[0]
    n = _count(n, m)
    out = np.zeros((m, COLS), np.float32)
    out[:n] = model_scan(v, n)[0]
    return out


def model_ranges(v, n, lo, hi):
    """``link_scan_ranges``: P[hi] - P[lo], an endpoint outside [0, n)
    (compared unsigned) reading the tail, the final sum + 0.0."""
    n = _count(n, v.shape[0])
    q, acc = model_scan(v, n)
    tail = acc + np.float32(0.0)

    def at(e):
        e = e.astype(np.uint64)
        inside = e < np.uint64(n)
        got = q[np.where(inside, e, 0).astype(np.int64)] if n else \
            np.zeros((e.shape[0], COLS), np.float32)
        return np.where(inside[:, None], got, tail[None])

    return at(hi) - at(lo)


def sequential(v, n):
    """The plain scan of where(row < n, v, 0) over every row, one float32
    rounding a row in row order from 0.0."""
    ok = (np.arange(v.shape[0]) < n)[:, None]
    x = np.vstack([np.zeros((1, COLS), np.float32),
                   np.where(ok, v, np.float32(0.0))])
    return np.add.accumulate(x, axis=0, dtype=np.float32)[1:], ok


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and bool(np.all(
        (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))))


def _links(m, seed=0):
    """Link corrections with a wide range of magnitudes (so the order of the
    adds shows in the roundings) and -0.0 entries (a leading row of them)."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((m, COLS))
         * 10.0 ** rng.integers(-8, 4, (m, COLS))).astype(np.float32)
    v[0] = -0.0
    v[rng.integers(0, m, 40), rng.integers(0, COLS, 40)] = -0.0
    return v


def _nonfinite(v):
    v = v.copy()
    v[700, 1], v[701, 1] = np.inf, -np.inf
    v[650, 4] = np.nan
    return v


def _slots(n, m, seed=0):
    """Loop endpoints (lo, hi) with lo <= hi: valid slots inside [0, n),
    invalid ones (i = j = 0) and endpoints at or past n, up to M - 1."""
    rng = np.random.default_rng(seed + 1)
    top = max(n, 1)
    a, b = rng.integers(0, top, L), rng.integers(0, top, L)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    lo[::5] = hi[::5] = 0                         # invalid slots
    hi[1::7] = rng.integers(n, m, hi[1::7].shape[0]) if n < m else m - 1
    lo[2::11], hi[2::11] = min(n, m - 1), m - 1   # both at or past n
    return lo.astype(np.int64), hi.astype(np.int64)


CASES = [(0, M), (1, M), (800, M), (M, M), (1025, 1300), (1300, 1300),
         (511, 700), (512, 512)]


@pytest.mark.parametrize("n,m", CASES)
def test_model_rows_equal_the_sequential_accumulate(n, m):
    v = _links(m, seed=n)
    seq, ok = sequential(v, n)
    assert _bits_equal(model_rows(v, n), np.where(ok, seq, np.float32(0.0)))


@pytest.mark.parametrize("n,m", CASES)
def test_model_ranges_equal_the_sequential_accumulate(n, m):
    """Range differences at valid slots, invalid slots and endpoints at or
    past n: the tail is what the plain scan of masked zeros holds."""
    v = _links(m, seed=n)
    lo, hi = _slots(n, m, seed=n)
    seq, _ = sequential(v, n)
    assert _bits_equal(model_ranges(v, n, lo, hi), seq[hi] - seq[lo])


@np.errstate(invalid="ignore")
def test_model_with_nonfinite_links():
    v = _nonfinite(_links(M))
    for n in (699, 701, 800):
        seq, ok = sequential(v, n)
        assert _bits_equal(model_rows(v, n),
                           np.where(ok, seq, np.float32(0.0)))
        lo, hi = _slots(n, M, seed=n)
        assert _bits_equal(model_ranges(v, n, lo, hi), seq[hi] - seq[lo])


def test_leading_negative_zero_becomes_positive_zero():
    """The sum starts from 0.0 and adds every element: a leading -0.0 is
    +0.0, as the plain scan gives (np.add.accumulate alone would keep it)."""
    v = np.full((8, COLS), -0.0, np.float32)
    out = model_rows(v, 8)
    assert not np.signbit(out).any()
    assert np.signbit(np.add.accumulate(v, axis=0)).all()


def test_node_count_is_clamped_and_endpoints_compare_unsigned():
    v = _links(64)
    seq, _ = sequential(v, 64)
    assert _bits_equal(model_rows(v, 100), seq)
    assert _bits_equal(model_rows(v, -3), np.zeros((64, COLS), np.float32))
    lo, hi = np.array([-1, 0], np.int64), np.array([63, 70], np.int64)
    want = np.stack([seq[63] - (seq[63] + np.float32(0.0)),
                     (seq[63] + np.float32(0.0)) - seq[0]])
    assert _bits_equal(model_ranges(v, 64, lo, hi), want)


def test_model_equals_the_plain_lines_on_exact_sums():
    """On small integers every order of the adds is exact, so the plain
    lines on the CPU (whatever their accumulator) equal the model: the
    masks, the tail and the gathers agree."""
    rng = np.random.default_rng(5)
    v = rng.integers(-50, 50, (M, COLS)).astype(np.float32)
    for n in (0, 1, 800, M):
        ok = torch.arange(M) < n
        nt = torch.tensor(n, dtype=torch.int32)
        lo, hi = _slots(n, M, seed=n)
        rows = link_scan_cuda.link_scan(torch.from_numpy(v), ok, nt)
        ranges = link_scan_cuda.link_scan_ranges(
            torch.from_numpy(v), ok, nt, torch.from_numpy(lo),
            torch.from_numpy(hi))
        assert _bits_equal(rows.numpy(), model_rows(v, n))
        assert _bits_equal(ranges.numpy(), model_ranges(v, n, lo, hi))


# ---------------------------------------------------------------------------
# The wrapper and its callers
# ---------------------------------------------------------------------------

def test_wrapper_on_cpu_is_the_plain_path():
    _native.reset_counts()
    v = torch.from_numpy(_links(M))
    for n in (0, 800, M):
        ok = torch.arange(M) < n
        nt = torch.tensor(n, dtype=torch.int32)
        lo, hi = (torch.from_numpy(a) for a in _slots(n, M, seed=n))
        du = torch.where(ok[:, None], v, 0.0)
        want = torch.where(ok[:, None], torch.cumsum(du, dim=0), 0.0)
        assert torch.equal(link_scan_cuda.link_scan(v, ok, nt), want)
        Qv = torch.cumsum(torch.where(ok[:, None], v, 0.0), dim=0)
        assert torch.equal(link_scan_cuda.link_scan_ranges(v, ok, nt, lo, hi),
                           Qv[hi] - Qv[lo])
    assert _native.counts()["link_scan"] == 0


def _solve_inputs(m=32, n=21):
    """A square-ish chain of n nodes in an m-node store with two loop
    factors (one reversed), and the CG's first direction."""
    g = torch.Generator().manual_seed(0)
    R = torch.eye(3).expand(m, 3, 3).clone()
    t = torch.zeros(m, 3)
    t[:n, 0] = 2.0 * torch.arange(n, dtype=torch.float32)
    t[:n] += 0.1 * torch.randn(n, 3, generator=g)
    chain_R = torch.eye(3).expand(m, 3, 3).clone()
    chain_t = torch.zeros(m, 3)
    chain_t[1:n, 0] = 2.0
    loops = posegraph.init_loop_factors(8)
    eye = Pose(torch.eye(3), torch.zeros(3))
    loops = posegraph.add_loop_factor(loops, 0, n - 1, eye._replace(
        t=torch.tensor([40.0, 0.0, 0.0])), 1e-3)
    loops = posegraph.add_loop_factor(loops, 15, 4, eye._replace(
        t=torch.tensor([-22.0, 0.0, 0.0])), 1e-2)
    cfg = PoseGraphConfig()
    G = posegraph._setup(R, torch.tensor(n, dtype=torch.int32), loops,
                         Pose(R[0], t[0]), cfg)
    lin, pcg = posegraph._linearize(G, R, t, chain_R, chain_t, cfg)
    return G, lin, pcg, R, t


def test_graph_holds_the_node_count():
    G = _solve_inputs()[0]
    assert G.n.dtype == torch.int32 and G.n.dim() == 0 and int(G.n) == 21
    R = torch.eye(3).expand(4, 3, 3)
    for n_nodes, want in ((torch.tensor(9, dtype=torch.int32), 4), (2, 2),
                          (0, 0)):
        G = posegraph._setup(R, n_nodes, posegraph.init_loop_factors(2),
                             Pose(R[0], torch.zeros(3)), PoseGraphConfig())
        assert int(G.n) == want == int(G.node_ok.sum())


def test_pose_graph_goes_through_the_wrapper(monkeypatch):
    """``_hvp`` takes its range sums and ``_update`` its node perturbations
    from the wrapper, with the graph's mask, node count and endpoints; on
    the CPU the results are the lines they replaced, bitwise."""
    G, lin, pcg, R, t = _solve_inputs()
    calls = []
    for name in ("link_scan", "link_scan_ranges"):
        real = getattr(link_scan_cuda, name)

        def spy(*args, _real=real, _name=name):
            calls.append((_name, args))
            return _real(*args)

        monkeypatch.setattr(link_scan_cuda, name, spy)
    p = pcg.p
    got = posegraph._hvp(G, lin, p)
    Qv = torch.cumsum(torch.where(G.node_ok[:, None], p, 0.0), dim=0)
    S = Qv[G.l_hi] - Qv[G.l_lo]
    out = posegraph._mtv(lin.B, G.Wrow * posegraph._mv(lin.B, p))
    out = out + G.in_range @ posegraph._mtv(
        lin.B_l, G.wl6 * posegraph._mv(lin.B_l, S))
    assert torch.equal(got, torch.where(G.node_ok[:, None], out, p))
    pcg = pcg._replace(x=p)
    R1, t1 = posegraph._update(G, R, t, pcg)
    du = torch.where(G.node_ok[:, None], pcg.x, 0.0)
    v = torch.where(G.node_ok[:, None], torch.cumsum(du, dim=0), 0.0)
    upd = posegraph.se3.se3_exp(v)
    assert torch.equal(R1, upd.R @ R)
    assert torch.equal(t1, posegraph.se3.rotate_vec(upd.R, t) + upd.t)
    assert [c[0] for c in calls] == ["link_scan_ranges", "link_scan"]
    (_, a), (_, b) = calls
    assert a[1] is G.node_ok and a[2] is G.n and a[3] is G.l_lo \
        and a[4] is G.l_hi
    assert b[0] is pcg.x and b[1] is G.node_ok and b[2] is G.n


def test_kernel_constants_are_the_wrappers():
    """Columns, tile rows, group rows and threads in ``csrc/link_scan.cu``
    are the wrapper's (the model's tiling and the bound's row width)."""
    src = (Path(link_scan_cuda.__file__).parents[1] / "csrc"
           / "link_scan.cu").read_text()
    for const, want in (("kCols", COLS), ("kTile", link_scan_cuda.TILE),
                        ("kGroup", link_scan_cuda.GROUP),
                        ("kThreads", link_scan_cuda.THREADS)):
        assert int(re.search(rf"constexpr int {const} = (\d+);",
                             src).group(1)) == want, const


def test_bytes_moved():
    assert link_scan_cuda.bytes_moved(4096, 800) == 24 * 800 + 4 + 24 * 4096
    assert link_scan_cuda.bytes_moved(4096, 800, loops=1024) \
        == 24 * 800 + 4 + 1024 * 40
