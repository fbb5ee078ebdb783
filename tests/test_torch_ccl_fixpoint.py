"""K1's plain version against a plain breadth-first labelling, where the
sweeps need more than the DEFAULT cap of 32 (``seg.ccl_max_iters``).

The source's ``labelComponents`` (imageProjection.cpp:375-451) labels
every component to its end by a BFS, and K1 (``csrc/ccl.cu``) is a
union-find that ignores the cap.  The plain sweeps (the port's
``ccl_cuda.label_propagation_plain`` and the benchmark reference's frozen
copy of it) reach the same labels once they run to their fixpoint, and
stop short at a cap below it:

  * a snake-shaped mask whose one component needs a sweep for every two
    of its columns;
  * the masks of scan 39 of the VLP-16 ``online`` mix at seed 6130000206
    as an H100 cast them (``data/ccl_vlp16_scan39.npz``): the plain sweeps
    reach their fixpoint after 34 sweeps, and there K1's labels equalled
    the fixpoint's and differed from the 32-sweep cap's.

Exact comparisons: labels and ring extrema are integers.
"""

from __future__ import annotations

from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import ccl as ref_ccl
from legoloam_tpu_torch.ops import ccl_cuda

DATA = Path(__file__).resolve().parent / "data"
CAP = 32
PLAIN = {"port": ccl_cuda.label_propagation_plain,
         "reference": ref_ccl.label_propagation_plain}


def bfs_labels(seeds, conn_h, conn_v):
    """(labels, ring_min, ring_max) by breadth-first search: 4-connected
    under ``conn_h`` (column wrap included) and ``conn_v``, both ends
    seeds; a label is its component's smallest flat index."""
    n, h = seeds.shape
    big = n * h
    labels = np.full((n, h), big, np.int32)
    rmin = np.full((n, h), n, np.int32)
    rmax = np.full((n, h), -1, np.int32)
    for start in range(big):
        r0, c0 = divmod(start, h)
        if not seeds[r0, c0] or labels[r0, c0] != big:
            continue
        comp, queue = [], deque([(r0, c0)])
        labels[r0, c0] = start
        while queue:
            r, c = queue.popleft()
            comp.append((r, c))
            nbrs = []
            if conn_h[r, c]:
                nbrs.append((r, (c + 1) % h))
            if conn_h[r, (c - 1) % h]:
                nbrs.append((r, (c - 1) % h))
            if r + 1 < n and conn_v[r, c]:
                nbrs.append((r + 1, c))
            if r > 0 and conn_v[r - 1, c]:
                nbrs.append((r - 1, c))
            for rr, cc in nbrs:
                if seeds[rr, cc] and labels[rr, cc] == big:
                    labels[rr, cc] = start
                    queue.append((rr, cc))
        rows = [r for r, _ in comp]
        for r, c in comp:
            rmin[r, c], rmax[r, c] = min(rows), max(rows)
    return labels, rmin, rmax


def snake(n: int = 16, h: int = 600):
    """One component: full columns at even indices, joined alternately at
    the top and the bottom row through the odd column between them."""
    seeds = np.zeros((n, h), bool)
    seeds[:, 0:h - 2:2] = True
    for j, c in enumerate(range(1, h - 3, 2)):
        seeds[0 if j % 2 == 0 else n - 1, c] = True
    return seeds, np.ones((n, h), bool), np.ones((n - 1, h), bool)


def scan39():
    d = np.load(DATA / "ccl_vlp16_scan39.npz")
    return d["seeds"], d["conn_h"], d["conn_v"]


CASES = {"snake": snake, "vlp16_scan39": scan39}


@pytest.mark.parametrize("plain", list(PLAIN))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_sweeps_reach_the_bfs_labels_and_a_cap_stops_them(case,
                                                               plain):
    seeds, ch, cv = CASES[case]()
    want = bfs_labels(seeds, ch, cv)
    n, h = seeds.shape
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (seeds, ch, cv)]
    *got, sweeps = PLAIN[plain](*args, n * h)
    assert sweeps > CAP
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    *capped, sweeps = PLAIN[plain](*args, CAP)
    assert sweeps == CAP
    assert not np.array_equal(capped[0].numpy(), want[0])
