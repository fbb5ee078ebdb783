"""Kernel K3: brute-force k-NN with AABB chunk culling.

Replaces the Pallas kernel ``legoloam_tpu/ops/knn_pallas.py::_knn_kernel``
(wrapper ``knn_pallas``).  Contract, shared with the plain version
(``voxel.knn``):

  * squared Euclidean distances, ascending, with their reference indices;
  * invalid references are never returned; invalid queries get all-1e30
    rows;
  * ``gate`` (metres): a tile of queries skips every reference chunk whose
    bounding box lies farther than ``gate`` from each of its valid queries,
    so results are exact for every query whose k-th neighbour lies within
    ``gate``; ``gate=None`` culls nothing (exact everywhere).

The CUDA kernel (``csrc/knn.cu``) computes every distance in difference form
in float32 and selects by the pair (distance, index), so ties go to the lower
index and the result is the exact search's (``knn_exact``) whatever the
split of the work; neither the packed-int32 selection nor the exact re-sort
of the JAX kernel is needed.  Both inputs are recentred on the valid-reference
box first, as the plain version does, so the two return bit-identical
distances for the same neighbours.  Slots beyond the number of valid
references hold (1e30, 0).
"""

from __future__ import annotations

import torch

from . import _native
from . import voxel
from .voxel import BIG, recentre

KERNEL = _native.register(
    "knn", "legoloam_tpu_torch/csrc/knn.cu",
    "legoloam_tpu/ops/knn_pallas.py:44")

TQ = 32          # queries per block (one per lane); fixed in csrc/knn.cu
WARPS = 32       # warps per block, each searching its own chunks
RC = 64          # references per chunk; fixed in csrc/knn.cu
MAX_K = 8
# Tiling of ``tile_pairs``: the first kernel's 64-query tiles and
# 256-reference chunks.
TILE_TQ, TILE_RC = 64, 256


def knn_plain(query, q_valid, ref, r_valid, k: int):
    """Plain version of K3: the JAX package's k-NN (``voxel.knn``); with
    no valid query, the contract's (1e30, 0) rows without a search, as the
    kernel skips every tile then (a search after an iterative solve
    stopped)."""
    if not bool(torch.any(q_valid)):
        return (torch.full((query.shape[0], k), BIG, device=query.device),
                torch.zeros((query.shape[0], k), dtype=torch.int64,
                            device=query.device))
    return voxel.knn(query, q_valid, ref, r_valid, k)


def chunk_boxes(ref: torch.Tensor, r_valid: torch.Tensor, rc: int = RC):
    """Per-chunk bounding boxes of the valid references (empty chunks get
    lo=+inf, hi=-inf and are culled by any gate).  Plain version of the
    kernel's ``knn_boxes`` pass."""
    r_n = ref.shape[0]
    n_chunks = (r_n + rc - 1) // rc
    pad = n_chunks * rc - r_n
    inf = torch.full_like(ref, float("inf"))
    lo = torch.where(r_valid[:, None], ref, inf)
    hi = torch.where(r_valid[:, None], ref, -inf)
    if pad:
        lo = torch.cat([lo, inf[:1].expand(pad, 3)])
        hi = torch.cat([hi, -inf[:1].expand(pad, 3)])
    return (lo.reshape(n_chunks, rc, 3).amin(1).contiguous(),
            hi.reshape(n_chunks, rc, 3).amax(1).contiguous())


def gated_pairs(query, q_valid, ref, r_valid, gate: float | None,
                q_block: int = 1024) -> int:
    """(valid query, valid reference) pairs whose recentred difference-form
    float32 squared distance is at most ``gate ** 2``; every valid pair with
    ``gate=None``.  The least work of the search's contract, whatever
    implements it: the yardstick of K3's bound."""
    if gate is None:
        return int(q_valid.sum()) * int(r_valid.sum())
    q, r = recentre(query, ref, r_valid)
    q, r = q[q_valid], r[r_valid]
    n = 0
    for s in range(0, q.shape[0], q_block):
        diff = q[s:s + q_block, None] - r[None]
        d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
            + diff[..., 2] * diff[..., 2]
        n += int((d <= gate ** 2).sum())
    return n


def tile_pairs(query, q_valid, ref, r_valid, gate: float | None,
               tq: int = TILE_TQ, rc: int = TILE_RC) -> int:
    """(query, reference) pairs that a search tiled by ``tq`` consecutive
    queries and ``rc`` consecutive references computes: ``tq * rc`` for each
    (tile, chunk) pair whose tile holds a valid query and whose chunk holds a
    valid reference and, with ``gate``, whose boxes (in the recentred frame)
    lie within ``gate``.  A diagnostic: the first kernel's work under its
    tile-box culling."""
    q, r = recentre(query, ref, r_valid)
    lo, hi = chunk_boxes(r, r_valid, rc)
    qlo, qhi = chunk_boxes(q, q_valid, tq)
    keep = (qlo[:, 0] <= qhi[:, 0])[:, None] & (lo[:, 0] <= hi[:, 0])[None]
    if gate is not None:
        g = torch.clamp(torch.maximum(qlo[:, None] - hi[None],
                                      lo[None] - qhi[:, None]), min=0.0)
        g = g * g
        keep &= (g[..., 0] + g[..., 1]) + g[..., 2] <= gate ** 2
    return int(keep.sum()) * tq * rc


def knn_exact(query, q_valid, ref, r_valid, k: int, q_block: int = 1024):
    """The exact search of K3's contract: recentred difference-form float32
    distances (rounded as the kernel rounds them), a stable sort so ties go
    to the lower index, (1e30, 0) in slots beyond the valid references and
    in every slot of an invalid query.  Returns (d (Q, k), i (Q, k) int64).
    A reference for tests; the port never calls it."""
    q, r = recentre(query, ref, r_valid)
    out_d, out_i = [], []
    for s in range(0, q.shape[0], q_block):
        qb = q[s:s + q_block]
        dx = qb[:, None, 0] - r[None, :, 0]
        dy = qb[:, None, 1] - r[None, :, 1]
        dz = qb[:, None, 2] - r[None, :, 2]
        d = (dx * dx + dy * dy) + dz * dz
        d = torch.where(r_valid[None], d, torch.full_like(d, float("inf")))
        d, i = torch.sort(d, dim=1, stable=True)
        d, i = d[:, :k], i[:, :k]
        if d.shape[1] < k:
            pad = k - d.shape[1]
            d = torch.cat([d, d.new_full((d.shape[0], pad), float("inf"))], 1)
            i = torch.cat([i, i.new_zeros((i.shape[0], pad))], 1)
        empty = torch.isinf(d) | ~q_valid[s:s + q_block, None]
        out_d.append(torch.where(empty, torch.full_like(d, BIG), d))
        out_i.append(torch.where(empty, torch.zeros_like(i), i))
    return torch.cat(out_d), torch.cat(out_i)


def knn(query: torch.Tensor, q_valid: torch.Tensor, ref: torch.Tensor,
        r_valid: torch.Tensor, k: int, gate: float | None = None,
        visited: torch.Tensor | None = None):
    """(sq_dists (Q, k) float32, indices (Q, k) int64).

    CPU tensors take the plain version (which ignores ``gate``: it is exact
    everywhere); CUDA tensors launch ``csrc/knn.cu`` (or raise).
    ``visited``, an optional int64 CUDA tensor of one element, is
    incremented by the number of (query tile, reference chunk) pairs whose
    distances the kernel computed."""
    if query.device.type == "cpu":
        return knn_plain(query, q_valid, ref, r_valid, k)
    q_n, r_n = query.shape[0], ref.shape[0]
    _native.require(1 <= k <= MAX_K, f"knn: k must be in [1, {MAX_K}]")
    _native.require(query.dtype == torch.float32
                    and ref.dtype == torch.float32, "knn: float32 points")
    _native.require(q_valid.dtype == torch.bool and r_valid.dtype
                    == torch.bool, "knn: bool validity masks")
    _native.require(query.shape == (q_n, 3) and ref.shape == (r_n, 3)
                    and q_valid.shape == (q_n,) and r_valid.shape == (r_n,),
                    "knn: query (Q, 3), ref (R, 3), masks (Q,), (R,)")
    q, qv = query.contiguous(), q_valid.contiguous()
    r, rv = ref.contiguous(), r_valid.contiguous()
    # The kernel stages references with 16-byte asynchronous copies.
    r, rv = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (r, rv))
    tensors = [q, qv, r, rv]
    if visited is not None:
        _native.require(visited.dtype == torch.int64
                        and visited.numel() == 1, "knn: visited is int64 (1,)")
        tensors.append(visited)
    _native.require_cuda(*tensors)
    n_chunks = (r_n + RC - 1) // RC
    boxes = torch.empty(2 * n_chunks * 3, dtype=torch.float32, device=q.device)
    d = torch.empty((q_n, k), dtype=torch.float32, device=q.device)
    i = torch.empty((q_n, k), dtype=torch.int64, device=q.device)
    gate_sq = float(gate) ** 2 if gate is not None else 0.0
    err = _native.library().knn_launch(
        q.data_ptr(), qv.data_ptr(), r.data_ptr(), rv.data_ptr(),
        boxes.data_ptr(), boxes.data_ptr() + 12 * n_chunks, d.data_ptr(),
        i.data_ptr(),
        visited.data_ptr() if visited is not None else None,
        q_n, r_n, k, gate_sq, int(gate is not None),
        _native.stream_handle(q))
    _native.check(err, "knn")
    KERNEL.launches += 1
    return d, i
