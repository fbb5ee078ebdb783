"""Voxel-grid downsampling and nearest-neighbour search (port of
``legoloam_tpu/ops/voxel.py``).

  * ``voxel_downsample``: sort-based centroid-per-voxel (PCL VoxelGrid
    equivalent), keyed by a 32-bit spatial hash or, with ``origin``, a 30-bit
    Morton code (spatially sorted output, collision-free within range).
    Keys are the JAX package's uint32 values, carried in int64 with the
    wrap-around reproduced by ``& 0xFFFFFFFF``.
  * ``voxel_representative``: one input point per hash slot (the ICP
    target clouds of loop closure and relocalization).
  * ``class_nn``: nearest reference within a key class (the odometry's
    ring-windowed correspondence search), in the JAX package's matrix form.
  * ``knn``: the plain k-pass k-NN — the plain version of kernel K3
    (``knn_cuda``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .device import const

BIG = 1e30
_U32 = 0xFFFFFFFF


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as a true division on every device (CUDA divides by a
    Python scalar as a multiply by its reciprocal, which moves floor/round
    boundaries by an ulp)."""
    return x / const(s, x.device, x.dtype)


def voxel_cells(points: torch.Tensor, leaf: float) -> torch.Tensor:
    """Integer voxel coordinates ``floor(points / leaf)`` as int32."""
    return torch.floor(div(points, leaf)).to(torch.int32)


def _hash_voxel(ijk: torch.Tensor) -> torch.Tensor:
    """3D int cell coords -> the JAX package's uint32 spatial hash
    (Teschner et al. 2003 primes), as int64."""
    u = ijk.to(torch.int64) & _U32
    return (((u[..., 0] * 73856093) & _U32) ^ ((u[..., 1] * 19349663) & _U32)
            ^ ((u[..., 2] * 83492791) & _U32))


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _morton_voxel(ijk: torch.Tensor) -> torch.Tensor:
    """3D int cell coords -> 30-bit Morton key (clamped to [0, 1024) after
    a +512 shift), as int64."""
    u = torch.clamp(ijk.to(torch.int64) + 512, 0, 1023)
    return (_part1by2(u[..., 0]) | (_part1by2(u[..., 1]) << 1)
            | (_part1by2(u[..., 2]) << 2))


def _group_ids(keys: torch.Tensor, valid: torch.Tensor, cap: int):
    """Stable sort by key (invalid last) -> (order, group id per sorted row
    with rows beyond ``cap`` or invalid sent to ``cap``, sorted validity,
    number of occupied voxels)."""
    # Invalid rows strictly after every valid key, so the ids are sorted.
    h = torch.where(valid, keys, torch.full_like(keys, _U32 + 1))
    hs, order = torch.sort(h, stable=True)
    vs = valid[order]
    new_group = torch.cat([torch.ones(1, dtype=torch.bool, device=h.device),
                           hs[1:] != hs[:-1]]) & vs
    gid = torch.cumsum(new_group.to(torch.int32), 0) - 1
    gid = torch.where(vs & (gid < cap) & (gid >= 0), gid,
                      torch.full_like(gid, cap))
    return order, gid.long(), vs, torch.sum(new_group).to(torch.int32)


def _voxel_sums(rows: torch.Tensor, gid: torch.Tensor, cap: int):
    """(cap, D) sums of ``rows`` by their sorted group id (ids >= ``cap``
    dropped), each group's rows added in order from 0, as the JAX package's
    scatter-add and the CPU's ``index_add_`` take them.  A segment sum over
    the runs of the sorted ids: on the card ``index_add_`` adds with float
    atomics in no fixed order, so a step would not repeat bitwise."""
    starts = torch.searchsorted(gid, torch.arange(cap + 1, device=gid.device))
    return torch.segment_reduce(rows, "sum", lengths=starts[1:] - starts[:-1],
                                unsafe=True)


def voxel_downsample(points, valid, leaf: float, cap: int, origin=None,
                     return_counts: bool = False, weights=None,
                     return_overflow: bool = False):
    """Centroid-per-voxel downsampling.  Returns (out (cap, 3), out_valid
    (cap,)) [+ counts (cap,)] [+ overflow ()].  With ``origin`` the voxels
    key by a Morton code relative to it (Z-ordered output); ``weights``
    merges pre-aggregated centroids (weighted centroid, associative)."""
    rel = points - origin if origin is not None else points
    ijk = voxel_cells(rel, leaf)
    key = _morton_voxel(ijk) if origin is not None else _hash_voxel(ijk)
    order, gid, vs, n_groups = _group_ids(key, valid, cap)
    vf = valid.to(points.dtype)
    w = vf if weights is None else weights * vf
    ps, wf = points[order], w[order]
    acc = _voxel_sums(torch.cat([ps * wf[:, None], wf[:, None]], dim=1), gid,
                      cap)
    sums, counts = acc[:, :3], acc[:, 3]
    out_valid = counts > 0
    out = sums / torch.clamp(counts, min=1e-9)[:, None]
    res = (out * out_valid[:, None], out_valid)
    if return_counts:
        res = res + (counts,)
    if return_overflow:
        res = res + (torch.clamp(n_groups - cap, min=0),)
    return res


def voxel_downsample_with_payload(points, payload, valid, leaf: float,
                                  cap: int, return_overflow: bool = False):
    """As ``voxel_downsample`` (hash keys) but also averages a per-point
    payload (K,) or (K, D) over each voxel."""
    key = _hash_voxel(voxel_cells(points, leaf))
    order, gid, vs, n_groups = _group_ids(key, valid, cap)
    pay2 = payload if payload.ndim > 1 else payload[:, None]
    pd = pay2.shape[1]
    vf = valid.to(points.dtype)[order]
    ps, pay_s = points[order], pay2.to(points.dtype)[order]
    acc = _voxel_sums(torch.cat([ps * vf[:, None], pay_s * vf[:, None],
                                 vf[:, None]], dim=1), gid, cap)
    sums, psums, counts = acc[:, :3], acc[:, 3:3 + pd], acc[:, 3 + pd]
    out_valid = counts > 0
    c = torch.clamp(counts, min=1.0)
    out = (sums / c[:, None]) * out_valid[:, None]
    outp = (psums / c[:, None]) * out_valid[:, None]
    if payload.ndim == 1:
        outp = outp[:, 0]
    if return_overflow:
        return out, outp, out_valid, torch.clamp(n_groups - cap, min=0)
    return out, outp, out_valid


def voxel_representative(points, valid, leaf: float, cap: int):
    """One representative point per voxel through a ``cap``-slot hash table
    (``cap`` a power of two) and one scatter-min: the lowest input index of
    each slot wins, so the result is deterministic.  Colliding voxels lose
    all but one of their points; for an ICP target cloud that can only raise
    the fitness.  Returns (out (cap, 3), ok (cap,))."""
    if cap & (cap - 1):
        raise ValueError(f"voxel_representative: cap {cap} is not a power "
                         "of two")
    n = points.shape[0]
    dev = points.device
    slot = _hash_voxel(voxel_cells(points, leaf)) & (cap - 1)
    slot = torch.where(valid, slot, torch.full_like(slot, cap))
    rep = torch.full((cap + 1,), n, dtype=torch.int64, device=dev)
    rep.scatter_reduce_(0, slot, torch.arange(n, device=dev), "amin")
    rep = rep[:cap]
    ok = rep < n
    out = points[torch.where(ok, rep, torch.zeros_like(rep))]
    return out * ok[:, None], ok


def class_nn(query, ref, r_valid, ref_key, key_lo, key_hi, excl_le,
             q_tile: int = 512, n_classes: int = 1):
    """Per-query nearest reference within a KEY CLASS: for class c, query q,
    the nearest ref with ``key_lo[c, q] <= ref_key <= key_hi[c, q]`` and
    squared distance > ``excl_le[c, q]``.  Returns (sq_dists (C, Q),
    indices (C, Q) int64)."""
    q_n = query.shape[0]
    ref_m = torch.where(r_valid[:, None], ref, torch.full_like(ref, 1e6))
    r_sq = torch.sum(ref_m * ref_m, dim=-1)
    q_sq = torch.sum(query * query, dim=-1)
    out_d, out_i = [], []
    for qs in range(0, q_n, q_tile):
        qe = min(qs + q_tile, q_n)
        qb, qsq = query[qs:qe], q_sq[qs:qe]
        d = qsq[:, None] - 2.0 * (qb @ ref_m.T) + r_sq[None, :]
        ds, is_ = [], []
        for c in range(n_classes):
            lo = key_lo[c, qs:qe, None]
            hi = key_hi[c, qs:qe, None]
            ex = excl_le[c, qs:qe, None]
            pen = ((ref_key[None, :] < lo) | (ref_key[None, :] > hi)
                   | (d <= ex)).to(d.dtype) * BIG
            dv, am = torch.min(d + pen, dim=1)
            ds.append(dv)
            is_.append(am)
        out_d.append(torch.stack(ds))
        out_i.append(torch.stack(is_))
    dists = torch.cat(out_d, dim=1)
    return torch.clamp(dists, min=0.0), torch.cat(out_i, dim=1)


def recentre(query, ref, r_valid):
    """Both point sets relative to the centre of the valid-reference box:
    the matrix-form distance error grows with the square of the coordinate
    magnitude, so selection works in submap-local coordinates."""
    inf = torch.full_like(ref, float("inf"))
    lo = torch.amin(torch.where(r_valid[:, None], ref, inf), dim=0)
    hi = torch.amax(torch.where(r_valid[:, None], ref, -inf), dim=0)
    c = torch.where(torch.any(r_valid), 0.5 * (lo + hi), torch.zeros_like(lo))
    return query - c, ref - c


def knn(query, q_valid, ref, r_valid, k: int, q_tile: int = 2048):
    """k nearest references per query by squared distance, the JAX
    package's k fused matmul passes: recentre on the valid-reference AABB,
    select by the matrix-form distance excluding earlier picks, then
    recompute the winners' distances in difference form and re-sort.
    Returns (sq_dists (Q, k), indices (Q, k) int64); invalid queries get
    all-1e30 rows.  Plain version of kernel K3 (``knn_cuda.knn``).  On the
    CPU a query tile holds at most 2^20 distances, so it stays in cache."""
    q_n = query.shape[0]
    if not query.is_cuda:
        q_tile = max(1, min(q_tile, (1 << 20) // max(ref.shape[0], 1)))
    query, ref = recentre(query, ref, r_valid)
    ref_m = torch.where(r_valid[:, None], ref, torch.full_like(ref, 1e6))
    r_sq = torch.sum(ref_m * ref_m, dim=-1)
    q_sq = torch.sum(query * query, dim=-1)
    out_d, out_i = [], []
    for qs in range(0, q_n, q_tile):
        qe = min(qs + q_tile, q_n)
        d = query[qs:qe] @ ref_m.T
        d.mul_(-2.0).add_(q_sq[qs:qe, None]).add_(r_sq[None, :])
        ds, is_ = [], []
        for j in range(k):
            # Pick j excludes everything at or below pick j-1's distance.
            dv, am = torch.min(d if j == 0 else torch.where(
                d <= ds[-1][:, None], d + BIG, d), dim=1)
            ds.append(dv)
            is_.append(am)
        out_d.append(torch.stack(ds, dim=1))
        out_i.append(torch.stack(is_, dim=1))
    dists = torch.cat(out_d, dim=0)
    idxs = torch.cat(out_i, dim=0)
    diff = query[:, None, :] - ref_m[idxs]
    d_exact = torch.sum(diff * diff, dim=-1)
    d_exact = torch.where(dists >= BIG, torch.full_like(d_exact, BIG),
                          d_exact)
    d_exact, order = torch.sort(d_exact, dim=1, stable=True)
    idxs = torch.gather(idxs, 1, order)
    dists = d_exact + torch.where(q_valid, 0.0, BIG)[:, None]
    return torch.clamp(dists, min=0.0), idxs
