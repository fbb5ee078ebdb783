"""Sharded keyframe map: submap assembly and the scan-to-map solve over the
ranks (port of ``legoloam_tpu/parallel/mapping_dist.py``).

The keyframe axis of a ``KeyframeStore`` is split CYCLICALLY: keyframe k
lives on rank k % n, local slot k // n.  Keyframes are trajectory-ordered,
so a radius submap selects a contiguous index run; cyclic placement spreads
it evenly over the ranks (block placement would put it on one or two ranks,
whose per-rank caps would truncate it).  Port-only: the slots are padded to
``ceil(M / n)`` a rank, so ``M`` need not divide by ``n``.

``extract_submap_sharded`` is the older per-rank selection, kept as the JAX
file has it (``pipeline_dist.extract_submap_dist`` selects globally);
``scan_to_map_sharded`` splits the scan rows over the ranks with the submap
replicated, and all-reduces the residual counts and normal equations of
every LM iteration through ``mapping.scan_to_map``'s ``reduce_fn``; its
decisions are read through ``Mesh.read``.
"""

from __future__ import annotations

import math

import torch

from ..config import MappingConfig
from ..models import mapping as mapping_mod
from ..models.mapping import KeyframeStore, dedup_positions
from ..ops import se3
from ..ops.se3 import Pose
from ..ops.voxel import voxel_downsample
from .mesh import Mesh, pad_rows


def local_slots(m: int, n: int) -> int:
    """Keyframe slots a rank holds for an ``m``-keyframe store over ``n``
    ranks."""
    return -(-m // n)


def cyclic_rows(a: torch.Tensor, mesh: Mesh, fill=0) -> torch.Tensor:
    """This rank's rows of a keyframe-axis array: keyframes rank, rank + n,
    ..., padded with ``fill`` to ``local_slots`` rows, on the rank's
    device."""
    m_loc = local_slots(a.shape[0], mesh.size)
    return pad_rows(a[mesh.rank::mesh.size], m_loc, fill).to(mesh.device)


def shard_keyframes(kf: KeyframeStore, mesh: Mesh) -> KeyframeStore:
    """This rank's cyclic shard of a single-device store: every
    keyframe-axis array cut to its local slots (keyframe rank + i*n in slot
    i; padding slots hold identity rotations and nothing valid);
    ``count`` and ``overflow`` replicated."""
    eye = torch.eye(3, dtype=kf.R.dtype)
    return KeyframeStore(**{
        name: (a.to(mesh.device) if a.dim() == 0 else cyclic_rows(
            a, mesh, eye if name in ("R", "chain_R") else 0))
        for name, a in zip(kf._fields, kf)})


def _first_k(score: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest ``score``, ties to the lower
    index (``lax.top_k``'s order)."""
    vals, order = torch.sort(score, descending=True, stable=True)
    return vals[:k], order[:k]


def extract_submap_sharded(kf: KeyframeStore, center, cfg: MappingConfig,
                           mesh: Mesh, submap_kf: int = 64):
    """Distributed ``mapping.extract_submap`` by per-rank selection:
    each rank picks its nearest position-deduped in-radius keyframes among
    its own, voxelises them to ``cap / n`` and the ranks' submaps are
    concatenated in rank order.  ``kf`` is this rank's shard
    (``shard_keyframes``).  Returns ((corner (C, 3), valid), (surf (S, 3),
    valid)), replicated."""
    n = mesh.size
    m_loc = kf.t.shape[0]
    dev = kf.t.device
    local_sel = max(1, min(submap_kf // n, m_loc))
    c_cap = cfg.submap_corner_cap // n
    s_cap = cfg.submap_surf_cap // n
    gidx = torch.arange(m_loc, device=dev) * n + mesh.rank
    ok = gidx < kf.count
    d2 = torch.sum((kf.t - center[None]) ** 2, dim=-1)
    within = ok & (d2 <= cfg.search_radius ** 2)
    rep = dedup_positions(kf.t, within, center, cfg.surrounding_leaf)
    d2 = torch.where(rep, d2, torch.full_like(d2, math.inf))
    neg, sel = _first_k(-d2, local_sel)
    sel_ok = (-neg) <= cfg.search_radius ** 2

    def gather(cloud, valid, cap, leaf):
        world = se3.transform_points(Pose(kf.R[sel], kf.t[sel]), cloud[sel])
        v = valid[sel] & sel_ok[:, None]
        pts, pv = voxel_downsample(world.reshape(-1, 3), v.reshape(-1),
                                   leaf, cap, origin=center)
        return (mesh.all_gather(pts).reshape(-1, 3),
                mesh.all_gather(pv).reshape(-1))

    return (gather(kf.corner, kf.corner_valid, c_cap, cfg.corner_leaf),
            gather(kf.surf, kf.surf_valid, s_cap, cfg.surf_leaf))


def block_rows(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of rows of ``a`` (``ceil(len / n)`` rows, the
    last rank's padded with zeros: no point, not valid)."""
    per = -(-a.shape[0] // mesh.size)
    return pad_rows(a[mesh.rank * per:(mesh.rank + 1) * per], per)


def scan_to_map_sharded(guess: Pose, corner, corner_valid, surf, surf_valid,
                        sub_c, sub_cv, sub_s, sub_sv, cfg: MappingConfig,
                        mesh: Mesh):
    """Distributed ``mapping.scan_to_map``: given the replicated scan
    clouds, each rank solves with its block of the scan rows against the
    replicated submap, the residual counts and 6x6 normal equations of every
    iteration all-reduced, so every rank applies the same update (each
    decision read through ``Mesh.read``).  Returns
    (pose, iterations, n corner residuals, n surf residuals), replicated —
    the single-device result up to the order of the float sums."""
    return mapping_mod.scan_to_map(
        guess, block_rows(corner, mesh), block_rows(corner_valid, mesh),
        block_rows(surf, mesh), block_rows(surf_valid, mesh),
        sub_c, sub_cv, sub_s, sub_sv, cfg, reduce_fn=mesh.all_reduce,
        read_fn=mesh.read)
