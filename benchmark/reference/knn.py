"""The exact k-NN search (frozen copy of ``knn_exact`` in
``legoloam_tpu_torch/ops/knn_cuda.py``): squared distances in difference
form on points recentred on the valid-reference box, ascending, ties to the
lower index; invalid queries and slots beyond the valid references hold
(1e30, 0)."""

from __future__ import annotations

import torch

from .voxel import BIG, recentre


def knn_exact(query, q_valid, ref, r_valid, k: int, q_block: int = 1024):
    """The exact search of K3's contract: recentred difference-form float32
    distances (rounded as the kernel rounds them), a stable sort so ties go
    to the lower index, (1e30, 0) in slots beyond the valid references and
    in every slot of an invalid query.  Returns (d (Q, k), i (Q, k) int64).
    The mapping's 5-NN: the port's kernel K3 returns this search's result
    for every query whose 5th neighbour lies within its gate, and a query
    beyond it is rejected by both."""
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

