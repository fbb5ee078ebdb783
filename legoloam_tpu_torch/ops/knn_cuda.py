"""Kernel K3: brute-force k-NN with AABB chunk culling.

Replaces the Pallas kernel ``legoloam_tpu/ops/knn_pallas.py::_knn_kernel``
(wrapper ``knn_pallas``).  Contract, shared with the plain version
(``voxel.knn``):

  * squared Euclidean distances, ascending, with their reference indices;
  * invalid references are never returned; invalid queries get all-1e30
    rows;
  * ``gate`` (metres): reference chunks whose bounding box lies farther than
    ``gate`` from the query tile's bounding box are skipped, so results are
    exact for every query whose k-th neighbour lies within ``gate``;
    ``gate=None`` culls nothing (exact everywhere).

The CUDA kernel (``csrc/knn.cu``) computes every distance in difference form
in float32 and keeps a sorted per-thread top-k (ties to the lower index), so
neither the packed-int32 selection nor the exact re-sort of the JAX kernel is
needed.  Both inputs are recentred on the valid-reference box first, as the
plain version does, so the two return bit-identical distances for the same
neighbours.  Slots beyond the number of valid references hold (1e30, 0).
"""

from __future__ import annotations

import torch

from . import _native
from .voxel import knn as knn_plain
from .voxel import recentre

KERNEL = _native.register(
    "knn", "legoloam_tpu_torch/csrc/knn.cu",
    "legoloam_tpu/ops/knn_pallas.py:44")

TQ = 64          # queries per block (one per thread); fixed in csrc/knn.cu
RC = 256         # references per shared-memory chunk
MAX_K = 8


def chunk_boxes(ref: torch.Tensor, r_valid: torch.Tensor, rc: int = RC):
    """Per-chunk bounding boxes of the valid references (empty chunks get
    lo=+inf, hi=-inf and are culled by any gate)."""
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
    q, r = recentre(query, ref, r_valid)
    q, r = q.contiguous(), r.contiguous()
    qv, rv = q_valid.contiguous(), r_valid.contiguous()
    lo, hi = chunk_boxes(r, rv)
    tensors = [q, qv, r, rv, lo, hi]
    if visited is not None:
        _native.require(visited.dtype == torch.int64
                        and visited.numel() == 1, "knn: visited is int64 (1,)")
        tensors.append(visited)
    _native.require_cuda(*tensors)
    d = torch.empty((q_n, k), dtype=torch.float32, device=q.device)
    i = torch.empty((q_n, k), dtype=torch.int32, device=q.device)
    gate_sq = float(gate) ** 2 if gate is not None else 0.0
    err = _native.library().knn_launch(
        q.data_ptr(), qv.data_ptr(), r.data_ptr(), rv.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), d.data_ptr(), i.data_ptr(),
        visited.data_ptr() if visited is not None else None,
        q_n, r_n, k, RC, gate_sq, int(gate is not None),
        _native.stream_handle(q))
    _native.check(err, "knn")
    KERNEL.launches += 1
    return d, i.long()
