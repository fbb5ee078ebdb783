"""Data-parallel frontend: independent scans spread over the ranks (port of
``legoloam_tpu/parallel/frontend_dp.py``).

The per-scan frontend (projection -> segmentation with K1 -> features with
K2) has no cross-scan state, so a batch of recorded scans splits over the
ranks in blocks, each rank running its scans with no communication.
"""

from __future__ import annotations

import torch

from ..config import PipelineConfig
from ..models.pipeline import _stack, process_scan
from .mesh import Mesh


def make_batched_frontend(cfg: PipelineConfig, mesh: Mesh):
    """Returns ``fn(points (B, P, 3), valid (B, P), ring (B, P))`` ->
    (``ScanFeatures`` of this rank's ``B / n`` scans stacked on axis 0,
    their batch indices).  Rank r takes scans ``r*B/n .. (r+1)*B/n - 1``;
    ``B`` must be a multiple of the world size, as the JAX package's
    batch sharding requires."""

    def fn(points, valid, ring):
        b = points.shape[0]
        if b % mesh.size:
            raise ValueError(f"batch of {b} scans over {mesh.size} ranks: "
                             "the batch must divide by the world size")
        per = b // mesh.size
        idx = torch.arange(mesh.rank * per, (mesh.rank + 1) * per)
        feats = [process_scan(*(torch.as_tensor(a[i], device=mesh.device)
                                for a in (points, valid, ring)), cfg)
                 for i in idx.tolist()]
        return _stack(feats), idx

    return fn
