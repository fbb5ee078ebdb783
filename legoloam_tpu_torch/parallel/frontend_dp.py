"""Data-parallel frontend: independent scans spread over the ranks (port of
``legoloam_tpu/parallel/frontend_dp.py``).

The per-scan frontend (projection -> segmentation with K1 -> features with
K2) has no cross-scan state, so a batch of recorded scans (offline map
building from a recorded sequence) splits over the ranks in blocks, each
rank running its scans with no communication.  A rank's block goes through
the batched frontend (``pipeline.process_scans``) as one program
(``step_graph.FrontendGraph``): on the card one captured graph a call, with
K1 and K2 each launched once for the whole block — the counterpart of the
JAX package's ``jit(vmap(process_scan))``.
"""

from __future__ import annotations

import torch

from ..config import PipelineConfig
from ..models.step_graph import FrontendGraph
from .mesh import Mesh


def make_batched_frontend(cfg: PipelineConfig, mesh: Mesh):
    """Returns ``fn(points (B, P, 3), valid (B, P), ring (B, P))`` ->
    (``ScanFeatures`` of this rank's ``B / n`` scans stacked on axis 0,
    their batch indices).  Rank r takes scans ``r*B/n .. (r+1)*B/n - 1``;
    ``B`` must be a multiple of the world size, as the JAX package's
    batch sharding requires.  The returned features are the caller's:
    later calls do not overwrite them.  ``fn.program`` is the rank's
    ``FrontendGraph`` (its runner counts replays and host reads)."""
    program = FrontendGraph(cfg, mesh.device)

    def fn(points, valid, ring):
        b = points.shape[0]
        if b % mesh.size:
            raise ValueError(f"batch of {b} scans over {mesh.size} ranks: "
                             "the batch must divide by the world size")
        per = b // mesh.size
        lo = mesh.rank * per
        feats = program(points[lo:lo + per], valid[lo:lo + per],
                        ring[lo:lo + per])
        return feats, torch.arange(lo, lo + per)

    fn.program = program
    return fn
