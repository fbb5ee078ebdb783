"""Per-scan debug dumps, the reference's RViz debug publishers offline (port
of ``legoloam_tpu/utils/debugdump.py``; reference
``src/imageProjection.cpp:463-507``, ``src/mapOptmization.cpp:692-800``).

When enabled, every Nth scan re-runs the frontend with the debug capture and
writes one compressed npz of the stage internals (range image, ground mask,
cluster labels, curvature, pick labels, feature clouds) and the mapping
diagnostics, under the JAX package's record names.  The capture runs on the
scan's device through the same kernels as the main path (K1 in the
segmentation, K2 for the pick labels on a CUDA tensor).  When disabled the
dumper costs nothing, like an unsubscribed topic.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .io import to_numpy


def capture_frontend(points, valid, ring, cfg):
    """Re-run the frontend on one scan, returning the dense stage internals
    (the reference's fullCloud / groundCloud / segmentedCloudPure /
    outlierCloud debug set, plus the feature pick labels)."""
    from ..ops import features as feat_ops
    from ..ops import projection, segmentation

    img = projection.project_scan(points, valid, cfg.sensor, ring=ring)
    seg = segmentation.segment(img, cfg.sensor, cfg.seg)
    feats, dbg = feat_ops.extract_features(img, seg, cfg.sensor, cfg.feat,
                                           return_debug=True)
    return {
        "range": img.rng,                   # (N, H) f32
        "xyz": img.xyz,                     # (N, H, 3)
        "img_valid": img.valid,             # (N, H)
        "ground": seg.ground,               # (N, H) ground mask
        "labels": seg.label,                # (N, H) cluster labels
        "segmented": seg.segmented,         # (N, H) kept-for-features mask
        "outlier": seg.outlier,             # (N, H) thinned outlier mask
        "curvature": dbg.curvature,         # (N, H) compacted layout
        "pick_label": dbg.label,            # (N, H) 2/1/-1/0 compacted
        "sharp_xyz": feats.sharp.xyz, "sharp_valid": feats.sharp.valid,
        "flat_xyz": feats.flat.xyz, "flat_valid": feats.flat.valid,
        "feat_overflow": feats.overflow,
    }


class DebugDumper:
    """Subscriber-gated dump driver: ``DebugDumper(out_dir, every=50)``,
    then ``maybe_dump(k, scan, cfg, state=..., diag=...)`` in the replay
    loop.  ``enabled=False`` or ``out_dir=None`` makes every call a no-op.
    Each dump re-runs the frontend (the main path's outputs stay untouched)
    and stores mapping-state scalars when given."""

    def __init__(self, out_dir: Optional[str], every: int = 50,
                 enabled: bool = True):
        self.out_dir = out_dir
        self.every = max(int(every), 1)
        self.enabled = bool(enabled) and out_dir is not None
        if self.enabled:
            os.makedirs(out_dir, exist_ok=True)

    def due(self, k: int) -> bool:
        return self.enabled and k % self.every == 0

    def maybe_dump(self, k: int, scan, cfg, state=None, diag=None) -> bool:
        if not self.due(k):
            return False
        rec = {name: to_numpy(a)
               for name, a in capture_frontend(*scan, cfg).items()}
        if state is not None:
            kf = state.mapping.kf
            n_kf = int(kf.count)
            rec["kf_t"] = to_numpy(kf.t[:max(n_kf, 1)])
            rec["kf_count"] = n_kf
            rec["kf_overflow"] = int(kf.overflow)
            cache = state.mapping.cache
            rec["submap_corner_occ"] = int(cache.c_valid.sum())
            rec["submap_surf_occ"] = int(cache.s_valid.sum())
            rec["submap_origin"] = to_numpy(cache.origin)
            rec["loop_count"] = int(state.loops.count)
            rec["loop_dropped"] = int(state.loops.dropped)
        if diag is not None:
            for f in diag._fields:
                rec[f"diag_{f}"] = to_numpy(getattr(diag, f))
        path = os.path.join(self.out_dir, f"scan_{k:06d}.npz")
        with open(path, "wb") as f:
            np.savez_compressed(f, **rec)
        return True
