"""Kernel K2: curvature, occlusion marks and sectioned greedy feature picks.

Replaces the Pallas kernel ``legoloam_tpu/ops/features_pallas.py::
_pick_kernel`` (wrapper ``pick_labels_pallas``).  Input: the per-ring
compacted channels of ``features._compact_rings`` — ranges (zero beyond each
ring's count), original columns, ground flags, per-ring counts.  Output: the
(N, H) int32 label grid, 2 sharp / 1 less-sharp / -1 flat / 0 rest
(featureAssociation.cpp:621-784):

  * curvature = (Σ_{k=1..5} (r[i+k] + r[i-k]) − 10·r[i])², summed in exactly
    this order (``acc = -10·r``, then ``+ r[i+k]``, then ``+ r[i-k]``) so the
    kernel (built without FMA contraction) rounds like this version;
  * occlusion marks (column gap < 10, range jump > 0.3 m, 6 points) and
    parallel-beam marks;
  * per ring, 6 sections; ``edge_less_per_section`` greedy trips of the
    highest-curvature non-ground edge (label 2 for the first
    ``edge_per_section``, then 1), then ``surf_per_section`` trips of the
    lowest-curvature ground point (label −1); each pick suppresses ±5
    neighbours unless a column gap > 10 intervenes; ties go to the lowest
    index.

The plain version below is the JAX package's XLA trip loop
(``legoloam_tpu/ops/features.py:177-283``), all sections of all rings in
parallel per trip.  Rings are independent, so a batch of scans (B, N, H)
is B*N rings: one kernel launch, or the plain version over B*N rows.
"""

from __future__ import annotations

import torch

from .config import FeatureConfig

_SENT = 1e30


def _shift(a: torch.Tensor, k: int, fill) -> torch.Tensor:
    """Shift along dim 1 by k (positive = look right), constant fill."""
    if k == 0:
        return a
    pad = torch.full((a.shape[0], abs(k)) + tuple(a.shape[2:]), fill,
                     dtype=a.dtype, device=a.device)
    if k > 0:
        return torch.cat([a[:, k:], pad], dim=1)
    return torch.cat([pad, a[:, :k]], dim=1)


def curvature_marks(rng: torch.Tensor, col: torch.Tensor,
                    count: torch.Tensor, cfg: FeatureConfig):
    """The first half of the plain version: (curvature, curv_ok — a full
    curvature window —, picked — occluded or parallel-beam before any
    pick —) on the compacted (N, H) grid.  ``pick_labels_plain`` continues
    from these; the debug capture (``features.extract_features(...,
    return_debug=True)``) reads them."""
    n, h = rng.shape
    dev = rng.device
    idx = torch.arange(h, dtype=torch.int32, device=dev).expand(n, h)
    cnt = count[:, None]
    in_ring = idx < cnt
    halfwin = cfg.curvature_halfwin

    # calculateSmoothness (featureAssociation.cpp:621-641)
    acc = (-2.0 * halfwin) * rng
    for k in range(1, halfwin + 1):
        acc = acc + _shift(rng, k, 0.0) + _shift(rng, -k, 0.0)
    curvature = acc * acc
    curv_ok = in_ring & (idx >= halfwin) & (idx < cnt - halfwin)

    # markOccludedPoints (featureAssociation.cpp:643-678)
    rng_r = _shift(rng, 1, 0.0)
    col_r = _shift(col, 1, 10 ** 6)
    both = in_ring & _shift(in_ring, 1, False)
    col_close = both & (torch.abs(col_r - col) < cfg.occlusion_col_gap)
    occl_self = col_close & (rng > rng_r + cfg.occlusion_range_jump)
    occl_next = col_close & (rng_r > rng + cfg.occlusion_range_jump)
    picked = torch.zeros((n, h), dtype=torch.bool, device=dev)
    for k in range(0, 6):
        picked = picked | _shift(occl_self, k, False)
        picked = picked | _shift(occl_next, -(k + 1), False)
    diff_prev = torch.abs(_shift(rng, -1, 0.0) - rng)
    diff_next = torch.abs(rng_r - rng)
    parallel = (in_ring & (diff_prev > cfg.parallel_beam_frac * rng)
                & (diff_next > cfg.parallel_beam_frac * rng))
    picked = (picked | parallel) & in_ring
    return curvature, curv_ok, picked


def pick_labels_plain(rng: torch.Tensor, col: torch.Tensor,
                      ground: torch.Tensor, count: torch.Tensor,
                      cfg: FeatureConfig) -> torch.Tensor:
    """Plain PyTorch version, on (N, H) grids or a batch (B, N, H)."""
    if rng.dim() == 3:
        rows = (t.flatten(0, 1) for t in (rng, col, ground, count))
        return pick_labels_plain(*rows, cfg).reshape(rng.shape)
    curvature, curv_ok, picked = curvature_marks(rng, col, count, cfg)
    n, h = rng.shape
    dev = rng.device
    halfwin = cfg.curvature_halfwin

    # extractFeatures (featureAssociation.cpp:680-784): sections with 5-pt
    # guards, s = 5, e = count - 6.
    S = cfg.sections
    s = torch.full((n,), halfwin, dtype=torch.int32, device=dev)
    e = count.to(torch.int32) - halfwin - 1
    j = torch.arange(S, dtype=torch.int32, device=dev)
    sp = torch.div(s[:, None] * (S - j) + e[:, None] * j, S,
                   rounding_mode="floor")
    ep = torch.div(s[:, None] * (S - 1 - j) + e[:, None] * (j + 1), S,
                   rounding_mode="floor") - 1
    ep[:, -1] = e - 1
    sec_ok = (sp <= ep) & (e[:, None] > s[:, None])
    sec_lo, sec_hi, lane_ok = (sp.reshape(-1, 1), ep.reshape(-1, 1),
                               sec_ok.reshape(-1, 1))
    pos = torch.arange(h, device=dev)[None, :]
    in_sec = (pos >= sec_lo) & (pos <= sec_hi) & lane_ok   # (n*S, h)
    gap = torch.abs(_shift(col, 1, 10 ** 6) - col) > cfg.occlusion_col_gap

    curv_rep = curvature.repeat_interleave(S, dim=0)

    def lane_pick(mask, largest: bool):
        m = mask.repeat_interleave(S, dim=0) & in_sec
        fill = -_SENT if largest else _SENT
        v = torch.where(m, curv_rep, torch.full_like(curv_rep, fill))
        if largest:
            best, pick = torch.max(v, dim=1)
            ok = best > -1e29
        else:
            best, pick = torch.min(v, dim=1)
            ok = best < 1e29
        onehot = in_sec & (pos == pick[:, None]) & ok[:, None]
        return torch.any(onehot.reshape(n, S, h), dim=1)

    def suppress(picked_grid, pick_grid):
        picked_grid = picked_grid | pick_grid
        chain_r = pick_grid
        chain_l = pick_grid
        for _ in range(halfwin):
            chain_r = _shift(chain_r & ~gap, -1, False)
            chain_l = _shift(chain_l, 1, False) & ~gap
            picked_grid = picked_grid | chain_r | chain_l
        return picked_grid

    label = torch.zeros((n, h), dtype=torch.int32, device=dev)
    edge_ok = curv_ok & ~ground & (curvature > cfg.edge_threshold)
    for t in range(cfg.edge_less_per_section):
        pick = lane_pick(edge_ok & ~picked, largest=True)
        label = torch.where(pick, 2 if t < cfg.edge_per_section else 1,
                            label)
        picked = suppress(picked, pick)
    surf_ok = curv_ok & ground & (curvature < cfg.surf_threshold)
    for _ in range(cfg.surf_per_section):
        pick = lane_pick(surf_ok & ~picked, largest=False)
        label = torch.where(pick, -1, label)
        picked = suppress(picked, pick)
    return label


def pick_labels(rng: torch.Tensor, col: torch.Tensor, ground: torch.Tensor,
                count: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(N, H) int32 feature labels from the compacted per-ring channels, or
    (B, N, H) labels of a batch of scans, by the plain trip loop on any
    device."""
    return pick_labels_plain(rng, col, ground, count, cfg)
