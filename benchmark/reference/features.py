"""Curvature features: per-ring compaction, picks, fixed-cap feature clouds
(port of ``legoloam_tpu/ops/features.py``; reference
``src/featureAssociation.cpp:621-784``).

Each ring's segmented cells are compacted to the front in column order (the
reference's segmented-cloud layout); kernel K2 (``features_cuda``) turns the
compacted channels into the pick-label grid; the label grid becomes the five
fixed-capacity clouds.

A batch of scans (range images (B, N, H)) runs in one call, every step per
scan: the rings compact within their scan, K2 takes the batch in one launch,
and every cloud fills from its own scan's cells; every field of the
``ScanFeatures`` gains a leading (B,), as the JAX package's vmap gives.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import FeatureConfig, SensorConfig
from .picks import curvature_marks, pick_labels
from .projection import RangeImage
from .segmentation import Segmentation
from .voxel import voxel_cells, voxel_downsample_with_payload


class FeatureCloud(NamedTuple):
    """Fixed-capacity feature point set."""

    xyz: torch.Tensor       # (cap, 3)
    ring: torch.Tensor      # (cap,) float32 ring index
    rel_time: torch.Tensor  # (cap,) scan-relative time in [0, 1]
    valid: torch.Tensor     # (cap,) bool

    @property
    def count(self):
        return torch.sum(self.valid)


class ScanFeatures(NamedTuple):
    sharp: FeatureCloud        # label 2
    less_sharp: FeatureCloud   # label >= 1
    flat: FeatureCloud         # label -1 (ground only)
    less_flat: FeatureCloud    # label <= 0, 0.2 m thinned
    outlier: FeatureCloud      # thinned invalid-cluster points
    overflow: torch.Tensor     # (5,) int32 points dropped beyond each cap


class FeatureDebug(NamedTuple):
    """Internals of the picks for the debug dump, in the per-ring compacted
    layout (ring r's segmented cells first, in column order)."""

    label: torch.Tensor        # (N, H) int8: 2 sharp, 1 less-sharp, -1 flat
    curvature: torch.Tensor    # (N, H) float32
    curv_ok: torch.Tensor      # (N, H) bool: a full curvature window
    occl_picked: torch.Tensor  # (N, H) bool: occluded or parallel-beam
                               # before any pick
    col: torch.Tensor          # (N, H) int32 original column of the cell
    ground: torch.Tensor       # (N, H) bool ground flag of the cell
    count: torch.Tensor        # (N,) segmented cells per ring
    lf_mask: torch.Tensor      # (N, H) bool: less-flat membership before
                               # downsampling


def _compaction_perm(segmented: torch.Tensor):
    """Per-ring stable partition: segmented cells first (column order), the
    rest after.  Returns (perm (..., N, H) int64, count (..., N) int32)."""
    h = segmented.shape[-1]
    dev = segmented.device
    cols = torch.arange(h, dtype=torch.int64, device=dev).expand(
        segmented.shape)
    count = torch.sum(segmented, dim=-1, dtype=torch.int32)
    pos_seg = torch.cumsum(segmented.to(torch.int64), -1) - 1
    pos_rest = torch.cumsum((~segmented).to(torch.int64), -1) - 1 \
        + count[..., None]
    target = torch.where(segmented, pos_seg, pos_rest)
    perm = torch.empty(segmented.shape, dtype=torch.int64, device=dev)
    perm.scatter_(-1, target, cols)
    return perm, count


def _compact_rings(img: RangeImage, seg: Segmentation, xyz_deskewed=None):
    """Per-ring compaction of segmented cells into column order: a dict of
    (N, H) channels in compacted layout + per-ring counts.  The cell
    coordinates are ``xyz_deskewed`` when given; the ranges stay the
    projected ones."""
    perm, count = _compaction_perm(seg.segmented)
    h = perm.shape[-1]
    cols = torch.arange(h, dtype=torch.float32,
                        device=perm.device).expand(perm.shape)
    stacked = torch.cat([
        img.xyz if xyz_deskewed is None else xyz_deskewed,
        img.rng[..., None], cols[..., None],
        seg.seg_ground_flag.to(torch.float32)[..., None],
        img.rel_time[..., None],
        seg.segmented.to(torch.float32)[..., None]], dim=-1)
    g = torch.gather(stacked, -2, perm[..., None].expand(*perm.shape, 8))
    return {"xyz": g[..., 0:3], "rng": g[..., 3],
            "col": g[..., 4].to(torch.int32), "ground": g[..., 5] > 0.5,
            "rel": g[..., 6]}, count


def extract_features(img: RangeImage, seg: Segmentation, sensor: SensorConfig,
                     cfg: FeatureConfig, xyz_deskewed=None,
                     return_debug: bool = False):
    """Full feature extraction.  ``xyz_deskewed`` (N, H, 3), the IMU
    de-skewed cell coordinates, replaces the projected ones in every cloud;
    curvature keeps the projected ranges, as the reference computes it from
    the pre-deskew ranges (featureAssociation.cpp:624-629).

    ``return_debug``: also return a ``FeatureDebug`` — the labels are the
    ones the clouds were built from (kernel K2's on a CUDA tensor), the
    curvature and occlusion planes come from the plain version's first
    half on the same device.  Returns (features, debug)."""
    h = img.rng.shape[-1]
    c, count = _compact_rings(img, seg, xyz_deskewed)
    idx = torch.arange(h, device=count.device)
    in_ring = idx < count[..., None]
    rng = torch.where(in_ring, c["rng"], torch.zeros_like(c["rng"]))
    label = pick_labels(rng, c["col"], c["ground"], count, cfg)
    feats = _build_clouds(img, seg, c, in_ring, label, cfg, xyz_deskewed)
    if not return_debug:
        return feats
    curvature, curv_ok, occl = curvature_marks(rng, c["col"], count, cfg)
    return feats, FeatureDebug(
        label=label.to(torch.int8), curvature=curvature, curv_ok=curv_ok,
        occl_picked=occl, col=c["col"], ground=c["ground"], count=count,
        lf_mask=in_ring & (label <= 0))


def _compact_cloud(mask, cap: int, xyz, ring, rel):
    """Index-order compaction of a dense (..., N, H) mask into fixed-cap
    arrays, each scan of a batch into its own; returns (cloud, number of
    points dropped beyond ``cap``)."""
    lead = mask.shape[:-2]
    mflat = mask.reshape(-1, mask.shape[-2] * mask.shape[-1])
    b = mflat.shape[0]
    slot = torch.cumsum(mflat.to(torch.int64), -1) - 1
    tgt = torch.where(mflat & (slot < cap), slot,
                      torch.full_like(slot, cap))
    # Scan b's rows go to its own cap + 1 slots.
    tgt = tgt + torch.arange(b, device=tgt.device)[:, None] * (cap + 1)
    vals = torch.cat([xyz.reshape(-1, 3), ring.expand(mask.shape).reshape(
        -1, 1), rel.reshape(-1, 1), mflat.to(torch.float32).reshape(-1, 1)],
        dim=1)
    # Every dropped row lands in its scan's spare row ``cap``, discarded.
    out = torch.zeros((b * (cap + 1), 6), dtype=vals.dtype,
                      device=vals.device)
    out = out.index_copy_(0, tgt.reshape(-1), vals).reshape(
        *lead, cap + 1, 6)[..., :cap, :]
    out_ok = out[..., 5] > 0.5
    z = out_ok.to(torch.float32)
    n_dropped = torch.clamp(torch.sum(mflat, dim=-1, dtype=torch.int32)
                            - cap, min=0).reshape(lead)
    return FeatureCloud(xyz=out[..., :3] * z[..., None],
                        ring=out[..., 3] * z, rel_time=out[..., 4] * z,
                        valid=out_ok), n_dropped


def _build_clouds(img, seg, c, in_ring, label, cfg: FeatureConfig,
                  xyz_deskewed=None):
    """Label grid -> the five fixed-cap feature clouds."""
    n, h = img.rng.shape[-2:]
    ring_f = torch.arange(n, dtype=torch.float32,
                          device=label.device)[:, None].expand(n, h)

    def gather_cloud(mask, cap):
        return _compact_cloud(mask, cap, c["xyz"], ring_f, c["rel"])

    sharp, sharp_drop = gather_cloud(label == 2, cfg.max_sharp)
    less_sharp, ls_drop = gather_cloud(label >= 1, cfg.max_less_sharp)
    flat, flat_drop = gather_cloud(label == -1, cfg.max_flat)

    lf_mask = in_ring & (label <= 0)
    if cfg.less_flat_method == "run":
        # First-of-run adjacent-cell dedup along each azimuth-ordered ring.
        cell = voxel_cells(c["xyz"], cfg.less_flat_leaf)
        same = torch.all(cell == torch.roll(cell, 1, -2), dim=-1)
        prev_lf = torch.roll(lf_mask, 1, -1)
        keep = lf_mask & ~(same & prev_lf)
        keep[..., 0] = lf_mask[..., 0]
        less_flat, lf_drop = _compact_cloud(keep, cfg.max_less_flat, c["xyz"],
                                            ring_f, c["rel"])
    else:
        # The voxel grid thins one cloud a call: a batch's scans in turn.
        lead = lf_mask.shape[:-2]
        payload = torch.stack([ring_f.expand(lf_mask.shape), c["rel"]],
                              dim=-1).reshape(-1, n * h, 2)
        outs = [voxel_downsample_with_payload(
            xyz, pay, m, cfg.less_flat_leaf, cfg.max_less_flat,
            return_overflow=True) for xyz, pay, m in zip(
                c["xyz"].reshape(-1, n * h, 3), payload,
                lf_mask.reshape(-1, n * h))]
        pts, pay, v, lf_drop = (torch.stack(x).reshape((*lead, *x[0].shape))
                                for x in zip(*outs))
        less_flat = FeatureCloud(xyz=pts, ring=pay[..., 0],
                                 rel_time=pay[..., 1], valid=v)

    outlier, out_drop = _compact_cloud(
        seg.outlier, cfg.max_outlier,
        img.xyz if xyz_deskewed is None else xyz_deskewed, ring_f,
        img.rel_time)
    overflow = torch.stack([sharp_drop, ls_drop, flat_drop, lf_drop,
                            out_drop], dim=-1).to(torch.int32)
    return ScanFeatures(sharp=sharp, less_sharp=less_sharp, flat=flat,
                        less_flat=less_flat, outlier=outlier,
                        overflow=overflow)
