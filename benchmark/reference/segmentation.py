"""Ground removal + connected-component segmentation on the dense range image
(port of ``legoloam_tpu/ops/segmentation.py``; reference
``src/imageProjection.cpp:260-460``).

Connectivity is precomputed once from the angle predicate; the components
come from kernel K1 (``ccl_cuda.label_propagation``), which also returns each
component's ring extrema for the cluster-validity rule.

A batch of range images (B, N, H) segments in one call: the ring axis is
-2 and the column axis -1 throughout, and every per-component count is
taken over its own scan's cells.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .config import SegmentationConfig, SensorConfig
from .device import const
from .ccl import label_propagation
from .projection import RangeImage

OUTLIER_LABEL = 999999
_DEG = 180.0 / math.pi


class Segmentation(NamedTuple):
    """Dense per-cell segmentation results, all (N_SCAN, H) unless noted; a
    batch adds a leading (B,) to every field."""

    ground: torch.Tensor          # bool
    label: torch.Tensor           # int32 root id; -1 ground/invalid; OUTLIER
    segmented: torch.Tensor       # bool: enters the segmented cloud
    outlier: torch.Tensor         # bool: enters the outlier cloud
    seg_ground_flag: torch.Tensor  # bool: segmented cell is ground
    n_clusters: torch.Tensor      # () int: number of valid clusters


def ground_removal(img: RangeImage, sensor: SensorConfig,
                   cfg: SegmentationConfig) -> torch.Tensor:
    """``groundRemoval`` (imageProjection.cpp:260-310)."""
    g = sensor.ground_scan_ind
    diff = img.xyz[..., 1:g + 1, :, :] - img.xyz[..., :g, :, :]
    angle = torch.atan2(diff[..., 2],
                        torch.linalg.norm(diff[..., :2], dim=-1)) * _DEG
    both = img.valid[..., :g, :] & img.valid[..., 1:g + 1, :]
    flat_pair = both & (torch.abs(angle - sensor.mount_angle_deg)
                        <= cfg.ground_angle_thresh_deg)
    ground = torch.zeros(img.rng.shape, dtype=torch.bool,
                         device=img.rng.device)
    ground[..., :g, :] = flat_pair
    ground[..., 1:g + 1, :] |= flat_pair
    return ground & img.valid


def _connectivity(img: RangeImage, sensor: SensorConfig,
                  cfg: SegmentationConfig):
    """4-neighbour angle-predicate connectivity with column wraparound
    (imageProjection.cpp:411-423): (conn_h (N, H), conn_v (N-1, H))."""
    dev = img.rng.device
    theta = torch.deg2rad(const(cfg.segment_theta_deg, dev))

    def edge(a_rng, b_rng, alpha):
        alpha = const(alpha, dev)
        d1 = torch.maximum(a_rng, b_rng)
        d2 = torch.minimum(a_rng, b_rng)
        ang = torch.atan2(d2 * torch.sin(alpha), d1 - d2 * torch.cos(alpha))
        return ang > theta

    r = torch.where(img.valid, img.rng, torch.full_like(img.rng, math.inf))
    conn_h = edge(r, torch.roll(r, -1, -1), sensor.ang_res_x)
    conn_h &= img.valid & torch.roll(img.valid, -1, -1)
    conn_v = edge(r[..., :-1, :], r[..., 1:, :], sensor.ang_res_y)
    conn_v &= img.valid[..., :-1, :] & img.valid[..., 1:, :]
    return conn_h, conn_v


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int):
    """Integer sums of ``vals`` by ``idx`` along the last axis, into ``n``
    bins for each leading index (a scan's own histogram)."""
    out = torch.zeros((*vals.shape[:-1], n), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_add_(-1, idx, vals)


def segment(img: RangeImage, sensor: SensorConfig,
            cfg: SegmentationConfig) -> Segmentation:
    """Full ``cloudSegmentation`` (imageProjection.cpp:312-368)."""
    n, h = sensor.n_scan, sensor.horizon_scan
    n_cells = n * h
    lead = img.rng.shape[:-2]
    dev = img.rng.device
    ground = ground_removal(img, sensor, cfg)
    seeds = img.valid & ~ground
    conn_h, conn_v = _connectivity(img, sensor, cfg)
    labels, rmin_cell, rmax_cell = label_propagation(
        seeds, conn_h, conn_v, cfg.ccl_max_iters)
    flat_labels = labels.reshape(*lead, -1).long()

    # Cluster validity (imageProjection.cpp:440-451), with the reference's
    # seed-ring quirk: the seed's ring counts only if another cell of the
    # component shares it (see the JAX module).
    seeds_flat = seeds.reshape(*lead, -1)
    ones = seeds_flat.to(torch.int32)
    sizes = _segment_sum(ones, flat_labels, n_cells + 1)
    cell_size = torch.gather(sizes, -1, flat_labels).reshape(*lead, n, h)
    ring_of = torch.div(torch.arange(n_cells, dtype=torch.int32, device=dev),
                        h, rounding_mode="floor")
    rmin_flat = rmin_cell.reshape(*lead, -1)
    cell_rspan = rmax_cell - rmin_cell + 1
    in_min_row = seeds_flat & (ring_of == rmin_flat)
    min_row_count = _segment_sum(in_min_row.to(torch.int32), flat_labels,
                                 n_cells + 1)
    cell_line_count = cell_rspan - (torch.gather(
        min_row_count, -1, flat_labels).reshape(*lead, n, h) == 1
    ).to(torch.int32)
    cell_valid_cluster = seeds & (
        (cell_size >= cfg.min_cluster_size)
        | ((cell_size >= cfg.valid_point_num)
           & (cell_line_count >= cfg.valid_line_num)))
    cell_invalid_cluster = seeds & ~cell_valid_cluster

    cols = torch.arange(h, device=dev)[None, :]
    rows = torch.arange(n, device=dev)[:, None]
    outlier = (cell_invalid_cluster & (rows > sensor.ground_scan_ind)
               & (cols % cfg.outlier_downsample == 0))
    ground_kept = ground & ((cols % cfg.ground_downsample == 0)
                            | (cols <= 5) | (cols >= h - 5))
    segmented = cell_valid_cluster | ground_kept

    root_ids = torch.arange(n_cells, dtype=torch.int32, device=dev)
    is_root = seeds_flat & (labels.reshape(*lead, -1) == root_ids)
    n_clusters = torch.sum(is_root & cell_valid_cluster.reshape(*lead, -1),
                           dim=-1)
    label_out = torch.where(
        cell_valid_cluster, labels,
        torch.where(cell_invalid_cluster,
                    torch.full_like(labels, OUTLIER_LABEL),
                    torch.full_like(labels, -1)))
    return Segmentation(ground=ground, label=label_out, segmented=segmented,
                        outlier=outlier, seg_ground_flag=ground_kept,
                        n_clusters=n_clusters)
