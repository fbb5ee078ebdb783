"""Range-image projection: raw scan -> dense (N_SCAN, Horizon_SCAN) image
(port of ``legoloam_tpu/ops/projection.py``; reference
``src/imageProjection.cpp:199-257``).

Cell collisions keep the CLOSEST point, ties to the lowest point index, via
one segment-min over a packed (range, index) int32 key — here a
``scatter_reduce("amin")``.  Per-point relative scan time is recovered from
azimuth with the reference's half-pass disambiguation
(``src/featureAssociation.cpp:504-522``).

A batch of scans, points (B, P, 3), projects in one call, each scan into its
own image (B, N_SCAN, H): the key's index bits stay the point's index within
its scan, so the tie rule and the bit budget are a single scan's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .config import SensorConfig

_DEG = 180.0 / math.pi
_KEY_EMPTY = 0x7FFFFFFF


class RangeImage(NamedTuple):
    """Dense organized scan.  All tensors (N_SCAN, H) unless noted; a batch
    adds a leading (B,) to every field."""

    xyz: torch.Tensor        # (N_SCAN, H, 3)
    rng: torch.Tensor        # range in metres; +inf where no return
    valid: torch.Tensor      # bool
    rel_time: torch.Tensor   # per-cell time within the scan, in [0, 1]
    start_ori: torch.Tensor  # () scan start azimuth (radians)
    end_ori: torch.Tensor    # () scan end azimuth (radians)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[..., i]`` for an integer tensor ``i`` of x's leading shape, as a
    gather on the device (no read-back)."""
    return torch.gather(x, -1, i[..., None])[..., 0]


def _point_orientations(points, valid, n_points):
    """``findStartEndAngle`` (imageProjection.cpp:199-209) plus the per-point
    half-pass disambiguation (featureAssociation.cpp:504-522), along the
    last (point) axis."""
    x, y = points[..., 0], points[..., 1]
    yaw = -torch.atan2(y, x)
    idx = torch.arange(n_points, device=points.device)
    vi = valid.to(torch.int32)
    first = torch.argmax(vi, dim=-1)
    last = n_points - 1 - torch.argmax(torch.flip(vi, (-1,)), dim=-1)
    start_ori = _take(yaw, first)
    end_ori = _take(yaw, last) + 2.0 * math.pi
    end_ori = torch.where(end_ori - start_ori > 3.0 * math.pi,
                          end_ori - 2.0 * math.pi, end_ori)
    end_ori = torch.where(end_ori - start_ori < math.pi,
                          end_ori + 2.0 * math.pi, end_ori)
    half = idx > torch.div(first + last, 2, rounding_mode="floor")[..., None]
    s, e = start_ori[..., None], end_ori[..., None]
    ori = torch.where(half, yaw + 2.0 * math.pi, yaw)
    ori = torch.where(~half & (ori < s - math.pi / 2), ori + 2 * math.pi, ori)
    ori = torch.where(~half & (ori > s + math.pi * 3 / 2), ori - 2 * math.pi,
                      ori)
    ori = torch.where(half & (ori < e - math.pi * 3 / 2), ori + 2 * math.pi,
                      ori)
    ori = torch.where(half & (ori > e + math.pi / 2), ori - 2 * math.pi, ori)
    return ori, start_ori, end_ori


def project_scan(points: torch.Tensor, valid: torch.Tensor,
                 sensor: SensorConfig,
                 ring: Optional[torch.Tensor] = None) -> RangeImage:
    """Project a raw scan ``points (P, 3)`` / ``valid (P,)`` (+ optional
    ``ring (P,)``) into a dense range image; a batch ``points (B, P, 3)``
    into B images."""
    n, h = sensor.n_scan, sensor.horizon_scan
    n_cells = n * h
    lead = points.shape[:-2]
    p_cap = points.shape[-2]
    dev = points.device
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rng = torch.sqrt(x * x + y * y + z * z)

    if ring is not None and sensor.use_cloud_ring:
        row = ring.to(torch.int32)
    else:
        vert_deg = torch.atan2(z, torch.sqrt(x * x + y * y)) * _DEG
        row = torch.floor((vert_deg + sensor.ang_bottom_deg)
                          / sensor.ang_res_y_deg).to(torch.int32)

    horizon_deg = torch.atan2(x, y) * _DEG
    col = (-torch.round((horizon_deg - 90.0) / sensor.ang_res_x_deg)
           ).to(torch.int32) + h // 2
    col = torch.where(col >= h, col - h, col)

    ok = (valid & (row >= 0) & (row < n) & (col >= 0) & (col < h)
          & (rng >= sensor.min_range) & torch.isfinite(rng))
    flat = torch.where(ok, row * h + col,
                       torch.full_like(row, n_cells)).to(torch.int64)

    # Packed (range high bits | point index) key: min = closest point, ties
    # to the lowest index (see the JAX module for the bit budget).
    idx_bits = max(1, (p_cap - 1).bit_length())
    if idx_bits > 18:
        raise ValueError("packed projection key needs p_cap <= 262144")
    idx_mask = (1 << idx_bits) - 1
    pidx = torch.arange(p_cap, dtype=torch.int32, device=dev)
    rng_bits = rng.view(torch.int32)
    key = torch.where(ok, (rng_bits & ~idx_mask) | pidx,
                      torch.full_like(pidx, _KEY_EMPTY))
    # Each scan's own (N*H + 1) cells: row b of the scatter.
    cell_key = torch.full((*lead, n_cells + 1), _KEY_EMPTY,
                          dtype=torch.int32, device=dev)
    cell_key.scatter_reduce_(-1, flat, key, "amin", include_self=False)

    ori, start_ori, end_ori = _point_orientations(points, ok, p_cap)
    rel = torch.where(torch.any(ok, dim=-1, keepdim=True),
                      (ori - start_ori[..., None])
                      / (end_ori - start_ori)[..., None],
                      torch.zeros_like(ori))

    valid_flat = cell_key[..., :n_cells] != _KEY_EMPTY
    win_idx = torch.where(valid_flat, cell_key[..., :n_cells] & idx_mask,
                          torch.zeros_like(cell_key[..., :n_cells])
                          ).to(torch.int64)
    vals = torch.cat([points[..., :3], rel[..., None], rng[..., None]],
                     dim=-1)
    img = torch.gather(vals, -2, win_idx[..., None].expand(
        *win_idx.shape, 5)) * valid_flat[..., None].to(vals.dtype)

    valid_img = valid_flat.reshape(*lead, n, h)
    rng_img = torch.where(valid_img, img[..., 4].reshape(*lead, n, h),
                          torch.full((*lead, n, h), math.inf, device=dev))
    return RangeImage(
        xyz=img[..., :3].reshape(*lead, n, h, 3), rng=rng_img,
        valid=valid_img, rel_time=img[..., 3].reshape(*lead, n, h),
        start_ori=start_ori, end_ori=end_ori)
