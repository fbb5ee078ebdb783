"""Map and trajectory export (port of ``legoloam_tpu/utils/export.py``;
reference: the PCD dumps of ``src/mapOptmization.cpp:730-755`` and the
global-map topic of ``publishGlobalMap``, 758-800).

``assemble_global_map`` transforms every keyframe cloud into the world on
the store's device and voxel-downsamples it; the PCD and TUM writers are
NumPy code and write the same bytes as the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import se3
from ..ops.voxel import voxel_downsample
from .io import to_numpy



def assemble_global_map(kf, leaf: float = 0.4, cap: int = 1 << 20,
                        corner: bool = True, surf: bool = True):
    """All keyframe clouds in world coordinates, voxel-downsampled.

    kf: a ``mapping.KeyframeStore``.  Returns (points (cap, 3), valid
    (cap,)) on the store's device.  Every slot of the store is transformed
    (a fixed-shape pass) and the slots beyond ``count`` masked out.  On the
    card the centroid sums are float atomics in no fixed order, so card and
    CPU agree on the voxel set and on the centroids to float32 rounding."""
    m = kf.t.shape[0]
    kf_ok = torch.arange(m, device=kf.t.device) < kf.count
    poses = se3.Pose(kf.R, kf.t)
    parts, vals = [], []
    if corner:
        parts.append(se3.transform_points(poses, kf.corner).reshape(-1, 3))
        vals.append((kf.corner_valid & kf_ok[:, None]).reshape(-1))
    if surf:
        parts.append(se3.transform_points(poses, kf.surf).reshape(-1, 3))
        vals.append((kf.surf_valid & kf_ok[:, None]).reshape(-1))
    return voxel_downsample(torch.cat(parts), torch.cat(vals), leaf, cap)


def write_pcd(path, points, valid: Optional[np.ndarray] = None):
    """Binary PCD v0.7 (x y z float32), PCL-compatible."""
    pts = to_numpy(points).astype(np.float32)
    if valid is not None:
        pts = pts[to_numpy(valid).astype(bool)]
    n = pts.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        "DATA binary\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(np.ascontiguousarray(pts).tobytes())


def write_trajectory_tum(path, times, poses):
    """TUM format: ``t x y z qx qy qz qw`` per line (poses: se3.Pose batch
    of tensors or arrays)."""
    R = to_numpy(poses.R)
    t = to_numpy(poses.t)
    times = to_numpy(times)
    with open(path, "w") as f:
        for k in range(t.shape[0]):
            q = _mat_to_quat(R[k])
            f.write(f"{float(times[k]):.6f} {t[k,0]:.6f} {t[k,1]:.6f} "
                    f"{t[k,2]:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} "
                    f"{q[3]:.6f}\n")


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def read_pcd_xyz(path) -> np.ndarray:
    """Minimal reader for the files this module writes."""
    with open(path, "rb") as f:
        n = None
        while True:
            line = f.readline().decode()
            if line.startswith("POINTS"):
                n = int(line.split()[1])
            if line.startswith("DATA"):
                break
        return np.frombuffer(f.read(n * 12), np.float32).reshape(n, 3)
