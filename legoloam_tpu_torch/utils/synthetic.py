"""Synthetic LiDAR worlds: ray-cast VLP-16-style scans with ground-truth
poses, and IMU samples along a trajectory (port of the scan and IMU
generators of ``legoloam_tpu/utils/synthetic.py``).

Scenes are a ground plane z = 0, axis-aligned boxes and vertical cylinders.
Scan point order mimics a real Velodyne: one column (all rings) per firing,
azimuth decreasing from +pi, so per-point time increases with emission index.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SensorConfig
from ..ops import se3
from ..ops.se3 import Pose
from ..ops.voxel import div

MAX_RANGE = 100.0


class Scene(NamedTuple):
    """Boxes (K, 6) [xmin ymin zmin xmax ymax zmax], cylinders (M, 4)
    [cx cy radius height], ground plane z = 0."""

    boxes: torch.Tensor
    cylinders: torch.Tensor

    def to(self, device) -> "Scene":
        return Scene(self.boxes.to(device), self.cylinders.to(device))


def default_scene() -> Scene:
    """A ~50x40 m courtyard: walls, building corners, poles."""
    boxes = np.array([
        [-25.0, -20.0, 0.0, 25.0, -19.6, 3.0],
        [-25.0, 19.6, 0.0, 25.0, 20.0, 3.0],
        [-25.0, -20.0, 0.0, -24.6, 20.0, 3.0],
        [24.6, -20.0, 0.0, 25.0, 20.0, 3.0],
        [5.0, 5.0, 0.0, 12.0, 12.0, 4.0],
        [-14.0, 6.0, 0.0, -8.0, 14.0, 5.0],
        [-12.0, -14.0, 0.0, -4.0, -8.0, 3.5],
        [10.0, -12.0, 0.0, 18.0, -6.0, 4.5],
        [-2.0, 15.0, 0.0, 2.0, 17.0, 1.0],
        [-20.0, -4.0, 0.0, -18.0, 0.0, 1.2],
    ], np.float32)
    cyl = np.array([
        [3.0, -3.0, 0.15, 4.0],
        [-5.0, 2.0, 0.2, 5.0],
        [15.0, 3.0, 0.15, 4.0],
        [-16.0, -10.0, 0.18, 4.5],
        [0.0, 9.0, 0.15, 4.0],
        [20.0, 14.0, 0.2, 5.0],
        [-20.0, 12.0, 0.15, 4.0],
        [8.0, -16.0, 0.15, 4.0],
    ], np.float32)
    return Scene(torch.from_numpy(boxes), torch.from_numpy(cyl))


def loop_scene() -> Scene:
    """A 90x90 m block with a collision-free ring lane of radius ~30 m
    around (0, 30) (matching ``circle_trajectory(radius=30)``), buildings
    inside and outside the lane, poles and crates along it."""
    cx, cy = 0.0, 30.0
    boxes = [
        [-45.0, -15.0, 0.0, 45.0, -14.6, 4.0],
        [-45.0, 74.6, 0.0, 45.0, 75.0, 4.0],
        [-45.0, -15.0, 0.0, -44.6, 75.0, 4.0],
        [44.6, -15.0, 0.0, 45.0, 75.0, 4.0],
        [cx - 9.0, cy - 8.0, 0.0, cx + 9.0, cy + 8.0, 6.0],
        [cx - 16.0, cy + 10.0, 0.0, cx - 10.0, cy + 16.0, 4.0],
        [cx + 10.0, cy - 17.0, 0.0, cx + 17.0, cy - 10.0, 5.0],
        [-43.0, -13.0, 0.0, -32.0, -2.0, 5.0],
        [32.0, -13.0, 0.0, 43.0, -4.0, 4.5],
        [-43.0, 62.0, 0.0, -33.0, 73.0, 5.5],
        [31.0, 63.0, 0.0, 43.0, 73.0, 4.0],
    ]
    cyl = []
    for k in range(36):
        a = np.radians(10.0 * k)
        cyl.append([cx + 23.0 * np.cos(a), cy + 23.0 * np.sin(a), 0.18, 5.0])
        b = a + np.radians(5.0)
        cyl.append([cx + 37.0 * np.cos(b), cy + 37.0 * np.sin(b), 0.18, 5.0])
    rng = np.random.RandomState(7)
    for k in range(28):
        a = np.radians(360.0 / 28 * k + 6.0 * rng.rand())
        r = 20.5 if k % 2 == 0 else 39.5
        bx = cx + r * np.cos(a)
        by = cy + r * np.sin(a)
        w = 0.6 + 1.2 * rng.rand()
        d = 0.6 + 1.2 * rng.rand()
        hgt = 0.8 + 2.2 * rng.rand()
        boxes.append([bx - w / 2, by - d / 2, 0.0, bx + w / 2, by + d / 2,
                      hgt])
    return Scene(torch.from_numpy(np.array(boxes, np.float32)),
                 torch.from_numpy(np.array(cyl, np.float32)))


def circuit_scene(half: float = 100.0) -> Scene:
    """A perimeter circuit larger than the mapping submap radius: a
    rounded-square lane of half-size ``half`` (100 -> a ~766 m lap) between
    an outer wall square at half + 12 and an inner one at half - 12, with
    poles and crates along both lane edges.  Once the vehicle is a side
    away, the start area is ~200 m out of range, so the return to the start
    is a real loop-closure event.  Use with ``circuit_trajectory``."""
    ho, hi = half + 12.0, half - 12.0
    t = 0.4          # wall thickness
    boxes = [
        [-ho, -ho, 0.0, ho, -ho + t, 4.0],
        [-ho, ho - t, 0.0, ho, ho, 4.0],
        [-ho, -ho, 0.0, -ho + t, ho, 4.0],
        [ho - t, -ho, 0.0, ho, ho, 4.0],
        [-hi, -hi, 0.0, hi, -hi + t, 5.0],
        [-hi, hi - t, 0.0, hi, hi, 5.0],
        [-hi, -hi, 0.0, -hi + t, hi, 5.0],
        [hi - t, -hi, 0.0, hi, hi, 5.0],
    ]
    cyl = []
    rng = np.random.RandomState(11)
    for side in range(4):
        n_feat = max(10, int(half / 4))      # ~one every 8 m of side
        for k in range(n_feat):
            u = -half + (2.0 * half) * (k + 0.5) / n_feat
            for r, jitter in ((half - 8.0, 1.5), (half + 8.0, 1.5)):
                uu = u + jitter * (rng.rand() - 0.5) * 4.0
                if side == 0:
                    x, y = uu, -r
                elif side == 1:
                    x, y = r, uu
                elif side == 2:
                    x, y = -uu, r
                else:
                    x, y = -r, -uu
                if rng.rand() < 0.6:
                    cyl.append([x, y, 0.18, 4.0 + 2.0 * rng.rand()])
                else:
                    w = 0.6 + 1.2 * rng.rand()
                    d = 0.6 + 1.2 * rng.rand()
                    boxes.append([x - w / 2, y - d / 2, 0.0,
                                  x + w / 2, y + d / 2,
                                  0.8 + 2.0 * rng.rand()])
    return Scene(torch.from_numpy(np.array(boxes, np.float32)),
                 torch.from_numpy(np.array(cyl, np.float32)))


def circuit_trajectory(n_scans: int, half: float = 100.0,
                       corner: float = 18.0, step: float = 0.8,
                       height: float = 0.8, device=None) -> Pose:
    """Poses along the lane centreline of ``circuit_scene``
    (counter-clockwise, yaw tangent to the path), ``step`` m a scan; one
    lap is 4 (2 (half - corner)) + 2 pi corner m (~766 m, ~957 scans, at
    the defaults)."""
    L = half - corner                       # straight half-length
    seg = 2.0 * L
    arc = 0.5 * np.pi * corner              # quarter-corner length
    P = 4.0 * (seg + arc)
    s = (np.arange(n_scans, dtype=np.float64) * step) % P
    x, y, yaw = np.zeros(n_scans), np.zeros(n_scans), np.zeros(n_scans)
    for i, si in enumerate(s):
        q, r = divmod(si, seg + arc)        # side 0..3, offset within it
        if r < seg:                         # straight
            px, py, hd = -L + r, -half, 0.0
        else:                               # corner arc
            a = (r - seg) / corner          # 0..pi/2
            px = L + corner * np.sin(a)
            py = -half + corner * (1.0 - np.cos(a))
            hd = a
        for _ in range(int(q)):             # rotate by 90 deg a side
            px, py = -py, px
            hd += 0.5 * np.pi
        x[i], y[i], yaw[i] = px, py, hd
    t = torch.tensor(np.stack([x, y, np.full_like(x, height)], axis=-1),
                     dtype=torch.float32, device=device)
    return Pose(se3.rot_z(torch.tensor(yaw, dtype=torch.float32,
                                       device=device)), t)


def circle_trajectory(n_scans: int, radius: float = 8.0, height: float = 0.8,
                      angular_rate: float = 0.02, device=None) -> Pose:
    """Poses driving a circle (yaw tangent to the path)."""
    th = angular_rate * torch.arange(n_scans, dtype=torch.float32,
                                     device=device)
    t = torch.stack([radius * torch.sin(th), radius * (1 - torch.cos(th)),
                     torch.full_like(th, height)], dim=-1)
    return Pose(se3.rot_z(th), t)


def figure8_trajectory(n_scans: int, radius: float = 10.0,
                       height: float = 0.8, device=None) -> Pose:
    """A figure eight through the origin twice (a revisit)."""
    th = torch.linspace(0.0, 4.0 * np.pi, n_scans, device=device)
    x = radius * torch.sin(th)
    y = radius * torch.sin(th) * torch.cos(th)
    t = torch.stack([x, y, torch.full_like(th, height)], dim=-1)
    yaw = torch.atan2(torch.gradient(y)[0], torch.gradient(x)[0])
    return Pose(se3.rot_z(yaw), t)


def make_imu(poses: Pose, scan_period: float = 0.1, rate_hz: float = 200.0):
    """IMU samples along a scan-pose trajectory (poses ``scan_period``
    apart): (time (L,), rpy (L, 3), acc (L, 3) specific force in the sensor
    frame, gyro (L, 3) sensor-frame rate) at ``rate_hz``, on the poses'
    device.  The inverse of what ``ops.deskew`` integrates: attitude from
    the pose spline, gyro from finite rotation differences, specific force
    Rᵀ(a_world - g) with g = (0, 0, -9.81)."""
    n = poses.t.shape[0]
    dev = poses.t.device
    L = int((n - 1) * scan_period * rate_hz) + 1
    ts = div(torch.arange(L, dtype=torch.float32, device=dev), rate_hz)
    dt = 1.0 / rate_hz

    def attitude(t):
        u = div(t, scan_period)
        seg = torch.clamp(u.to(torch.int32), 0, n - 2).long()
        frac = u - seg
        return se3.so3_interp(poses.R[seg], poses.R[seg + 1], frac), seg, frac

    R_t, seg, frac = attitude(ts)
    rpy = torch.stack(se3.mat_to_euler_zyx(R_t), dim=-1)
    R_t2, _, _ = attitude(ts + dt)
    gyro = div(se3.so3_log(R_t.transpose(-1, -2) @ R_t2), dt)
    # The position spline is piecewise linear; a centred difference smooths
    # its knots into finite accelerations.
    pos = poses.t[seg] + frac[:, None] * (poses.t[seg + 1] - poses.t[seg])
    vel = torch.gradient(pos, spacing=dt, dim=0)[0]
    acc_w = torch.gradient(vel, spacing=dt, dim=0)[0]
    g = torch.tensor([0.0, 0.0, -9.81], device=dev)
    f_body = se3.rotate_vec(R_t.transpose(-1, -2), acc_w - g)
    return ts, rpy, f_body, gyro


PICK_STRESS_COUNTS = (0, 5, 11, 12, 13, 40)


def pick_stress_rings(seed: int, h: int, sections: int, halfwin: int = 5,
                      device=None):
    """Seeded compacted rings that stress the feature picks (kernel K2):
    (ranges (N, h) f32, zero beyond each ring's count; columns (N, h) i32;
    ground flags (N, h) bool; counts (N,) i32).

    Counts 0, 5, 11, 12, 13, 40, ``h`` and six random ones.  Every third
    ring has no column gap, the others a gap > 10 every ~3 or ~20 cells,
    and some column steps are exactly 10 (neither close nor a gap).  Ranges
    on a 1/256 m grid: flat and linear ground runs (curvature exactly 0, so
    surf picks tie), smooth walls, noise, and range jumps that mark
    occlusions.  A 0.1875 m non-ground spike on the first and last cell of
    every section (for ``sections`` and ``halfwin``) pulls edge picks onto
    the section boundaries."""
    rs = np.random.RandomState(seed)
    counts = list(PICK_STRESS_COUNTS) + [h] + list(rs.randint(41, h + 1, 6))
    n = len(counts)
    rng = np.zeros((n, h), np.float32)
    col = np.zeros((n, h), np.int32)
    ground = np.zeros((n, h), bool)
    for r, c in enumerate(counts):
        gap_p = (0.0, 0.05, 0.3)[r % 3]
        steps = np.where(rs.rand(h) < gap_p, rs.randint(11, 40, h), 1)
        steps[rs.rand(h) < 0.03] = 10
        col[r] = rs.randint(0, 50) + np.cumsum(steps) - steps[0]
        vals = np.empty(h, np.float64)
        i, prev = 0, rs.uniform(3.0, 40.0)
        while i < h:
            seg_len = min(rs.randint(3, 60), h - i)
            base = prev if rs.rand() < 0.6 else rs.uniform(3.0, 40.0)
            t = np.arange(seg_len)
            kind = rs.randint(4)
            if kind == 0:                                   # flat ground
                seg, g = np.full(seg_len, base), True
            elif kind == 1:                                 # linear ground
                seg = base + rs.choice([-1, 1]) * rs.randint(1, 8) / 64 * t
                g = True
            elif kind == 2:                                 # smooth wall
                seg, g = base + 0.002 * (t - seg_len / 2) ** 2, False
            else:                                           # rough surface
                seg = base + rs.uniform(-0.05, 0.05, seg_len)
                g = rs.rand() < 0.3
            vals[i:i + seg_len] = np.clip(seg, 1.0, 90.0)
            ground[r, i:i + seg_len] = g
            prev = float(vals[i + seg_len - 1])
            i += seg_len
        vals = np.round(vals * 256.0) / 256.0
        e = c - halfwin - 1
        for j in range(sections):
            sp = (halfwin * (sections - j) + e * j) // sections
            ep = e - 1 if j == sections - 1 else \
                (halfwin * (sections - 1 - j) + e * (j + 1)) // sections - 1
            for b in (sp, ep):
                if 0 <= b < c:
                    vals[b] += 0.1875
                    ground[r, b] = False
        rng[r, :c] = vals[:c]
    return (torch.from_numpy(rng).to(device), torch.from_numpy(col).to(device),
            torch.from_numpy(ground).to(device),
            torch.tensor(counts, dtype=torch.int32, device=device))


def _ray_ground(o, d):
    dz = d[:, 2]
    s = -o[:, 2] / torch.where(torch.abs(dz) < 1e-9,
                               torch.full_like(dz, 1e-9), dz)
    return torch.where((s > 0) & (dz < 0), s, torch.full_like(s, torch.inf))


def _ray_boxes(o, d, boxes):
    inv = 1.0 / torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)
    t0 = (boxes[None, :, :3] - o[:, None, :]) * inv[:, None, :]
    t1 = (boxes[None, :, 3:] - o[:, None, :]) * inv[:, None, :]
    tmin = torch.amax(torch.minimum(t0, t1), dim=2)
    tmax = torch.amin(torch.maximum(t0, t1), dim=2)
    hit = (tmax >= tmin) & (tmax > 0)
    s = torch.where(tmin > 0, tmin, tmax)
    return torch.amin(torch.where(hit, s, torch.full_like(s, torch.inf)),
                      dim=1)


def _ray_cylinders(o, d, cyl):
    ox = o[:, 0:1] - cyl[None, :, 0]
    oy = o[:, 1:2] - cyl[None, :, 1]
    dx, dy = d[:, 0:1], d[:, 1:2]
    a = dx * dx + dy * dy
    b = 2 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - cyl[None, :, 2] ** 2
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(a < 1e-12, torch.full_like(a, 1e-12), a)
    s0 = (-b - sq) / (2 * a_safe)
    s1 = (-b + sq) / (2 * a_safe)
    s = torch.where(s0 > 0, s0, s1)
    z = o[:, 2:3] + s * d[:, 2:3]
    hit = (disc > 0) & (s > 0) & (z >= 0) & (z <= cyl[None, :, 3])
    return torch.amin(torch.where(hit, s, torch.full_like(s, torch.inf)),
                      dim=1)


def _ray_dirs(sensor: SensorConfig, device) -> torch.Tensor:
    """Local-frame unit directions in EMISSION order: (H*N_SCAN, 3)."""
    h, n = sensor.horizon_scan, sensor.n_scan
    f32 = dict(dtype=torch.float32, device=device)
    elev = torch.deg2rad(-sensor.ang_bottom_deg
                         + sensor.ang_res_y_deg * torch.arange(n, **f32))
    psi = torch.deg2rad(180.0 - sensor.ang_res_x_deg
                        * torch.arange(h, **f32))
    ce, se_ = torch.cos(elev), torch.sin(elev)
    cp, sp = torch.cos(psi), torch.sin(psi)
    dirs = torch.stack([cp[:, None] * ce[None, :], sp[:, None] * ce[None, :],
                        se_[None, :].expand(h, n)], dim=-1)
    return dirs.reshape(h * n, 3)


def raycast_scan(scene: Scene, pose: Pose, sensor: SensorConfig,
                 noise_sigma: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 next_pose: Optional[Pose] = None, motion: bool = False,
                 spin_warp: float = 0.0, chunk: int = 8192):
    """Simulate one scan from ``pose`` on ``pose.t``'s device.

    Returns (points (P, 3) in the sensor frame at each point's firing time,
    valid (P,), ring (P,) int32) in emission order, P = H*N_SCAN.  With
    ``motion`` and ``next_pose`` the sensor interpolates from pose to
    next_pose during the sweep (motion distortion).  Range noise
    ``noise_sigma`` is drawn from ``generator``, the port's explicit
    ``torch.Generator``: a noisy scan is not bit-equal to the JAX package's,
    whose noise comes from a JAX PRNG key.

    ``spin_warp``: a spindle that does not sweep azimuth linearly in time.
    Column u in [0, 1] fires at t(u) = u + spin_warp sin(2 pi u) / (2 pi)
    while the geometry stays azimuth-indexed, so the azimuth-proportional
    point time the pipeline infers is off by up to ``spin_warp`` of a
    scan."""
    h, n = sensor.horizon_scan, sensor.n_scan
    dev = pose.t.device
    scene = scene.to(dev)
    dirs = _ray_dirs(sensor, dev)
    p_total = h * n
    if motion and next_pose is not None:
        frac = torch.div(torch.arange(p_total, device=dev), n,
                         rounding_mode="floor").to(torch.float32) / h
        if spin_warp:
            frac = frac + spin_warp * torch.sin(2.0 * np.pi * frac) \
                / (2.0 * np.pi)
        R_t = se3.so3_interp(pose.R.expand(p_total, 3, 3),
                             next_pose.R.expand(p_total, 3, 3), frac)
        t_t = pose.t[None] + frac[:, None] * (next_pose.t - pose.t)[None]
    else:
        R_t = pose.R.expand(p_total, 3, 3)
        t_t = pose.t.expand(p_total, 3)
    d_world = (R_t @ dirs[:, :, None])[..., 0]
    s = torch.cat([
        torch.minimum(torch.minimum(
            _ray_ground(t_t[i:i + chunk], d_world[i:i + chunk]),
            _ray_boxes(t_t[i:i + chunk], d_world[i:i + chunk], scene.boxes)),
            _ray_cylinders(t_t[i:i + chunk], d_world[i:i + chunk],
                           scene.cylinders))
        for i in range(0, p_total, chunk)])
    if noise_sigma > 0:
        s = s + noise_sigma * torch.randn(s.shape, generator=generator,
                                          device=dev)
    valid = (s > sensor.min_range) & (s < MAX_RANGE)
    pts = dirs * torch.where(valid, s, torch.zeros_like(s))[:, None]
    ring = torch.arange(n, dtype=torch.int32, device=dev).repeat(h)
    return pts, valid, ring


PATHOLOGIES = ("wedges", "dead_rings", "dropout", "spin_warp",
               "moving_object", "everything")


def pathology_scans(case: str, scene: Scene, poses: Pose,
                    sensor: SensorConfig, clean=None):
    """The real-sensor artefacts of tests/test_real_pathologies.py applied
    to the motion-distorted scans along ``poses`` (one scan a pose but the
    last), on the poses' device:

      wedges         two 18-degree azimuth wedges of missing returns a scan
                     (packet loss), at scan-varying positions;
      dead_rings     rings 3 and 11 never return;
      dropout        35% of the returns missing at random;
      spin_warp      a 10% spin-rate oscillation (``raycast_scan``'s
                     ``spin_warp``);
      moving_object  a 3 x 2 x 2 m box crossing the scene against the path,
                     ~1.2 m a scan;
      everything     a 15-degree wedge, ring 7 dead, 20% dropout, a 5% spin
                     oscillation and 2 cm range noise at once.

    ``clean``: the clean scans, where already cast.  Random draws come from
    one ``torch.Generator`` a scan, seeded with the scan index (dropout;
    noise) or 1000 + the index (the combined case's dropout): the masks are
    not the JAX test's, whose draws come from JAX PRNG keys."""
    if case not in PATHOLOGIES:
        raise ValueError(f"unknown pathology {case!r}; one of {PATHOLOGIES}")
    dev = poses.t.device
    n_scans = poses.t.shape[0] - 1
    n, h = sensor.n_scan, sensor.horizon_scan
    cols = torch.div(torch.arange(n * h, device=dev), n,
                     rounding_mode="floor")

    def wedge(start, width):
        return ((cols - start) % h) < width

    def cast(k, scene_k=scene, **kw):
        return raycast_scan(scene_k, Pose(poses.R[k], poses.t[k]), sensor,
                            next_pose=Pose(poses.R[k + 1], poses.t[k + 1]),
                            motion=True, **kw)

    def uniform(seed, shape):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.rand(shape, generator=gen, device=dev)

    if clean is None and case in ("wedges", "dead_rings", "dropout"):
        clean = [cast(k) for k in range(n_scans)]
    out = []
    for k in range(n_scans):
        if case == "wedges":
            p, v, r = clean[k]
            s1 = (k * 131) % h
            v = v & ~(wedge(s1, h // 20) | wedge((s1 + h // 3) % h, h // 20))
        elif case == "dead_rings":
            p, v, r = clean[k]
            v = v & ~((r == 3) | (r == 11))
        elif case == "dropout":
            p, v, r = clean[k]
            v = v & (uniform(k, v.shape) > 0.35)
        elif case == "spin_warp":
            p, v, r = cast(k, spin_warp=0.1)
        elif case == "moving_object":
            bx, by = 15.0 - 1.2 * k, -2.0 + 0.4 * k
            car = torch.tensor([[bx, by, 0.0, bx + 3.0, by + 2.0, 2.0]],
                               dtype=torch.float32, device=dev)
            p, v, r = cast(k, Scene(torch.cat([scene.boxes.to(dev), car]),
                                    scene.cylinders))
        else:
            gen = torch.Generator(device=dev).manual_seed(k)
            p, v, r = cast(k, spin_warp=0.05, noise_sigma=0.02,
                           generator=gen)
            v = v & ~wedge((k * 173) % h, h // 24) \
                & (uniform(1000 + k, v.shape) > 0.2) & (r != 7)
        out.append((p, v, r))
    return out
