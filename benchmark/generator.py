"""The scan stream: synthetic LiDAR scans ray-cast on the device from a
seed, the stand-in for the sensor.

The world, the trajectory and the ray-caster are frozen copies of
``loop_scene``, ``circle_trajectory`` and ``raycast_scan`` in
``legoloam_tpu_torch/utils/synthetic.py`` (ground plane z = 0, boxes and
vertical cylinders; points in emission order, one column of all rings a
firing, with motion distortion), so a change to the port cannot move the
yardstick.  A traffic mix's parameters say which world, how the sensor
moves and how much range noise each scan carries; the seed draws the start
phase on the lap and the noise.  Every seed gives the same number of
scans of the same size: only where on the lap they are taken, and the
noise, differ.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .reference import se3
from .reference.se3 import Pose

MAX_RANGE = 100.0


class Scene(NamedTuple):
    """Boxes (K, 6) [xmin ymin zmin xmax ymax zmax], cylinders (M, 4)
    [cx cy radius height], ground plane z = 0."""

    boxes: torch.Tensor
    cylinders: torch.Tensor

    def to(self, device) -> "Scene":
        return Scene(self.boxes.to(device), self.cylinders.to(device))


def loop_scene() -> Scene:
    """A 90x90 m block with a collision-free ring lane of radius ~30 m
    around (0, 30), buildings inside and outside the lane, poles and crates
    along it."""
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


WORLDS = {"ring": loop_scene}


def circle_trajectory(n_scans: int, radius: float, height: float,
                      angular_rate: float, phase: float = 0.0,
                      device=None) -> Pose:
    """Poses driving a circle of ``radius`` through the origin (yaw tangent
    to the path), the first at angle ``phase`` on it."""
    th = phase + angular_rate * torch.arange(n_scans, dtype=torch.float32,
                                             device=device)
    t = torch.stack([radius * torch.sin(th), radius * (1 - torch.cos(th)),
                     torch.full_like(th, height)], dim=-1)
    return Pose(se3.rot_z(th), t)


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


def _ray_dirs(sensor, device) -> torch.Tensor:
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


def raycast_scans(scene: Scene, R0, t0, R1, t1, sensor, noise_sigma=0.0,
                  generators=None, motion: bool = False,
                  chunk: int = 1 << 17):
    """B scans at once, scan b from pose (R0[b], t0[b]) on ``t0``'s
    device: a list of (points (P, 3) in the sensor frame at each point's
    firing time, valid (P,), ring (P,) int32) in emission order, P =
    H*N_SCAN.  With ``motion`` the sensor moves to (R1[b], t1[b]) during
    the sweep.  Range noise ``noise_sigma`` (m) is drawn for scan b from
    ``generators[b]``.  A scan's points depend on the batch it is cast in
    only through the shapes of the batched products, so a stream casts
    every scan in the same batch (``ScanStream``)."""
    h, n = sensor.horizon_scan, sensor.n_scan
    B = R0.shape[0]
    dev = t0.device
    scene = scene.to(dev)
    dirs = _ray_dirs(sensor, dev)
    p_total = h * n
    if motion:
        frac = torch.div(torch.arange(p_total, device=dev), n,
                         rounding_mode="floor").to(torch.float32) / h
        R_t = se3.so3_interp(R0[:, None].expand(B, p_total, 3, 3),
                             R1[:, None].expand(B, p_total, 3, 3),
                             frac.expand(B, p_total))
        t_t = t0[:, None] + frac[None, :, None] * (t1 - t0)[:, None]
    else:
        R_t = R0[:, None].expand(B, p_total, 3, 3)
        t_t = t0[:, None].expand(B, p_total, 3)
    R_t = R_t.reshape(B * p_total, 3, 3)
    t_t = t_t.reshape(B * p_total, 3)
    d_world = (R_t @ dirs.repeat(B, 1)[:, :, None])[..., 0]
    s = torch.cat([
        torch.minimum(torch.minimum(
            _ray_ground(t_t[i:i + chunk], d_world[i:i + chunk]),
            _ray_boxes(t_t[i:i + chunk], d_world[i:i + chunk], scene.boxes)),
            _ray_cylinders(t_t[i:i + chunk], d_world[i:i + chunk],
                           scene.cylinders))
        for i in range(0, B * p_total, chunk)]).reshape(B, p_total)
    if noise_sigma > 0:
        s = s + noise_sigma * torch.stack([
            torch.randn(p_total, generator=g, device=dev)
            for g in generators])
    valid = (s > sensor.min_range) & (s < MAX_RANGE)
    pts = dirs[None] * torch.where(valid, s, torch.zeros_like(s))[..., None]
    ring = torch.arange(n, dtype=torch.int32, device=dev).repeat(h)
    return [(pts[b], valid[b], ring) for b in range(B)]


def _mix(seed: int, k: int) -> int:
    """A 63-bit generator seed for scan ``k`` of run ``seed``."""
    return (seed * 0x9E3779B97F4A7C15 + k * 0xBF58476D1CE4E5B9 + 1) \
        % (1 << 63)


class ScanStream:
    """Scan ``k`` of a run: its pose on the traffic's trajectory from the
    seed's start phase, and its ray-cast points with the seed's noise.
    Scans are cast ``cast_batch`` at a time, in batches aligned to
    multiples of it, so the same (traffic, seed, sensor) gives the same
    scans, bit for bit, on one device, however often and in whatever order
    they are asked for: the program and the reference are handed the same
    scans.

    Traffic keys: ``world`` (``ring``), ``radius``, ``height`` (m),
    ``angular_rate`` (rad a scan), ``motion`` (distortion on),
    ``noise_sigma`` (m), ``cast_batch`` (scans a ray-casting call)."""

    def __init__(self, traffic: dict, seed: int, sensor, device):
        self.traffic = traffic
        self.seed = int(seed)
        self.sensor = sensor
        self.device = torch.device(device)
        self.scene = WORLDS[traffic["world"]]().to(self.device)
        rng = np.random.default_rng(self.seed % (1 << 63))
        self.phase = float(rng.uniform(0.0, 2.0 * math.pi))
        self.sigma = float(traffic["noise_sigma"])
        self.batch = int(traffic["cast_batch"])
        self._last = (None, None)

    def _cast(self, k0: int) -> list:
        b, tr = self.batch, self.traffic
        p = circle_trajectory(b + 1, tr["radius"], tr["height"],
                              tr["angular_rate"],
                              self.phase + tr["angular_rate"] * k0,
                              self.device)
        gens = None
        if self.sigma > 0:
            gens = []
            for k in range(k0, k0 + b):
                g = torch.Generator(device=self.device)
                g.manual_seed(_mix(self.seed, k))
                gens.append(g)
        return raycast_scans(self.scene, p.R[:b], p.t[:b], p.R[1:], p.t[1:],
                             self.sensor, noise_sigma=self.sigma,
                             generators=gens, motion=bool(tr["motion"]))

    def scan(self, k: int):
        """(points (P, 3), valid (P,), ring (P,)) of scan ``k``."""
        k0 = k - k % self.batch
        if self._last[0] != k0:
            self._last = (None, None)
            self._last = (k0, self._cast(k0))
        return self._last[1][k - k0]

    def scans(self, k0: int, k1: int) -> list:
        """Scans [k0, k1)."""
        return [self.scan(k) for k in range(k0, k1)]
