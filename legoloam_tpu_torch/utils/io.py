"""Scan and IMU files (port of ``legoloam_tpu/utils/io.py``): ctypes bindings
to the native C++ loader ``csrc/legoio.cpp``, the writers, and the IMU
sidecar.

The loader reads ``.lpk``, KITTI ``.bin`` and PCL ``.pcd`` files on worker
threads ahead of the consumer, filters non-finite points, pads to a fixed
point count and infers rings from elevation where a format carries none.
The shared library is built with g++ at first use into
``build/native/<hash>/`` beside the package, keyed by a hash of the source
and flags, so a stale library is never loaded.  There is no fallback: a
failed build raises with the compiler's message.  ``_read_scan_py`` is the
plain NumPy version of the reader, which the tests hold the native one to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import struct
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[1] / "csrc" / "legoio.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lock = threading.Lock()

_FP = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "legoio.so"


def build() -> Path:
    """Compile ``csrc/legoio.cpp`` unless a library for this exact source
    and these flags exists; raises with g++'s output when it fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        staged = os.path.join(tmp, out.name)
        try:
            res = subprocess.run(["g++", *GXX_FLAGS, "-o", staged, str(SRC)],
                                 capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run g++ to build {SRC.name}: {e}")
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n"
                               + res.stdout + res.stderr)
        os.replace(staged, out)       # atomic: never a half-written library
    return out


def library() -> ctypes.CDLL:
    """The loaded scan-IO library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.legoio_loader_create.restype = ctypes.c_void_p
            lib.legoio_loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.c_int]
            lib.legoio_loader_next.restype = ctypes.c_int
            lib.legoio_loader_next.argtypes = [ctypes.c_void_p, _FP, _U8P,
                                               _I32P]
            lib.legoio_loader_destroy.restype = None
            lib.legoio_loader_destroy.argtypes = [ctypes.c_void_p]
            lib.legoio_read_scan.restype = ctypes.c_int
            lib.legoio_read_scan.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, _FP, _U8P, _I32P]
            _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the scan-IO library builds and loads (``library()`` raises
    with the compiler's message where this is False)."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------

_LPK_REC = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("r", "<u2")])


def to_numpy(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a NumPy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def write_lpk(path, xyz, ring, valid):
    """LPK1: magic + uint32 count + packed {f32 x,y,z; u16 ring} records of
    the VALID points only."""
    keep = to_numpy(valid).astype(bool)
    xyz = to_numpy(xyz).astype(np.float32)[keep]
    ring = to_numpy(ring).astype(np.uint16)[keep]
    rec = np.zeros(xyz.shape[0], dtype=_LPK_REC)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["r"] = ring
    with open(path, "wb") as f:
        f.write(b"LPK1")
        f.write(struct.pack("<I", xyz.shape[0]))
        f.write(rec.tobytes())


def write_kitti_bin(path, xyz, valid):
    """KITTI velodyne records {f32 x, y, z, intensity = 0} of the valid
    points."""
    xyz = to_numpy(xyz).astype(np.float32)[to_numpy(valid).astype(bool)]
    rec = np.concatenate([xyz, np.zeros((xyz.shape[0], 1), np.float32)], 1)
    rec.tofile(path)


# ---------------------------------------------------------------------------
# IMU sidecar
# ---------------------------------------------------------------------------

_IMU_DTYPE = np.dtype([("t", "<f8"), ("rpy", "<f4", (3,)),
                       ("acc", "<f4", (3,)), ("gyro", "<f4", (3,))])


def write_imu(path, time, rpy, acc, gyro):
    """IMU1 sidecar: magic + uint32 count + packed {f64 t; f32 rpy[3] (world
    attitude); f32 acc[3] (sensor-frame specific force); f32 gyro[3]}
    records, sorted by time.  Times are sequence-relative seconds on the
    scan clock (rebase epoch stamps first: the pipeline runs float32)."""
    time = to_numpy(time).astype(np.float64)
    order = np.argsort(time, kind="stable")
    rec = np.zeros(time.shape[0], dtype=_IMU_DTYPE)
    rec["t"] = time[order]
    rec["rpy"] = to_numpy(rpy).astype(np.float32)[order]
    rec["acc"] = to_numpy(acc).astype(np.float32)[order]
    rec["gyro"] = to_numpy(gyro).astype(np.float32)[order]
    with open(path, "wb") as f:
        f.write(b"IMU1")
        f.write(struct.pack("<I", rec.shape[0]))
        f.write(rec.tobytes())


def read_imu(path):
    """An IMU1 sidecar -> (time (L,) f64, rpy (L, 3), acc (L, 3), gyro
    (L, 3) f32) NumPy arrays."""
    with open(path, "rb") as f:
        if f.read(4) != b"IMU1":
            raise IOError(f"not an IMU1 sidecar: {path}")
        (n,) = struct.unpack("<I", f.read(4))
        rec = np.frombuffer(f.read(), dtype=_IMU_DTYPE, count=n)
    return (rec["t"].astype(np.float64), rec["rpy"].astype(np.float32),
            rec["acc"].astype(np.float32), rec["gyro"].astype(np.float32))


class ImuSequence:
    """Per-scan fixed-size windows over a sequence's IMU stream.

    ``window_for(t0)`` returns the samples covering ``[t0 - margin, t0 +
    scan_period + margin]`` as an ``ops.deskew.ImuWindow`` of ``window``
    slots (zero-padded, masked by ``valid``) on the caller's device."""

    def __init__(self, time, rpy, acc, gyro, window: int = 64,
                 margin: float = 0.05):
        order = np.argsort(np.asarray(time))
        self.time = np.asarray(time, np.float64)[order]
        self.rpy = np.asarray(rpy, np.float32)[order]
        self.acc = np.asarray(acc, np.float32)[order]
        self.gyro = np.asarray(gyro, np.float32)[order]
        self.window = int(window)
        self.margin = float(margin)

    @classmethod
    def from_file(cls, path, window: int = 64, margin: float = 0.05):
        return cls(*read_imu(path), window=window, margin=margin)

    def window_for(self, t0: float, scan_period: float = 0.1, device="cpu"):
        from ..ops.deskew import ImuWindow

        lo = np.searchsorted(self.time, t0 - self.margin, side="left")
        hi = np.searchsorted(self.time, t0 + scan_period + self.margin,
                             side="right")
        # Keep the window's END when oversubscribed: the interpolation
        # clamps to the nearest sample, and the scan-end samples decide the
        # rotation over the scan.
        lo = max(lo, hi - self.window)
        n = hi - lo
        L = self.window
        time = np.zeros(L, np.float32)
        rpy = np.zeros((L, 3), np.float32)
        acc = np.zeros((L, 3), np.float32)
        gyro = np.zeros((L, 3), np.float32)
        valid = np.zeros(L, bool)
        time[:n] = self.time[lo:hi]
        rpy[:n] = self.rpy[lo:hi]
        acc[:n] = self.acc[lo:hi]
        gyro[:n] = self.gyro[lo:hi]
        valid[:n] = True
        return ImuWindow(*(torch.from_numpy(a).to(device)
                           for a in (time, rpy, acc, gyro, valid)))


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

def read_scan(path, point_cap: int, n_scan: int = 16,
              ang_bottom_deg: float = 15.1, ang_res_y_deg: float = 2.0
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One scan as (xyz (cap, 3) f32, valid (cap,) bool, ring (cap,) i32),
    read by the native library."""
    xyz = np.zeros((point_cap, 3), np.float32)
    valid = np.zeros(point_cap, np.uint8)
    ring = np.zeros(point_cap, np.int32)
    rc = library().legoio_read_scan(
        str(path).encode(), point_cap, n_scan, ang_bottom_deg, ang_res_y_deg,
        xyz.ctypes.data_as(_FP), valid.ctypes.data_as(_U8P),
        ring.ctypes.data_as(_I32P))
    if rc != 1:
        raise IOError(f"failed to read scan {path}")
    return xyz, valid.astype(bool), ring


def _infer_ring(x, y, z, n_scan, ang_bottom_deg, ang_res_y_deg):
    """Ring from elevation in float32, in the C reader's order of
    operations; -1 outside the sensor's fan (or for a non-finite point)."""
    f = np.float32
    with np.errstate(invalid="ignore"):
        vert = np.arctan2(z, np.sqrt(x * x + y * y)) * f(57.29577951308232)
        r = np.floor((vert + f(ang_bottom_deg)) / f(ang_res_y_deg))
        ok = np.isfinite(r) & (r >= 0) & (r < n_scan)
        return np.where(ok, r, -1).astype(np.int64)


_FLOAT_TOKEN = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def _ascii_floats(line: str):
    """A line's leading run of decimal floats, as ``istream >> float``
    reads them (it stops at the first token that is not one)."""
    vals = []
    for tok in line.split():
        if not _FLOAT_TOKEN.fullmatch(tok):
            break
        vals.append(np.float32(tok))
    return vals


def _read_pcd_records(path, cap, geom):
    """A PCD file's first ``cap`` points as (x, y, z, ring, valid), parsed
    as the C reader parses it: FIELDS/SIZE/POINTS up to DATA; binary records
    of the summed field sizes with the ring read as uint16; ASCII lines of
    floats, where a line too short for z marks its point invalid and a line
    without a ring column takes the ring from the elevation."""
    with open(path, "rb") as f:
        fields, sizes, n_points, binary = [], [], 0, False
        while True:
            line = f.readline()
            if not line:
                break
            parts = line.decode(errors="replace").split()
            if not parts:
                continue
            if parts[0] == "FIELDS":
                fields = parts[1:]
            elif parts[0] == "SIZE":
                sizes = [int(s) for s in parts[1:]]
            elif parts[0] == "POINTS":
                n_points = int(parts[1])
            elif parts[0] == "DATA":
                binary = len(parts) > 1 and parts[1] == "binary"
                break
        body = f.read()
    if not all(c in fields for c in "xyz"):
        raise IOError(f"PCD without x y z fields: {path}")
    offs, stride = [], 0
    for i in range(len(fields)):
        offs.append(stride)
        stride += sizes[i] if i < len(sizes) else 4
    col = {name: i for i, name in enumerate(fields)}
    xi, yi, zi, ri = col["x"], col["y"], col["z"], col.get("ring")
    m = min(n_points, cap)
    if binary:
        m = min(m, len(body) // stride)
        raw = np.frombuffer(body[:m * stride], np.uint8).reshape(m, stride)

        def field(i, dt):
            o = offs[i]
            w = np.dtype(dt).itemsize
            return np.ascontiguousarray(raw[:, o:o + w]).view(dt)[:, 0]

        x, y, z = field(xi, "<f4"), field(yi, "<f4"), field(zi, "<f4")
        v = np.isfinite(x) & np.isfinite(y) & np.isfinite(z)
        if ri is not None:
            r = field(ri, "<u2").astype(np.int64)
        else:
            r = np.where(v, _infer_ring(x, y, z, *geom), -1)
        return x, y, z, r, v & (r >= 0)
    lines = body.decode(errors="replace").splitlines()[:m]
    n = len(lines)
    x, y, z = (np.zeros(n, np.float32) for _ in range(3))
    r = np.full(n, -1, np.int64)
    v = np.zeros(n, bool)
    for i, line in enumerate(lines):
        vals = _ascii_floats(line)
        if len(vals) <= zi:
            continue
        x[i], y[i], z[i] = vals[xi], vals[yi], vals[zi]
        if ri is not None and ri < len(vals):
            r[i] = int(vals[ri])
        else:
            r[i] = _infer_ring(x[i:i + 1], y[i:i + 1], z[i:i + 1], *geom)[0]
        v[i] = np.isfinite(x[i]) and np.isfinite(y[i]) and \
            np.isfinite(z[i]) and r[i] >= 0
    return x, y, z, r, v


def _read_scan_py(path, cap, n_scan=16, ang_bottom_deg=15.1,
                  ang_res_y_deg=2.0):
    """The plain version of ``read_scan``: the same formats and the same
    outputs as ``csrc/legoio.cpp``, in NumPy."""
    path = str(path)
    geom = (n_scan, ang_bottom_deg, ang_res_y_deg)
    if path.endswith(".bin"):
        rec = np.fromfile(path, np.float32)
        rec = rec[:rec.size // 4 * 4].reshape(-1, 4)[:cap]
        x, y, z = rec[:, 0], rec[:, 1], rec[:, 2]
        v = np.isfinite(rec[:, :3]).all(1) & ((x != 0) | (y != 0) | (z != 0))
        r = np.where(v, _infer_ring(x, y, z, *geom), -1)
        v = v & (r >= 0)
    elif path.endswith(".lpk"):
        with open(path, "rb") as f:
            if f.read(4) != b"LPK1":
                raise IOError(f"not an LPK1 scan: {path}")
            (n,) = struct.unpack("<I", f.read(4))
            m = min(n, cap)
            buf = bytearray(m * _LPK_REC.itemsize)   # a short file reads 0s
            got = f.read(len(buf))
            buf[:len(got)] = got
        rec = np.frombuffer(bytes(buf), dtype=_LPK_REC, count=m)
        x, y, z = rec["x"], rec["y"], rec["z"]
        v = np.isfinite(x) & np.isfinite(y) & np.isfinite(z)
        r = rec["r"].astype(np.int64)
    elif path.endswith(".pcd"):
        x, y, z, r, v = _read_pcd_records(path, cap, geom)
    else:
        raise IOError(f"unsupported scan format: {path}")
    m = len(x)
    xyz = np.zeros((cap, 3), np.float32)
    valid = np.zeros(cap, bool)
    ring = np.zeros(cap, np.int32)
    xyz[:m, 0], xyz[:m, 1], xyz[:m, 2] = x, y, z
    valid[:m] = v
    ring[:m] = np.where(r >= 0, r, 0)
    return xyz, valid, ring


class ScanLoader:
    """Prefetching sequence loader over the native library: iterates
    (xyz, valid, ring) NumPy triples in file order, skipping unreadable
    files; reading and parsing run on C++ worker threads ahead of the
    consumer."""

    def __init__(self, paths: Sequence, point_cap: int, n_scan: int = 16,
                 ang_bottom_deg: float = 15.1, ang_res_y_deg: float = 2.0,
                 n_threads: int = 4, prefetch: int = 8):
        self.paths = [str(p) for p in paths]
        self.point_cap = point_cap
        self._lib = library()
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._handle = self._lib.legoio_loader_create(
            arr, len(self.paths), point_cap, n_scan, ang_bottom_deg,
            ang_res_y_deg, n_threads, prefetch)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                         np.ndarray]]:
        while self._handle is not None:
            xyz = np.zeros((self.point_cap, 3), np.float32)
            valid = np.zeros(self.point_cap, np.uint8)
            ring = np.zeros(self.point_cap, np.int32)
            rc = self._lib.legoio_loader_next(
                self._handle, xyz.ctypes.data_as(_FP),
                valid.ctypes.data_as(_U8P), ring.ctypes.data_as(_I32P))
            if rc == 0:
                return
            if rc < 0:
                continue      # unreadable file: skipped, like a lost message
            yield xyz, valid.astype(bool), ring

    def close(self):
        if self._handle is not None:
            self._lib.legoio_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
