"""Scan and IMU files: the port's writers and readers against the JAX
package's (``legoloam_tpu/utils/io.py``) on the same seeded numpy inputs.

Tolerance: none.  Writers give byte-identical files; the native reader
(built from ``legoloam_tpu_torch/csrc/legoio.cpp``) equals the JAX package's
``read_scan`` and the port's plain NumPy reader bitwise on .lpk, .bin (ring
inference), and ASCII and binary .pcd; IMU windows equal the JAX package's
field by field.
"""

import numpy as np
import pytest
import torch

from legoloam_tpu.utils import io as jio
from legoloam_tpu_torch.utils import io as tio

CAP = 700
PCD_HEADER = ("VERSION 0.7\nFIELDS {fields}\nSIZE {sizes}\nTYPE {types}\n"
              "COUNT {counts}\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              "POINTS {n}\nDATA {mode}\n")


@pytest.fixture(scope="module")
def sample():
    """500 seeded points spread over (and beyond) the VLP-16 fan, some
    invalid, a few non-finite and one at the origin."""
    rng = np.random.default_rng(0)
    n = 500
    xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    r = np.linalg.norm(xyz[:, :2], axis=1)
    xyz[:, 2] = r * np.tan(np.radians(rng.uniform(-17, 17, n))).astype(
        np.float32)
    xyz[7] = np.nan
    xyz[11, 1] = np.inf
    xyz[13] = 0.0
    ring = rng.integers(0, 16, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    valid[[7, 11, 13]] = True
    return xyz, valid, ring


def _read_all(path):
    return (tio.read_scan(path, CAP), jio.read_scan(path, CAP),
            tio._read_scan_py(path, CAP))


def _assert_same(path, min_valid):
    native, jax_pkg, plain = _read_all(path)
    for a, b, c in zip(native, jax_pkg, plain):
        assert a.dtype == b.dtype == c.dtype
        assert np.array_equal(a, b, equal_nan=True)
        assert np.array_equal(a, c, equal_nan=True)
    assert int(native[1].sum()) >= min_valid


def test_lpk_and_bin_writers_and_readers(sample, tmp_path):
    xyz, valid, ring = sample
    for name, writer, args in (
            ("lpk", "write_lpk", (xyz, ring, valid)),
            ("bin", "write_kitti_bin", (xyz, valid))):
        a, b = tmp_path / f"port.{name}", tmp_path / f"jax.{name}"
        getattr(tio, writer)(a, *args)
        getattr(jio, writer)(b, *args)
        assert a.read_bytes() == b.read_bytes()
        _assert_same(a, 400)
    # Writers take tensors as well.
    c = tmp_path / "tensor.lpk"
    tio.write_lpk(c, torch.from_numpy(xyz), torch.from_numpy(ring),
                  torch.from_numpy(valid))
    assert c.read_bytes() == (tmp_path / "port.lpk").read_bytes()


def _write_pcd(path, xyz, ring, binary, with_ring):
    n = xyz.shape[0]
    fields = "x y z intensity" + (" ring" if with_ring else "")
    head = PCD_HEADER.format(
        fields=fields, sizes="4 4 4 4" + (" 2" if with_ring else ""),
        types="F F F F" + (" U" if with_ring else ""),
        counts="1 1 1 1" + (" 1" if with_ring else ""), n=n,
        mode="binary" if binary else "ascii")
    with open(path, "wb") as f:
        f.write(head.encode())
        if binary:
            dt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("i", "<f4")]
            if with_ring:
                dt.append(("r", "<u2"))
            rec = np.zeros(n, dtype=dt)
            rec["x"], rec["y"], rec["z"] = xyz.T
            rec["i"] = 0.5
            if with_ring:
                rec["r"] = ring
            f.write(rec.tobytes())
        else:
            for k in range(n):
                line = f"{xyz[k, 0]:.9g} {xyz[k, 1]:.9g} {xyz[k, 2]:.9g} 0.5"
                if with_ring and k % 5:
                    line += f" {ring[k]}"       # some lines lack the ring
                if k % 97 == 3:
                    line = f"{xyz[k, 0]:.9g}"   # too short: invalid point
                f.write((line + "\n").encode())


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("with_ring", [False, True])
def test_pcd_readers(sample, tmp_path, binary, with_ring):
    xyz, valid, ring = sample
    keep = np.isfinite(xyz).all(1)          # ASCII PCD carries no nan/inf
    pts = xyz if binary else xyz[keep]
    p = tmp_path / "scan.pcd"
    _write_pcd(p, pts, ring[:len(pts)], binary, with_ring)
    _assert_same(p, 350)


def test_point_cap_truncates(sample, tmp_path):
    xyz, valid, ring = sample
    p = tmp_path / "s.lpk"
    tio.write_lpk(p, xyz, ring, valid)
    a = tio.read_scan(p, 100)
    b = tio._read_scan_py(p, 100)
    assert a[0].shape == (100, 3)
    assert all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))


def test_loader_order_and_skips_unreadable(sample, tmp_path):
    xyz, valid, ring = sample
    paths = []
    for k in range(10):
        p = tmp_path / f"seq{k:03d}.lpk"
        tio.write_lpk(p, xyz + np.float32(k), ring, valid)
        paths.append(p)
    bad = tmp_path / "bad.lpk"
    bad.write_bytes(b"NOTAMAGIC")
    seq = paths[:4] + [bad, tmp_path / "missing.lpk"] + paths[4:]
    with tio.ScanLoader(seq, point_cap=CAP, n_threads=3, prefetch=2) as ld:
        got = list(ld)
    assert len(got) == 10
    for k, (x, v, r) in enumerate(got):
        want = tio._read_scan_py(paths[k], CAP)
        assert all(np.array_equal(a, b, equal_nan=True)
                   for a, b in zip((x, v, r), want))


def test_unreadable_scan_raises(tmp_path):
    p = tmp_path / "bad.lpk"
    p.write_bytes(b"NOTAMAGIC")
    with pytest.raises(IOError):
        tio.read_scan(p, CAP)


def test_build_is_keyed_by_content():
    path = tio.library_path()
    assert tio.build() == path and path.exists()
    assert path.parent.parent.name == "native"


def test_imu_roundtrip_and_windows(tmp_path):
    rng = np.random.default_rng(1)
    L = 400                          # 2 s at 200 Hz
    t = np.arange(L) / 200.0
    rpy = rng.normal(0, 0.1, (L, 3)).astype(np.float32)
    acc = rng.normal(0, 1.0, (L, 3)).astype(np.float32)
    gyro = rng.normal(0, 0.2, (L, 3)).astype(np.float32)
    shuffled = rng.permutation(L)
    a, b = tmp_path / "port.imu", tmp_path / "jax.imu"
    tio.write_imu(a, t[shuffled], rpy[shuffled], acc[shuffled],
                  gyro[shuffled])
    jio.write_imu(b, t[shuffled], rpy[shuffled], acc[shuffled],
                  gyro[shuffled])
    assert a.read_bytes() == b.read_bytes()
    for x, y in zip(tio.read_imu(a), jio.read_imu(b)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for window in (64, 16):
        ts = tio.ImuSequence.from_file(a, window=window, margin=0.05)
        js = jio.ImuSequence.from_file(b, window=window, margin=0.05)
        for t0 in (-0.2, 0.0, 1.0, 1.93, 2.5):
            tw = ts.window_for(t0, scan_period=0.1, device="cpu")
            jw = js.window_for(t0, scan_period=0.1)
            assert tw._fields == jw._fields
            for f in tw._fields:
                x, y = getattr(tw, f).numpy(), np.asarray(getattr(jw, f))
                assert x.dtype == y.dtype and np.array_equal(x, y), (
                    window, t0, f)
