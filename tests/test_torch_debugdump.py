"""Debug dumps against the JAX package (``legoloam_tpu/utils/debugdump.py``):
the captured frontend planes of one scan, and the dumper's gating and
record names.

Tolerances (those of tests/test_torch_frontend.py): the projection's cell
assignment, validity and coordinates, the ground, cluster, segmented and
outlier masks are exact; ranges agree to 1e-6 relative (XLA:CPU contracts
into FMA, and its atan2 differs from libm's by an ulp); the curvature to
the bound those range differences and float32 summation allow through the
11-term sum and its square (stated in the test); the sharp and less-sharp
picks exactly; the flat picks, which tie on flat ground at curvature ~0,
to near-equal counts on ground rows.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np

from legoloam_tpu.config import DEFAULT as JD
from legoloam_tpu.models import pipeline as jpipe
from legoloam_tpu.ops.se3 import Pose as JPose
from legoloam_tpu.utils import debugdump as jdd
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch.models import pipeline as tpipe
from legoloam_tpu_torch.utils import debugdump as tdd

from _torch_parity import JCFG, TCFG, npy, port_cfg, tt

EXACT = ["xyz", "img_valid", "ground", "labels", "segmented", "outlier",
         "sharp_xyz", "sharp_valid", "feat_overflow"]


@functools.lru_cache(maxsize=None)
def _scan():
    pose = JPose(jnp.eye(3), jnp.array([2.0, 1.0, 0.8]))
    return tuple(np.asarray(a) for a in jsyn.raycast_scan(
        jsyn.default_scene(), pose, JD.sensor))


def test_capture_frontend_matches_jax():
    pts, valid, ring = _scan()
    j = {k: np.asarray(v) for k, v in
         jdd.capture_frontend(pts, valid, ring, JD).items()}
    t = {k: npy(v) for k, v in tdd.capture_frontend(
        tt(pts), tt(valid), tt(ring), port_cfg(JD)).items()}
    assert set(t) == set(j)
    for k in EXACT:
        assert np.array_equal(t[k], j[k]), k
    v = j["img_valid"]
    np.testing.assert_allclose(t["range"][v], j["range"][v], rtol=1e-6)
    assert np.array_equal(t["range"][~v], j["range"][~v])
    # Curvature = (sum of 11 range terms, weight 20 in all)^2: each range
    # moves by at most dr and each of the ~11 float32 additions of partial
    # sums up to 20 rmax rounds by half an ulp in either package, so the
    # sum moves by at most d = 20 dr + 11 eps 20 rmax and its square by
    # 2 |sum| d + d^2.
    dr = float(np.abs(t["range"][v] - j["range"][v]).max())
    rmax = float(j["range"][v].max())
    d = 20 * dr + 11 * np.finfo(np.float32).eps * 20 * rmax
    bound = 2 * np.sqrt(j["curvature"]) * d + d * d
    assert (np.abs(t["curvature"] - j["curvature"]) <= bound).all()
    tl, jl = t["pick_label"], j["pick_label"]
    assert tl.dtype == jl.dtype
    assert np.array_equal(tl == 2, jl == 2)
    assert np.array_equal(tl >= 1, jl >= 1)
    nt, nj = int((tl == -1).sum()), int((jl == -1).sum())
    assert nj > 50 and abs(nt - nj) <= max(4, nj // 50)
    rows = np.nonzero((tl == -1).any(1))[0]
    assert (rows < JD.sensor.ground_scan_ind + 1).all()
    assert int(t["sharp_valid"].sum()) > 0
    assert abs(int(t["flat_valid"].sum()) - int(j["flat_valid"].sum())) \
        <= max(4, nj // 50)


def test_dumper_gating_and_records(tmp_path):
    pts, valid, ring = _scan()
    jst, jout = jpipe.slam_scan_step(
        jpipe.init_slam_state(JCFG), jnp.asarray(pts), jnp.asarray(valid),
        jnp.asarray(ring), JCFG, 0.0, run_mapping=True)
    scan = (tt(pts), tt(valid), tt(ring))
    tst, tout = tpipe.slam_scan_step(
        tpipe.init_slam_state(TCFG, device="cpu"), *scan, TCFG, 0.0,
        run_mapping=True)

    off = tdd.DebugDumper(None, every=1)
    assert not off.due(0)
    assert not off.maybe_dump(0, scan, TCFG)
    dumper = tdd.DebugDumper(str(tmp_path / "port"), every=10)
    assert not dumper.due(5) and dumper.due(10)
    assert not dumper.maybe_dump(5, scan, TCFG, state=tst, diag=tout.diag)
    assert dumper.maybe_dump(10, scan, TCFG, state=tst, diag=tout.diag)
    jdd.DebugDumper(str(tmp_path / "jax"), every=10).maybe_dump(
        10, tuple(jnp.asarray(a) for a in (pts, valid, ring)), JCFG,
        state=jst, diag=jout.diag)
    assert os.listdir(tmp_path / "port") == ["scan_000010.npz"]
    t = np.load(tmp_path / "port" / "scan_000010.npz")
    j = np.load(tmp_path / "jax" / "scan_000010.npz")
    assert set(t.files) == set(j.files)
    for k in ("kf_count", "kf_overflow", "loop_count", "loop_dropped",
              "submap_corner_occ", "submap_surf_occ", "kf_t"):
        assert t[k].shape == j[k].shape, k
    assert int(t["kf_count"]) == int(j["kf_count"]) == 1
    assert int(t["diag_n_surf_corr"]) >= 0
