"""Frontend parity: projection, segmentation (kernel K1's plain version) and
features (kernel K2's plain version) against the JAX package's XLA path and
its Pallas kernels in interpret mode, on synthetic VLP-16 scans and seeded
random clouds.

Tolerances: projection assigns the same point to every cell (valid, xyz
exact); its computed channels (range, relative time) agree to float32
rounding, because XLA:CPU contracts a*b+c into FMA and its atan2 differs
from libm's by an ulp.  Segmentation labels and masks are exact.  Pick
labels are exact wherever no two candidates tie to within float32 rounding:
every cloud but ``flat`` is exact.  Perfectly flat ground ties at curvature
~0, where the FMA difference reorders ties (the JAX package's own XLA and
Pallas paths differ there the same way, tests/test_features_pallas.py): the
flat cloud keeps the same per-ring slots at the reference pick counts and
near-equal counts at the default ones.  With ranges quantised so every
curvature sum is exact, all labels are exact at the default counts.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu import config as jcfg
from legoloam_tpu.config import DEFAULT as JD
from legoloam_tpu.ops import features as jfeat
from legoloam_tpu.ops import projection as jproj
from legoloam_tpu.ops import segmentation as jseg
from legoloam_tpu.ops.ccl_pallas import label_propagation_pallas
from legoloam_tpu.ops.features_pallas import pick_labels_pallas
from legoloam_tpu.ops.se3 import Pose as JPose
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch.ops import ccl_cuda, features_cuda
from legoloam_tpu_torch.ops import features as tfeat
from legoloam_tpu_torch.ops import projection as tproj
from legoloam_tpu_torch.ops import segmentation as tseg

from _torch_parity import npy, port_cfg, tt

SENSOR = JD.sensor
TSENSOR = port_cfg(SENSOR)
CLOUDS = ["sharp", "less_sharp", "flat", "less_flat", "outlier"]


def _random_cloud(seed=0, n=20000):
    """Seeded random points on the column grid (azimuth jitter well inside
    a column, so rounding never sits at a half), with cell collisions,
    out-of-range rings, short ranges and invalid points."""
    rng = np.random.RandomState(seed)
    k = rng.randint(-1349, 451, n)
    hd = np.radians(90.0 - 0.2 * k + rng.uniform(-0.04, 0.04, n))
    el = np.radians(rng.uniform(-15.0, 15.0, n))
    r = rng.uniform(0.5, 80.0, n)
    pts = np.stack([r * np.cos(el) * np.sin(hd), r * np.cos(el) * np.cos(hd),
                    r * np.sin(el)], axis=1).astype(np.float32)
    ring = rng.randint(-1, 17, n).astype(np.int32)
    valid = rng.rand(n) > 0.1
    return pts, valid, ring


@functools.lru_cache(maxsize=None)
def _scan(case: str):
    if case == "random":
        return _random_cloud()
    scene = jsyn.default_scene()
    if case == "static":
        pose = JPose(jnp.eye(3), jnp.array([1.5, -0.7, 0.8]))
        out = jsyn.raycast_scan(scene, pose, SENSOR)
    else:
        poses = jsyn.circle_trajectory(2, radius=20.0, angular_rate=0.02)
        out = jsyn.raycast_scan(
            scene, JPose(poses.R[0], poses.t[0]), SENSOR,
            next_pose=JPose(poses.R[1], poses.t[1]), motion=True)
    return tuple(np.asarray(a) for a in out)


@functools.lru_cache(maxsize=None)
def _image(case: str):
    pts, valid, ring = _scan(case)
    return jproj.project_scan(jnp.asarray(pts), jnp.asarray(valid), SENSOR,
                              ring=jnp.asarray(ring))


def _timg(img):
    return tproj.RangeImage(*(tt(a) for a in img))


def _jseg(img, backend):
    cfg = dataclasses.replace(JD.seg, ccl_backend=backend)
    return jseg.segment(img, SENSOR, cfg)


@pytest.mark.parametrize("case", ["static", "motion", "random"])
def test_projection_cell_for_cell(case):
    pts, valid, ring = _scan(case)
    j = _image(case)
    t = tproj.project_scan(tt(pts), tt(valid), TSENSOR, ring=tt(ring))
    v = np.asarray(j.valid)
    assert (npy(t.valid) == v).all()
    assert v.sum() > 1000
    assert np.array_equal(npy(t.xyz), np.asarray(j.xyz))
    np.testing.assert_allclose(npy(t.rng)[v], np.asarray(j.rng)[v],
                               rtol=1e-6)
    assert np.isinf(npy(t.rng)[~v]).all()
    np.testing.assert_allclose(npy(t.rel_time), np.asarray(j.rel_time),
                               atol=2e-6)
    np.testing.assert_allclose(npy(t.start_ori), np.asarray(j.start_ori),
                               atol=1e-6)
    np.testing.assert_allclose(npy(t.end_ori), np.asarray(j.end_ori),
                               atol=1e-5)


@pytest.mark.parametrize("case", ["static", "motion"])
def test_segmentation_exact(case):
    img = _image(case)
    t = tseg.segment(_timg(img), TSENSOR, port_cfg(JD.seg))
    for backend in ("xla", "pallas"):
        j = _jseg(img, backend)
        for f in jseg.Segmentation._fields:
            assert np.array_equal(npy(getattr(t, f)),
                                  np.asarray(getattr(j, f))), (backend, f)
    assert int(t.n_clusters) > 5


def _ccl_inputs(case):
    if case in ("random", "dense"):
        # "random" converges in 8 sweeps; "dense" percolates into snakes
        # that need more than the 32-sweep cap.
        p = 0.4 if case == "random" else 0.25
        rng = np.random.RandomState(5)
        seeds = rng.rand(16, 1800) > p
        return seeds, rng.rand(16, 1800) > p, rng.rand(15, 1800) > p
    img = _image(case)
    ground = jseg.ground_removal(img, SENSOR, JD.seg)
    ch, cv = jseg._connectivity(img, SENSOR, JD.seg)
    return (np.asarray(img.valid & ~ground), np.asarray(ch), np.asarray(cv))


@pytest.mark.parametrize("case", ["static", "random"])
def test_ccl_plain_matches_jax(case):
    seeds, ch, cv = _ccl_inputs(case)
    lab, rmin, rmax, sweeps = ccl_cuda.label_propagation_plain(
        tt(seeds), tt(ch), tt(cv), JD.seg.ccl_max_iters)
    assert sweeps < JD.seg.ccl_max_iters          # reached the fixpoint
    lab_x = jseg._label_propagation(jnp.asarray(seeds), jnp.asarray(ch),
                                    jnp.asarray(cv), JD.seg.ccl_max_iters)
    lab_p, rmin_p, rmax_p = label_propagation_pallas(
        jnp.asarray(seeds), jnp.asarray(ch), jnp.asarray(cv),
        JD.seg.ccl_max_iters, interpret=True)
    assert np.array_equal(npy(lab), np.asarray(lab_x))
    assert np.array_equal(npy(lab), np.asarray(lab_p))
    assert np.array_equal(npy(rmin)[seeds], np.asarray(rmin_p)[seeds])
    assert np.array_equal(npy(rmax)[seeds], np.asarray(rmax_p)[seeds])
    # Labels are each component's minimum flat index.
    flat = np.arange(seeds.size).reshape(seeds.shape)
    assert (npy(lab)[seeds] <= flat[seeds]).all()


@pytest.mark.parametrize("case", ["scan", "random"])
def test_ccl_plain_matches_jax_hdl32e(case):
    """K1's plain version against the JAX XLA path at the HDL-32E shape
    (32 x 1800): a ray-cast HDL-32E scan and a seeded random mask.  Exact
    (labels are partition-determined)."""
    sensor = jcfg.for_sensor("hdl32e").sensor
    if case == "scan":
        pose = JPose(jnp.eye(3), jnp.array([1.5, -0.7, 0.8]))
        pts, valid, ring = jsyn.raycast_scan(jsyn.default_scene(), pose,
                                             sensor)
        img = jproj.project_scan(pts, valid, sensor, ring=ring)
        ground = jseg.ground_removal(img, sensor, JD.seg)
        ch, cv = jseg._connectivity(img, sensor, JD.seg)
        seeds, ch, cv = (np.asarray(a) for a in (img.valid & ~ground, ch, cv))
    else:
        rng = np.random.RandomState(6)
        seeds, ch, cv = (rng.rand(*s) > 0.4
                         for s in ((32, 1800), (32, 1800), (31, 1800)))
    assert seeds.shape == (32, 1800) and seeds.sum() > 1000
    lab, rmin, rmax, sweeps = ccl_cuda.label_propagation_plain(
        tt(seeds), tt(ch), tt(cv), JD.seg.ccl_max_iters)
    assert sweeps < JD.seg.ccl_max_iters
    lab_x = jseg._label_propagation(jnp.asarray(seeds), jnp.asarray(ch),
                                    jnp.asarray(cv), JD.seg.ccl_max_iters)
    assert np.array_equal(npy(lab), np.asarray(lab_x))
    rings = np.broadcast_to(np.arange(32)[:, None], seeds.shape)
    for root in np.unique(npy(lab)[seeds])[:200]:
        members = npy(lab) == root
        assert (npy(rmin)[members] == rings[members].min()).all()
        assert (npy(rmax)[members] == rings[members].max()).all()


def test_ccl_plain_keeps_the_sweep_cap():
    """Where the sweeps hit ``ccl_max_iters`` before the fixpoint, the plain
    version stops where the JAX XLA path stops, label for label."""
    seeds, ch, cv = _ccl_inputs("dense")
    lab, _, _, sweeps = ccl_cuda.label_propagation_plain(
        tt(seeds), tt(ch), tt(cv), JD.seg.ccl_max_iters)
    assert sweeps == JD.seg.ccl_max_iters
    lab_x = jseg._label_propagation(jnp.asarray(seeds), jnp.asarray(ch),
                                    jnp.asarray(cv), JD.seg.ccl_max_iters)
    assert np.array_equal(npy(lab), np.asarray(lab_x))


def _jfeat(img, seg, feat_cfg, backend):
    return jfeat.extract_features(
        img, seg, SENSOR, dataclasses.replace(feat_cfg, picks_backend=backend))


def _assert_cloud_equal(a, b, name):
    va = npy(a.valid)
    assert np.array_equal(va, np.asarray(b.valid)), name
    for f in ("xyz", "ring", "rel_time"):
        assert np.array_equal(npy(getattr(a, f))[va],
                              np.asarray(getattr(b, f))[va]), (name, f)


def _features_case(feat_cfg, quantise=False, case="static"):
    img = _image(case)
    if quantise:
        q = jnp.where(img.valid, jnp.round(img.rng * 256.0) / 256.0, img.rng)
        img = img._replace(rng=q)
    seg = _jseg(img, "xla")
    t = tfeat.extract_features(_timg(img), tseg.Segmentation(
        *(tt(a) for a in seg)), TSENSOR, port_cfg(feat_cfg))
    return img, seg, t


@pytest.mark.parametrize("counts", ["reference", "default"])
def test_features_match_jax(counts):
    fc = JD.feat if counts == "default" else dataclasses.replace(
        JD.feat, edge_per_section=2, surf_per_section=4)
    img, seg, t = _features_case(fc)
    for backend in ("xla", "pallas"):
        j = _jfeat(img, seg, fc, backend)
        for name in CLOUDS:
            if name != "flat":
                _assert_cloud_equal(getattr(t, name), getattr(j, name), name)
        if counts == "default":
            assert np.array_equal(npy(t.overflow), np.asarray(j.overflow))
        ta, ja = t.flat, j.flat
        if counts == "reference":
            # No section runs dry: the same picks per ring, in the same
            # slots (the JAX package's XLA-vs-Pallas contract).
            assert np.array_equal(npy(ta.valid), np.asarray(ja.valid))
            assert np.array_equal(npy(ta.ring), np.asarray(ja.ring))
        else:
            na, nb = int(ta.valid.sum()), int(ja.valid.sum())
            assert abs(na - nb) <= max(4, nb // 50)
        rows = npy(ta.ring)[npy(ta.valid)].astype(int)
        assert (rows < SENSOR.ground_scan_ind + 1).all()
    assert int(t.sharp.valid.sum()) > 0 and int(t.flat.valid.sum()) > 0


def test_features_exact_with_quantised_ranges():
    """Ranges on a 1/256 m grid make every curvature sum exact in float32,
    so FMA contraction cannot reorder ties: all five clouds match the XLA
    path, and the pick labels match the Pallas kernel, at the default pick
    counts."""
    fc = JD.feat
    img, seg, t = _features_case(fc, quantise=True)
    j = _jfeat(img, seg, fc, "xla")
    for name in CLOUDS:
        _assert_cloud_equal(getattr(t, name), getattr(j, name), name)
    c, count = jfeat._compact_rings(img, seg)
    in_ring = jnp.arange(img.rng.shape[1])[None, :] < count[:, None]
    rng = jnp.where(in_ring, c["rng"], 0.0)
    lab_p = pick_labels_pallas(rng, c["col"], c["ground"], count, fc,
                               interpret=True)
    lab_t = features_cuda.pick_labels_plain(
        tt(rng), tt(c["col"]), tt(c["ground"]), tt(count), port_cfg(fc))
    assert np.array_equal(npy(lab_t), np.asarray(lab_p))
    assert (npy(lab_t) == -1).sum() > 100


def test_compaction_matches_jax():
    img = _image("motion")
    seg = _jseg(img, "xla")
    cj, count_j = jfeat._compact_rings(img, seg)
    ct, count_t = tfeat._compact_rings(_timg(img), tseg.Segmentation(
        *(tt(a) for a in seg)))
    assert np.array_equal(npy(count_t), np.asarray(count_j))
    for k in ("xyz", "rng", "col", "ground", "rel"):
        assert np.array_equal(npy(ct[k]), np.asarray(cj[k])), k
