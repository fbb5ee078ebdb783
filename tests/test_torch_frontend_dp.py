"""The data-parallel frontend with a batch axis: the port's
``pipeline.process_scans`` (projection, segmentation with K1's plain
version, features with K2's plain version, a leading (B,) throughout) and
``parallel.frontend_dp.make_batched_frontend`` against the JAX package's
``make_batched_frontend`` (``jit(vmap(process_scan))`` over an 8-device CPU
mesh), against the port's own single-scan path, and through
``step_graph.FrontendGraph`` under ``StaticRunner``.

Tolerances, scan by scan, as tests/test_torch_frontend.py holds one scan:
projection cells (valid) and segmentation labels exact, projected xyz
within 1e-5 m; every feature cloud but ``flat`` exact; ``flat`` within its
pick-count slack (flat-ground ties at curvature ~0 reorder under XLA's FMA
contraction; the JAX package's XLA and Pallas paths differ there the same
way).  The port's batched path against its single-scan path is bitwise:
the batch changes no arithmetic.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu import config as jcfg
from legoloam_tpu.config import DEFAULT as JD
from legoloam_tpu.ops import projection as jproj
from legoloam_tpu.ops import segmentation as jseg
from legoloam_tpu.ops.se3 import Pose as JPose
from legoloam_tpu.parallel import frontend_dp as jfrontend_dp
from legoloam_tpu.parallel import mesh as jmesh
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch.models import pipeline as tpipe
from legoloam_tpu_torch.models import step_graph
from legoloam_tpu_torch.ops import ccl_cuda, features_cuda
from legoloam_tpu_torch.ops import features as tfeat
from legoloam_tpu_torch.ops import projection as tproj
from legoloam_tpu_torch.ops import segmentation as tseg
from legoloam_tpu_torch.ops.segments import leaves
from legoloam_tpu_torch.parallel import dryrun, frontend_dp
from legoloam_tpu_torch.parallel.mesh import Mesh
from legoloam_tpu_torch.utils import synthetic as tsyn

from _torch_parity import npy, port_cfg, tt
from test_torch_odometry_graph import NoReads

CLOUDS = ["sharp", "less_sharp", "flat", "less_flat", "outlier"]
N_SCANS = 8
# dryrun's tiny sensor and feature caps, as JAX configs, with the JAX side's
# K1 and K2 forced onto their Pallas kernels (interpret mode on the CPU).
J_TINY = JD.replace(
    sensor=jcfg.SensorConfig(name="tiny", n_scan=4, horizon_scan=128,
                             ang_res_x_deg=360.0 / 128, ang_res_y_deg=2.0,
                             ang_bottom_deg=3.0, ground_scan_ind=2),
    seg=dataclasses.replace(JD.seg, ccl_backend="pallas"),
    feat=dataclasses.replace(
        JD.feat, max_sharp=32, max_less_sharp=128, max_flat=64,
        max_less_flat=256, max_outlier=64, picks_backend="pallas"))


@functools.lru_cache(maxsize=None)
def _scans(sensor_name: str):
    """tests/test_sharding.py's 8 scans along a 15 m circle (DEFAULT), or
    dryrun's tiny-sensor scans stepped 0.2 m apart, as numpy (B, ...)."""
    scene = jsyn.default_scene()
    if sensor_name == "default":
        poses = jsyn.circle_trajectory(N_SCANS, radius=15.0,
                                       angular_rate=0.02)
        out = [jsyn.raycast_scan(scene, JPose(poses.R[k], poses.t[k]),
                                 JD.sensor) for k in range(N_SCANS)]
    else:
        out = [jsyn.raycast_scan(
            scene, JPose(jnp.eye(3), jnp.array([0.2 * k, 0.0, 0.8])),
            J_TINY.sensor) for k in range(N_SCANS)]
    return tuple(np.stack([np.asarray(s[j]) for s in out]) for j in range(3))


def _jcfg(sensor_name):
    return JD if sensor_name == "default" else J_TINY


@functools.lru_cache(maxsize=None)
def _port(sensor_name: str, less_flat_method: str = "run"):
    """The port's batched frontend on the CPU, its batched projection and
    segmentation, and each scan's own ``process_scan``."""
    cfg = port_cfg(_jcfg(sensor_name))
    cfg = cfg.replace(feat=dataclasses.replace(
        cfg.feat, less_flat_method=less_flat_method))
    batch = tuple(tt(a) for a in _scans(sensor_name))
    img = tproj.project_scan(batch[0], batch[1], cfg.sensor, ring=batch[2])
    seg = tseg.segment(img, cfg.sensor, cfg.seg)
    feats = tpipe.process_scans(*batch, cfg)
    single = [tpipe.process_scan(*(a[k] for a in batch), cfg)
              for k in range(N_SCANS)]
    return img, seg, feats, single


def _assert_cloud_equal(a, b, name):
    va = npy(a.valid)
    assert np.array_equal(va, np.asarray(b.valid)), name
    for f in ("xyz", "ring", "rel_time"):
        assert np.array_equal(npy(getattr(a, f))[va],
                              np.asarray(getattr(b, f))[va]), (name, f)


def _scan(tree, k):
    return type(tree)(*(_scan(v, k) if hasattr(v, "_fields") else v[k]
                        for v in tree))


@pytest.mark.parametrize("sensor_name", ["default", "tiny"])
def test_batched_frontend_matches_jax(sensor_name):
    """The port's ``process_scans`` against the JAX package's
    ``make_batched_frontend`` on an 8-device mesh, scan by scan; at the
    tiny sensor the JAX side runs K1 and K2 as Pallas kernels (interpret
    mode), the port their batched plain versions."""
    jc = _jcfg(sensor_name)
    pts, valid, ring = _scans(sensor_name)
    jf = jfrontend_dp.make_batched_frontend(jc, jmesh.make_mesh(8))(
        pts, valid, ring)
    j_img, j_seg = jax.jit(jax.vmap(lambda p, v, r: (lambda img: (
        img, jseg.segment(img, jc.sensor, jc.seg)))(
            jproj.project_scan(p, v, jc.sensor, ring=r))))(pts, valid, ring)
    img, seg, tf, _ = _port(sensor_name)
    assert np.array_equal(npy(img.valid), np.asarray(j_img.valid))
    np.testing.assert_allclose(npy(img.xyz), np.asarray(j_img.xyz),
                               atol=1e-5)
    assert np.array_equal(npy(seg.label), np.asarray(j_seg.label))
    assert np.array_equal(npy(seg.n_clusters), np.asarray(j_seg.n_clusters))
    for k in range(N_SCANS):
        t, j = _scan(tf, k), _scan(jf, k)
        for name in CLOUDS:
            if name != "flat":
                _assert_cloud_equal(getattr(t, name), getattr(j, name),
                                    (k, name))
        assert np.array_equal(npy(t.overflow), np.asarray(j.overflow))
        na, nb = int(t.flat.valid.sum()), int(j.flat.valid.sum())
        assert abs(na - nb) <= max(4, nb // 50), (k, na, nb)
    assert int(tf.sharp.valid.sum()) > 8 * N_SCANS
    assert int(tf.flat.valid.sum()) > 0


@pytest.mark.parametrize("sensor_name,less_flat_method", [
    ("default", "run"), ("tiny", "run"), ("tiny", "voxel")])
def test_batched_frontend_equals_single_scans(sensor_name, less_flat_method):
    """``process_scans`` on B scans is B calls of ``process_scan``, bit for
    bit, every field of every cloud; also with the less-flat cloud thinned
    by the voxel grid instead of the main path's first-of-run rule."""
    _, _, feats, single = _port(sensor_name, less_flat_method)
    assert feats.overflow.shape == (N_SCANS, 5)
    for k, s in enumerate(single):
        for a, b in zip(leaves(feats), leaves(s), strict=True):
            assert torch.equal(a[k], b)


def _ccl_masks(p, seed):
    rng = np.random.RandomState(seed)
    return tuple(tt(rng.rand(*s) > p) for s in ((16, 1800), (16, 1800),
                                                (15, 1800)))


@pytest.mark.parametrize("with_cap", [False, True])
def test_ccl_plain_batched_equals_single(with_cap):
    """``label_propagation_plain`` on a (B, N, H) batch against each scan
    alone: a real scan's masks (a few sweeps), seeded random masks (8
    sweeps) and, ``with_cap``, dense masks that percolate into snakes and
    stop at the ``ccl_max_iters`` cap.  The batch sweeps to its slowest
    scan; each scan's labels and ring extrema are exactly its own."""
    img, _, _, _ = _port("default")
    cfg = port_cfg(JD)
    one = tproj.RangeImage(*(a[0] for a in img))
    ground = tseg.ground_removal(one, cfg.sensor, cfg.seg)
    ch, cv = tseg._connectivity(one, cfg.sensor, cfg.seg)
    cases = [(one.valid & ~ground, ch, cv), _ccl_masks(0.4, 5)]
    if with_cap:
        cases.append(_ccl_masks(0.25, 5))
    cap = JD.seg.ccl_max_iters
    singles = [ccl_cuda.label_propagation_plain(*c, cap) for c in cases]
    sweeps = [s[3] for s in singles]
    assert len(set(sweeps)) == len(sweeps)          # different sweep counts
    assert (max(sweeps) == cap) == with_cap
    batch = [torch.stack(x) for x in zip(*cases)]
    *got, n_sweeps = ccl_cuda.label_propagation_plain(*batch, cap)
    assert n_sweeps == max(sweeps)
    for k, s in enumerate(singles):
        for a, b in zip(got, s[:3]):
            assert torch.equal(a[k], b)
    # The CPU wrapper takes the batch the same way.
    for a, b in zip(ccl_cuda.label_propagation(*batch, cap), got):
        assert torch.equal(a, b)


def test_picks_plain_batched_equals_single():
    """``pick_labels_plain`` on a (B, N, H) batch against each scan's (N, H)
    call, label for label: the main path's compacted channels of three
    scans and seeded stress rings (ties at curvature 0, column gaps,
    counts 0..H)."""
    img, seg, _, _ = _port("default")
    c, count = tfeat._compact_rings(img, seg)
    in_ring = torch.arange(img.rng.shape[-1]) < count[..., None]
    rng = torch.where(in_ring, c["rng"], torch.zeros_like(c["rng"]))
    cfg = port_cfg(JD.feat)
    scans = [(rng[k], c["col"][k], c["ground"][k], count[k])
             for k in range(3)]
    stress = zip(*(tsyn.pick_stress_rings(seed, 1800, cfg.sections)
                   for seed in (7, 8)))
    n = img.rng.shape[-2]
    scans.append(tuple(torch.cat(a)[:n] for a in stress))
    batch = [torch.stack(x) for x in zip(*scans)]
    got = features_cuda.pick_labels_plain(*batch, cfg)
    assert got.shape == batch[0].shape
    for k, s in enumerate(scans):
        assert torch.equal(got[k], features_cuda.pick_labels_plain(*s, cfg))
    assert int((got != 0).sum()) > 300
    assert torch.equal(features_cuda.pick_labels(*batch, cfg), got)


@pytest.fixture
def no_reads(monkeypatch):
    """A ``TorchDispatchMode`` that raises on a host read and on the ops a
    captured body may not run, outside K1's plain version (its fixpoint
    loop reads on the CPU only)."""
    m = NoReads()
    plain_fn = ccl_cuda.label_propagation_plain

    def plain(*a, **k):
        m.plain += 1
        try:
            return plain_fn(*a, **k)
        finally:
            m.plain -= 1

    monkeypatch.setattr(ccl_cuda, "label_propagation_plain", plain)
    return m


def test_frontend_graph_replays_through_static_runner(no_reads):
    """``FrontendGraph`` on the graph runner's dataflow: a first call with a
    batch shape runs and "captures", later calls replay (one replay a
    call), a new batch shape gets its own chain, and every call equals the
    eager body bit for bit.  The static calls run under ``no_reads``, so a
    host read in the batched body fails the test."""
    cfg = port_cfg(J_TINY)
    batch = tuple(tt(a) for a in _scans("tiny"))
    eager = step_graph.FrontendGraph(cfg, "cpu")
    assert not eager.captured
    g = step_graph.FrontendGraph(cfg, "cpu",
                                 runner=step_graph.StaticRunner())
    assert g.captured
    want = eager(*batch)
    half = tuple(a[:4] for a in batch)
    want_half = eager(*half)
    with no_reads:
        outs = [g(*batch), g(*batch), g(*half), g(*half), g(*batch)]
    assert g.rt.replays == 3 and g.reads == 0
    assert len(g.rt.chains) == 2
    for out, ref in zip(outs, (want, want, want_half, want_half, want)):
        for a, b in zip(leaves(out), leaves(ref), strict=True):
            assert torch.equal(a, b)
    # The returned features are the caller's: a later call leaves them.
    assert outs[0].sharp.xyz.data_ptr() != outs[1].sharp.xyz.data_ptr()


def test_make_batched_frontend_splits_over_ranks():
    """Each rank of a 2-rank mesh takes its half of the batch through the
    batched frontend: its features equal ``process_scans`` on that half,
    with the half's batch indices; a batch that does not divide by the
    world size is refused."""
    cfg = dryrun._tiny_cfg(2)
    assert cfg.sensor == port_cfg(J_TINY.sensor)
    batch = tuple(tt(a) for a in _scans("tiny"))
    want = tpipe.process_scans(*batch, cfg)
    for rank in range(2):
        mesh = Mesh(size=2, rank=rank, axis="data",
                    device=torch.device("cpu"))
        feats, idx = frontend_dp.make_batched_frontend(cfg, mesh)(*batch)
        assert idx.tolist() == list(range(4 * rank, 4 * rank + 4))
        for a, b in zip(leaves(feats), leaves(want), strict=True):
            assert torch.equal(a, b[4 * rank:4 * rank + 4])
    with pytest.raises(ValueError, match="must divide by the world size"):
        frontend_dp.make_batched_frontend(cfg, mesh)(
            *(a[:3] for a in batch))


def test_projection_key_past_the_bit_budget_of_a_batch():
    """A batch whose B*P exceeds the packed key's 2^18 point indices
    projects each scan as it projects alone: the key's index bits are the
    point's index within its scan, so the closest point wins each cell and
    exact range ties go to the lower index within the scan."""
    sensor = port_cfg(JD.sensor)
    rng = np.random.RandomState(3)
    b, p = 9, 1 << 15
    assert b * p > 1 << 18
    k = rng.randint(-1349, 451, (b, p))
    hd = np.radians(90.0 - 0.2 * k + rng.uniform(-0.04, 0.04, (b, p)))
    el = np.radians(rng.uniform(-15.0, 15.0, (b, p)))
    r = rng.uniform(0.5, 80.0, (b, p))
    pts = np.stack([r * np.cos(el) * np.sin(hd), r * np.cos(el) * np.cos(hd),
                    r * np.sin(el)], axis=-1).astype(np.float32)
    # Exact ties: each scan repeats its first 4096 points at its end, so
    # every such cell has two equal keys but for the index bits.
    pts[:, -4096:] = pts[:, :4096]
    ring = rng.randint(-1, 17, (b, p)).astype(np.int32)
    ring[:, -4096:] = ring[:, :4096]
    valid = rng.rand(b, p) > 0.1
    t = tuple(torch.from_numpy(a) for a in (pts, valid, ring))
    img = tproj.project_scan(*t[:2], sensor, ring=t[2])
    for s in range(b):
        one = tproj.project_scan(t[0][s], t[1][s], sensor, ring=t[2][s])
        for a, c in zip(img, one):
            assert torch.equal(a[s], c)
    assert int(img.valid.sum()) > b * 10000
