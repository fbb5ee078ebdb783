"""The sensor-geometry matrix on the port: tests/test_sensor_matrix.py's
contract (every ``config.SENSORS`` geometry through the full SLAM step),
and the frontend at the two 1024-column geometries against the JAX package.

End to end (the JAX test's bounds, at its CPU-sized map caps and with its
DEFAULT feature caps): every fused position finite and within 1.0 m of
ground truth, at least one keyframe.  VLP-16 stays in the default tier;
HDL-32E, OS1-16, OS1-64 and VLS-128 are ``slow``, as in the JAX file.  The
full-width runs (``for_sensor`` capacities, 30 scans each) are chip_smoke's
``[sensors]`` phase.

Frontend at OS1-16 and OS1-64 (16 and 64 x 1024 under ``for_sensor``): one
motion-distorted ray-cast scan through both packages' ``process_scan``.
Projection cells (valid, winning points) and the segmentation exact; the
feature clouds as tests/test_torch_frontend.py holds them: at the default
pick counts every cloud but ``flat`` exact (flat-ground ties at curvature
~0 reorder under XLA's FMA contraction, and where a section runs dry that
changes the count too: 163 against 168 flat picks at OS1-16); at the
reference counts the flat picks in the same per-ring slots; with ranges
quantised to 1/256 m all five clouds exact.  The overflow counters equal
and zero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu import config as jcfg
from legoloam_tpu.models import pipeline as jpipe
from legoloam_tpu.ops import features as jfeat
from legoloam_tpu.ops import projection as jproj
from legoloam_tpu.ops import segmentation as jseg
from legoloam_tpu.ops.se3 import Pose as JPose
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch.config import DEFAULT, SENSORS
from legoloam_tpu_torch.models import pipeline
from legoloam_tpu_torch.ops import features as tfeat
from legoloam_tpu_torch.ops import projection as tproj
from legoloam_tpu_torch.ops import segmentation as tseg
from legoloam_tpu_torch.ops.se3 import Pose
from legoloam_tpu_torch.utils import synthetic

from _torch_parity import npy, port_cfg, tt

SMALL_MAP = dataclasses.replace(
    DEFAULT.mapping, max_keyframes=32, submap_corner_cap=4096,
    submap_surf_cap=8192, scan_corner_cap=1024, scan_surf_cap=4096)
CLOUDS = ["sharp", "less_sharp", "flat", "less_flat", "outlier"]


def _run_sensor(name, n=4):
    cfg = DEFAULT.replace(sensor=SENSORS[name], mapping=SMALL_MAP)
    scene = synthetic.default_scene()
    poses = synthetic.circle_trajectory(n + 1, radius=18.0,
                                        angular_rate=0.009)
    state = pipeline.init_slam_state(cfg, "cpu")
    errs = []
    for k in range(n):
        scan = synthetic.raycast_scan(
            scene, Pose(poses.R[k], poses.t[k]), cfg.sensor,
            next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True)
        state, out = pipeline.slam_scan_step(
            state, *scan, cfg, k * cfg.sensor.scan_period,
            run_mapping=(k % cfg.mapping_every == 0))
        est = npy(out.fused_pose.t)
        assert np.all(np.isfinite(est)), f"{name}: non-finite pose at k={k}"
        errs.append(np.linalg.norm(est - npy(poses.t[k] - poses.t[0])))
    assert int(state.mapping.kf.count) >= 1, name
    assert max(errs) < 1.0, (name, errs)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["hdl32e", "os1_16", "os1_64"])
def test_sensor_end_to_end(name):
    _run_sensor(name)


@pytest.mark.slow
def test_sensor_end_to_end_vls128():
    _run_sensor("vls128", n=3)


def test_sensor_vlp16_fast():
    """The default geometry stays in the default tier."""
    _run_sensor("vlp16", n=4)


def _assert_cloud_equal(a, b, name):
    va = npy(a.valid)
    assert np.array_equal(va, np.asarray(b.valid)), name
    for f in ("xyz", "ring", "rel_time"):
        assert np.array_equal(npy(getattr(a, f))[va],
                              np.asarray(getattr(b, f))[va]), (name, f)


@pytest.mark.parametrize("name", ["os1_16", "os1_64"])
def test_frontend_matches_jax_at_1024_columns(name):
    jc = jcfg.for_sensor(name)
    tc = port_cfg(jc)
    sensor = jc.sensor
    assert sensor.horizon_scan == 1024
    poses = jsyn.circle_trajectory(2, radius=18.0, angular_rate=0.009)
    pts, valid, ring = (np.asarray(a) for a in jsyn.raycast_scan(
        jsyn.default_scene(), JPose(poses.R[0], poses.t[0]), sensor,
        next_pose=JPose(poses.R[1], poses.t[1]), motion=True))
    tin = tuple(torch.from_numpy(np.array(a)) for a in (pts, valid, ring))

    j_img, j_seg = jax.jit(lambda p, v, r: (lambda img: (img, jseg.segment(
        img, sensor, jc.seg)))(jproj.project_scan(p, v, sensor, ring=r)))(
            pts, valid, ring)
    t_img = tproj.project_scan(*tin[:2], tc.sensor, ring=tin[2])
    v = np.asarray(j_img.valid)
    assert v.sum() > 5000 and np.array_equal(npy(t_img.valid), v)
    assert np.array_equal(npy(t_img.xyz), np.asarray(j_img.xyz))
    t_seg = tseg.segment(t_img, tc.sensor, tc.seg)
    for f in jseg.Segmentation._fields:
        assert np.array_equal(npy(getattr(t_seg, f)),
                              np.asarray(getattr(j_seg, f))), f
    assert int(t_seg.n_clusters) > 5

    # The default pick counts through process_scan: every cloud but flat.
    t = pipeline.process_scan(*tin, tc)
    j = jax.jit(lambda p, v, r: jpipe.process_scan(p, v, r, jc))(
        pts, valid, ring)
    for cloud in CLOUDS:
        if cloud != "flat":
            _assert_cloud_equal(getattr(t, cloud), getattr(j, cloud), cloud)
    assert np.array_equal(npy(t.overflow), np.asarray(j.overflow))
    assert not npy(t.overflow).any()
    assert int(t.sharp.valid.sum()) > 0 and int(t.flat.valid.sum()) > 0

    def features(img, seg, feat):
        tf = tfeat.extract_features(tproj.RangeImage(*(tt(a) for a in img)),
                                    tseg.Segmentation(*(tt(a) for a in seg)),
                                    tc.sensor, port_cfg(feat))
        jf = jax.jit(lambda i, s: jfeat.extract_features(i, s, sensor, feat))(
            img, seg)
        return tf, jf

    # At the reference counts no section runs dry: the same flat picks per
    # ring, in the same slots.
    ref_feat = dataclasses.replace(jc.feat, edge_per_section=2,
                                   surf_per_section=4)
    tf, jf = features(j_img, j_seg, ref_feat)
    assert np.array_equal(npy(tf.flat.valid), np.asarray(jf.flat.valid))
    assert np.array_equal(npy(tf.flat.ring), np.asarray(jf.flat.ring))
    # Ranges on a 1/256 m grid make every curvature sum exact: all five
    # clouds equal at the default counts.
    q = jnp.where(j_img.valid, jnp.round(j_img.rng * 256.0) / 256.0,
                  j_img.rng)
    tf, jf = features(j_img._replace(rng=q), j_seg, jc.feat)
    for cloud in CLOUDS:
        _assert_cloud_equal(getattr(tf, cloud), getattr(jf, cloud), cloud)
    assert int(tf.flat.valid.sum()) > 50
