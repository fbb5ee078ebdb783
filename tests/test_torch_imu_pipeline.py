"""The IMU path: de-skewed features, the gyro-seeded odometry and the
mapping attitude blend, in the port against the JAX package on the same
scans and the same integrated IMU state (carried across), with
tests/test_imu_pipeline.py's contracts on the port.

Tolerances: de-skewed feature coordinates 1e-4 m (float32 rotations of the
de-skew, see tests/test_torch_deskew.py), feature validity exact in every
cloud but ``flat`` (its curvature-0 ties, tests/test_torch_frontend.py);
the IMU seed 1e-5; fused positions over 6 scans 1e-3 m, the tolerance of
tests/test_torch_pipeline.py.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np

from legoloam_tpu.config import DEFAULT
from legoloam_tpu.models import pipeline as jpipe
from legoloam_tpu.ops import deskew as jdsk
from legoloam_tpu.ops import se3 as jse3
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch.models import pipeline as tpipe
from legoloam_tpu_torch.ops import deskew as tdsk
from legoloam_tpu_torch.utils import metrics
from legoloam_tpu_torch.utils.interop import slam_state_from_numpy

from _torch_parity import npy, port_cfg, to_numpy_tree, tt

CFG = DEFAULT.replace(mapping=dataclasses.replace(
    DEFAULT.mapping, max_keyframes=64, submap_corner_cap=4096,
    submap_surf_cap=8192, scan_corner_cap=1024, scan_surf_cap=4096,
    submap_merge_batch=1))
TCFG = port_cfg(CFG)
CLOUDS = ["sharp", "less_sharp", "less_flat", "outlier"]
N = 12


@functools.lru_cache(maxsize=None)
def imu_world():
    """12 motion-distorted default_scene scans on an 18 m circle, the JAX
    package's integral of its synthetic IMU, and the true positions."""
    scene = jsyn.default_scene()
    poses = jsyn.circle_trajectory(N, radius=18.0, angular_rate=0.009)
    ts, rpy, acc, gyro = jsyn.make_imu(poses, scan_period=0.1)
    integ = jdsk.integrate_imu(jdsk.ImuWindow(
        time=ts, rpy=rpy, acc=acc, gyro=gyro,
        valid=jnp.ones(ts.shape[0], bool)))
    scans = []
    for k in range(N):
        nxt = min(k + 1, N - 1)
        scans.append(tuple(np.asarray(a) for a in jsyn.raycast_scan(
            scene, Pose(poses.R[k], poses.t[k]), CFG.sensor,
            next_pose=Pose(poses.R[nxt], poses.t[nxt]), motion=k + 1 < N)))
    return scans, to_numpy_tree(integ), np.asarray(poses.t)


def _t_scan(scan):
    return tuple(tt(a) for a in scan)


def test_process_scan_with_imu_matches_jax():
    scans, integ, _ = imu_world()
    jf, jd = jpipe.process_scan_with_imu(
        *map(jnp.asarray, scans[5]), CFG,
        jdsk.ImuIntegral(*map(jnp.asarray, integ)), 0.5)
    tf, td = tpipe.process_scan_with_imu(
        *_t_scan(scans[5]), TCFG, slam_state_from_numpy(integ, "cpu"), 0.5)
    for name in CLOUDS:
        a, b = getattr(tf, name), getattr(jf, name)
        v = npy(a.valid)
        assert np.array_equal(v, np.asarray(b.valid)), name
        np.testing.assert_allclose(npy(a.xyz)[v], np.asarray(b.xyz)[v],
                                   atol=1e-4, err_msg=name)
        assert np.array_equal(npy(a.ring)[v], np.asarray(b.ring)[v]), name
    np.testing.assert_allclose(npy(td.xyz), np.asarray(jd.xyz), atol=1e-4)
    # process_scan with an integral de-skews the same way.
    pf = tpipe.process_scan(*_t_scan(scans[5]), TCFG,
                            slam_state_from_numpy(integ, "cpu"), 0.5)
    for name in CLOUDS + ["flat"]:
        assert np.array_equal(npy(getattr(pf, name).xyz),
                              npy(getattr(tf, name).xyz)), name


def test_imu_xi_seed_matches_jax_and_motion():
    """The gyro's rotation seed approximates the true scan twist."""
    n = 6
    poses = jsyn.circle_trajectory(n, radius=15.0, angular_rate=0.012)
    ts, rpy, acc, gyro = jsyn.make_imu(poses, scan_period=0.1)
    integ = to_numpy_tree(jdsk.integrate_imu(jdsk.ImuWindow(
        time=ts, rpy=rpy, acc=acc, gyro=gyro,
        valid=jnp.ones(ts.shape[0], bool))))
    zeros = np.zeros((16, 1800, 3), np.float32)
    jd = jdsk.deskew_image(jnp.asarray(zeros), jnp.zeros((16, 1800)),
                           jnp.zeros((16, 1800), bool), jnp.float32(0.2),
                           jdsk.ImuIntegral(*map(jnp.asarray, integ)))
    td = tdsk.deskew_image(tt(zeros), tt(np.zeros((16, 1800), np.float32)),
                           tt(np.zeros((16, 1800), bool)), 0.2,
                           slam_state_from_numpy(integ, "cpu"))
    seed = tpipe.imu_xi_seed(td, 0.1)
    np.testing.assert_allclose(npy(seed), np.asarray(jpipe.imu_xi_seed(
        jd, 0.1)), atol=1e-5)
    gt = jse3.se3_log(jse3.relative(Pose(poses.R[2], poses.t[2]),
                                    Pose(poses.R[3], poses.t[3])))
    np.testing.assert_allclose(npy(seed[:3]), np.asarray(gt[:3]), atol=0.02)


def test_slam_with_imu_matches_jax_and_is_accurate():
    """``slam_scan_step`` with the integral: the first 6 fused positions
    agree with the JAX package's, and the port's 12-scan run stays under
    0.2 m ATE (tests/test_imu_pipeline.py's bound)."""
    scans, integ, gt = imu_world()
    j_int = jdsk.ImuIntegral(*map(jnp.asarray, integ))
    t_int = slam_state_from_numpy(integ, "cpu")
    jst = jpipe.init_slam_state(CFG)
    tst = tpipe.init_slam_state(TCFG, device="cpu")
    j_fused, t_fused = [], []
    for k, s in enumerate(scans):
        mapping = k % CFG.mapping_every == 0
        if k < 6:
            jst, jout = jpipe.slam_scan_step(
                jst, *map(jnp.asarray, s), CFG, k * 0.1, run_mapping=mapping,
                imu_integral=j_int, bootstrap=(k == 1))
            j_fused.append(np.asarray(jout.fused_pose.t))
        tst, tout = tpipe.slam_scan_step(
            tst, *_t_scan(s), TCFG, k * 0.1, run_mapping=mapping,
            imu_integral=t_int, bootstrap=(k == 1))
        t_fused.append(npy(tout.fused_pose.t))
    t_fused = np.stack(t_fused)
    assert np.isfinite(t_fused).all()
    assert np.abs(t_fused[:6] - np.stack(j_fused)).max() < 1e-3
    ate = float(metrics.ate_rmse(tt(t_fused[:-1]), tt(gt[1:])))
    assert ate < 0.2, ate
