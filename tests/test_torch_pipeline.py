"""The whole slice: ``run_slam_sequence`` over 6 synthetic scans in both
packages at CPU-sized caps, the block drivers, and the paths that later
slices ported.  Tolerance: fused trajectories to 1e-3 m (float summation
order differs across many LM iterations), equal keyframe counts, and the
port's own fused ATE against ground truth below 0.1 m.  The block drivers
are loops over the streaming step, so they equal it exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu.models import pipeline as jpipe
from legoloam_tpu_torch.models import odometry as odom
from legoloam_tpu_torch.models import pipeline as tpipe
from legoloam_tpu_torch.ops import deskew
from legoloam_tpu_torch.utils import metrics, synthetic

from _torch_parity import JCFG, TCFG, jax_run, npy, ring_scans

N = 6


def test_run_slam_sequence_matches_jax():
    states, j_fused = jax_run(N)
    scans, gt = ring_scans(N)
    t_scans = [tuple(torch.from_numpy(np.array(a)) for a in s) for s in scans]
    fused, state = tpipe.run_slam_sequence(t_scans, TCFG, device="cpu")
    assert fused.t.shape == (N, 3) and fused.R.shape == (N, 3, 3)
    assert torch.isfinite(fused.t).all() and torch.isfinite(fused.R).all()
    assert np.abs(npy(fused.t) - j_fused).max() < 1e-3
    assert int(state.mapping.kf.count) == int(states[-1].mapping.kf.count)
    gt_t = torch.from_numpy(gt[:N] - gt[0]).float()
    assert float(metrics.ate_rmse(fused.t, gt_t)) < 0.1


def _state(max_keyframes=32):
    cfg = TCFG.replace(mapping=dataclasses.replace(
        TCFG.mapping, max_keyframes=max_keyframes))
    return cfg, tpipe.init_slam_state(cfg, device="cpu")


def test_later_slices_raise():
    """The IMU path, loop closure and keyframe decimation, which raised
    ``NotImplementedError`` until they were ported, now run: one step with
    an IMU integral, one with a loop-closure attempt due, and the
    saturation guard on a store within its margin."""
    cfg, st = _state()
    scans, _ = ring_scans(N)
    scan = tuple(torch.from_numpy(np.array(a)) for a in scans[0])
    st, out = tpipe.slam_scan_step(st, *scan, cfg, 0.0, run_mapping=True,
                                   imu_integral=_integral(2))
    assert torch.isfinite(out.fused_pose.t).all()
    loop_cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, enabled=True))
    st, out = tpipe.slam_scan_step(st, *scan, loop_cfg, 0.1,
                                   run_mapping=True, run_loop=True)
    assert int(st.loops.count) == 0 and torch.isfinite(out.fused_pose.t).all()
    kf = st.mapping.kf._replace(count=torch.tensor(16, dtype=torch.int32))
    st = st._replace(mapping=st.mapping._replace(kf=kf))
    assert tpipe.maybe_decimate(st, cfg)[1] is True


def test_maybe_decimate_never_silent():
    """Below its margin the guard does nothing; within it the store is
    halved (``decimate_keyframes``) and the submap cache marked stale."""
    cfg, st = _state(max_keyframes=32)
    cfg = cfg.replace(mapping=dataclasses.replace(cfg.mapping,
                                                  decimate_keep_recent=4))
    assert tpipe.maybe_decimate(st, cfg)[1] is False
    kf = st.mapping.kf._replace(count=torch.tensor(16, dtype=torch.int32))
    st = st._replace(mapping=st.mapping._replace(kf=kf))
    st2, fired = tpipe.maybe_decimate(st, cfg)
    assert fired is True
    assert int(st2.mapping.kf.count) == 10     # 12..15 and even of 0..11
    assert bool(st2.mapping.cache.stale)


def _integral(n):
    """The port's integral of synthetic IMU samples along the ring
    trajectory of ``ring_scans``."""
    poses = synthetic.circle_trajectory(n + 1, radius=20.0,
                                        angular_rate=0.0075)
    ts, rpy, acc, gyro = synthetic.make_imu(poses)
    return deskew.integrate_imu(deskew.ImuWindow(
        ts, rpy, acc, gyro, torch.ones(ts.shape[0], dtype=torch.bool)))


def _blocks(B=3):
    scans, _ = ring_scans(N)
    return [tuple(torch.from_numpy(np.stack([scans[b + i][j]
                                             for i in range(B)]))
                  for j in range(3)) for b in range(0, N, B)]


@pytest.mark.parametrize("imu_loop", [False, True])
def test_slam_scan_block_matches_streaming(imu_loop):
    """Two blocks of ``mapping_every`` scans, the first with the scan-1
    bootstrap: the same trajectory and state as the streaming driver with
    mapping (and the loop attempt) on each block's first scan, exactly;
    without IMU also the JAX package's streaming trajectory to 1e-3 m."""
    cfg = TCFG
    if imu_loop:
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, enabled=True))
    B = cfg.mapping_every
    integ = _integral(N) if imu_loop else None
    scans, _ = ring_scans(N)
    st = tpipe.init_slam_state(cfg, device="cpu")
    stream = []
    for k, s in enumerate(scans):
        st, out = tpipe.slam_scan_step(
            st, *(torch.from_numpy(np.array(a)) for a in s), cfg,
            k * cfg.sensor.scan_period, run_mapping=(k % B == 0),
            run_loop=imu_loop and k % B == 0, imu_integral=integ,
            bootstrap=(k == 1))
        stream.append(out.fused_pose.t)
    bst = tpipe.init_slam_state(cfg, device="cpu")
    block = []
    for b, blk in enumerate(_blocks(B)):
        times = torch.arange(b * B, (b + 1) * B) * cfg.sensor.scan_period
        stacked = None if integ is None else type(integ)(
            *(a.expand(B, *a.shape) for a in integ))
        bst, outs = tpipe.slam_scan_block(
            bst, *blk, cfg, times, run_loop=imu_loop,
            imu_integrals=stacked, bootstrap=(b == 0))
        assert outs.fused_pose.t.shape == (B, 3)
        block.append(outs.fused_pose.t)
    block = torch.cat(block)
    assert torch.equal(block, torch.stack(stream))
    assert torch.equal(bst.odom.xi, st.odom.xi)
    assert int(bst.mapping.kf.count) == int(st.mapping.kf.count)
    if not imu_loop:
        _, j_fused = jax_run(N)
        assert np.abs(npy(block) - j_fused).max() < 1e-3


def test_slam_scan_block_bootstrap_needs_two_scans():
    blk = tuple(a[:1] for a in _blocks()[0])
    with pytest.raises(ValueError, match=">= 2 scans"):
        tpipe.slam_scan_block(tpipe.init_slam_state(TCFG, device="cpu"),
                              *blk, TCFG, torch.zeros(1), bootstrap=True)


def test_odometry_block_and_sequence():
    """``odometry_scan_block`` equals ``odometry_scan_step`` scan by scan,
    and ``run_odometry_sequence`` the JAX package's to 1e-3 m."""
    scans, _ = ring_scans(N)
    blk = _blocks(N)[0]
    st = odom.init_state(TCFG.odom, TCFG.feat, "cpu")
    st_b, outs = tpipe.odometry_scan_block(st, *blk, TCFG)
    for k in range(N):
        st, out = tpipe.odometry_scan_step(st, *(a[k] for a in blk), TCFG)
        assert torch.equal(outs.pose.t[k], out.pose.t)
    assert torch.equal(st_b.xi, st.xi)
    poses, diags = tpipe.run_odometry_sequence(scans, TCFG, device="cpu")
    assert len(diags) == N and torch.equal(poses.t, outs.pose.t)
    j_poses, _ = jpipe.run_odometry_sequence(
        [tuple(jnp.asarray(a) for a in s) for s in scans], JCFG)
    assert np.abs(npy(poses.t) - np.asarray(j_poses.t)).max() < 1e-3


def test_loop_scheduler_cadence():
    cfg = TCFG.replace(loop=dataclasses.replace(TCFG.loop, enabled=True,
                                                cadence=1.0))
    s = tpipe.LoopScheduler(cfg)
    due = [s.due(0.1 * k) for k in range(25)]
    assert due.count(True) == 2 and not due[0]
