"""The whole slice: ``run_slam_sequence`` over 6 synthetic scans in both
packages at CPU-sized caps.  Tolerance: fused trajectories to 1e-3 m (float
summation order differs across many LM iterations), equal keyframe counts,
and the port's own fused ATE against ground truth below 0.1 m."""

import dataclasses

import numpy as np
import pytest
import torch

from legoloam_tpu_torch.models import pipeline as tpipe
from legoloam_tpu_torch.utils import metrics

from _torch_parity import TCFG, jax_run, npy, ring_scans

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
    cfg, st = _state()
    scans, _ = ring_scans(N)
    scan = tuple(torch.from_numpy(np.array(a)) for a in scans[0])
    with pytest.raises(NotImplementedError, match="IMU"):
        tpipe.slam_scan_step(st, *scan, cfg, 0.0, run_mapping=True,
                             imu_integral=object())
    loop_cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, enabled=True))
    with pytest.raises(NotImplementedError, match="loop closure"):
        tpipe.slam_scan_step(st, *scan, loop_cfg, 0.0, run_mapping=True,
                             run_loop=True)


def test_maybe_decimate_never_silent():
    cfg, st = _state(max_keyframes=32)
    assert tpipe.maybe_decimate(st, cfg)[1] is False
    kf = st.mapping.kf._replace(count=torch.tensor(16, dtype=torch.int32))
    st = st._replace(mapping=st.mapping._replace(kf=kf))
    with pytest.raises(NotImplementedError, match="decimation"):
        tpipe.maybe_decimate(st, cfg)


def test_loop_scheduler_cadence():
    cfg = TCFG.replace(loop=dataclasses.replace(TCFG.loop, enabled=True,
                                                cadence=1.0))
    s = tpipe.LoopScheduler(cfg)
    due = [s.due(0.1 * k) for k in range(25)]
    assert due.count(True) == 2 and not due[0]
