"""One odometry step from the same carried-across state and the same scan
features in both packages.  Tolerance: twist to 1e-4, pose to 1 mm /
0.01° (float32 sums of the normal equations in a different order)."""

import numpy as np
import pytest

from legoloam_tpu.models import odometry as jodom
from legoloam_tpu.models import pipeline as jpipe
from legoloam_tpu_torch.models import odometry as todom
from legoloam_tpu_torch.utils.interop import slam_state_from_numpy

from _torch_parity import (JCFG, TCFG, jax_run, npy, ring_scans,
                           rot_angle_deg, to_jax_tree, to_numpy_tree)


@pytest.mark.parametrize("k", [2, 3])
def test_odometry_step_matches_jax(k):
    states, _ = jax_run(4)
    scans, _ = ring_scans(4)
    prev = states[k - 1].odom
    feats = to_numpy_tree(jpipe.process_scan(*scans[k], JCFG))
    j_state, j_pose, j_diag = jodom.odometry_step(
        to_jax_tree(prev), to_jax_tree(feats), JCFG.odom)
    t_state, t_pose, t_diag = todom.odometry_step(
        slam_state_from_numpy(prev, "cpu"),
        slam_state_from_numpy(feats, "cpu"), TCFG.odom)

    np.testing.assert_allclose(npy(t_state.xi), np.asarray(j_state.xi),
                               atol=1e-4)
    assert np.abs(npy(t_pose.t) - np.asarray(j_pose.t)).max() < 1e-3
    assert rot_angle_deg(npy(t_pose.R), j_pose.R) < 0.01
    assert abs(int(t_diag.n_surf_corr) - int(j_diag.n_surf_corr)) <= 2
    assert abs(int(t_diag.n_corner_corr) - int(j_diag.n_corner_corr)) <= 2
    for name in ("last_corner", "last_surf", "last_outlier", "last_flat"):
        a, b = getattr(t_state, name), getattr(j_state, name)
        assert np.array_equal(npy(a.valid), np.asarray(b.valid)), name
        np.testing.assert_allclose(npy(a.xyz), np.asarray(b.xyz), atol=1e-3)
    # A real solve happened: the scan moved ~0.15 m.
    assert 0.05 < float(np.linalg.norm(npy(t_state.xi)[3:])) < 0.5
