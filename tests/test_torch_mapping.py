"""One mapping step from the same carried-across MapState and the same
odometry clouds in both packages, at CPU-sized caps.

Tolerance: the submap cache holds the same voxels (validity and counts
exact, centroids to 1e-5 m), the stored keyframe clouds agree to 1e-5 m,
and the mapped pose agrees to 1 mm / 0.01°.
"""

import numpy as np
import pytest

from legoloam_tpu.models import mapping as jmap
from legoloam_tpu.models import odometry as jodom
from legoloam_tpu.models import pipeline as jpipe
from legoloam_tpu_torch.models import mapping as tmap
from legoloam_tpu_torch.utils.interop import slam_state_from_numpy

from _torch_parity import (JCFG, TCFG, jax_run, npy, ring_scans,
                           rot_angle_deg, to_jax_tree, to_numpy_tree)


def _inputs():
    """MapState after scans 0-2 and scan 3's odometry output (JAX)."""
    states, _ = jax_run(4)
    scans, _ = ring_scans(4)
    feats = jpipe.process_scan(*scans[3], JCFG)
    odom, pose, _ = jodom.odometry_step(to_jax_tree(states[2].odom), feats,
                                        JCFG.odom)
    return states[2].mapping, to_numpy_tree(odom), to_numpy_tree(pose)


@pytest.mark.parametrize("cache_path", ["fold", "rebuild"])
def test_mapping_step_matches_jax(cache_path):
    mstate, odom, pose = _inputs()
    if cache_path == "rebuild":
        mstate = mstate._replace(cache=mstate.cache._replace(
            stale=np.array(True)))
    clouds = (odom.last_corner, odom.last_surf, odom.last_outlier)
    t_time = 3 * JCFG.sensor.scan_period
    j_state, j_T, j_diag = jmap.mapping_step(
        to_jax_tree(mstate), *(to_jax_tree(c) for c in clouds),
        to_jax_tree(pose), np.float32(t_time), JCFG.mapping,
        ground_cloud=to_jax_tree(odom.last_flat))
    j_state = to_numpy_tree(j_state)
    t_state, t_T, t_diag = tmap.mapping_step(
        slam_state_from_numpy(mstate, "cpu"),
        *(slam_state_from_numpy(c, "cpu") for c in clouds),
        slam_state_from_numpy(pose, "cpu"), t_time, TCFG.mapping,
        ground_cloud=slam_state_from_numpy(odom.last_flat, "cpu"))

    jc, tc = j_state.cache, t_state.cache
    assert int(np.sum(jc.s_valid)) > 1000
    for pre in ("c", "s"):
        v = getattr(jc, f"{pre}_valid")
        assert np.array_equal(npy(getattr(tc, f"{pre}_valid")), v), pre
        assert np.array_equal(npy(getattr(tc, f"{pre}_cnt")),
                              getattr(jc, f"{pre}_cnt")), pre
        np.testing.assert_allclose(npy(getattr(tc, f"{pre}_pts"))[v],
                                   getattr(jc, f"{pre}_pts")[v], atol=1e-5)
    assert int(tc.merged) == int(jc.merged)
    np.testing.assert_allclose(npy(tc.origin), jc.origin, atol=1e-6)
    assert int(t_diag.iters) == int(j_diag.iters) and int(t_diag.iters) > 0

    assert np.abs(npy(t_T.t) - np.asarray(j_T.t)).max() < 1e-3
    assert rot_angle_deg(npy(t_T.R), j_T.R) < 0.01
    jk, tk = j_state.kf, t_state.kf
    n = int(jk.count)
    assert int(tk.count) == n == int(mstate.kf.count) + 1
    for f in ("corner_valid", "surf_valid"):
        assert np.array_equal(npy(getattr(tk, f))[:n], getattr(jk, f)[:n])
    for f in ("corner", "surf"):
        np.testing.assert_allclose(npy(getattr(tk, f))[:n],
                                   getattr(jk, f)[:n], atol=1e-5)
    np.testing.assert_allclose(npy(tk.t)[:n], jk.t[:n], atol=1e-3)
