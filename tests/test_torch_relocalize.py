"""Kidnapped-robot relocalization: the port against the JAX package on one
keyframe map (a 15-scan JAX session carried across with utils/interop.py)
and the same kidnapped scan, with tests/test_relocalize.py's contracts on
the port.

Tolerances: acceptance and the candidate count are exact; the relocalized
pose agrees to 1e-2 m and 0.1° and the fitness to 5% relative (each of the
36 hypotheses' ICP runs through float32 sums taken in another order, which
move nearest-neighbour near-ties, tests/test_torch_loopclosure.py).  The
winning keyframe is not compared: here two neighbouring keyframes' windows
refine to the same pose with fitness equal to 1e-4 relative, and which of
them wins is float32 noise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from legoloam_tpu.config import DEFAULT
from legoloam_tpu.models import pipeline as jpipe
from legoloam_tpu.models import relocalize as jreloc
from legoloam_tpu.ops import se3 as jse3
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch.models import pipeline as tpipe
from legoloam_tpu_torch.models import relocalize as treloc
from legoloam_tpu_torch.utils.interop import slam_state_from_numpy

from _torch_parity import (npy, port_cfg, rot_angle_deg, to_jax_tree,
                           to_numpy_tree)

SMALL_MAP = dataclasses.replace(
    DEFAULT.mapping, max_keyframes=128, submap_corner_cap=8192,
    submap_surf_cap=16384, scan_corner_cap=1024, scan_surf_cap=4096)
SMALL_RELOC = dataclasses.replace(
    DEFAULT.reloc, n_candidates=8, yaw_hypotheses=4, window=6,
    cur_cap=2048, hist_cap=8192, coarse_iters=8, icp_max_iters=40)
CFG = DEFAULT.replace(mapping=SMALL_MAP, reloc=SMALL_RELOC)
TCFG = port_cfg(CFG)
N = 15


@functools.lru_cache(maxsize=None)
def mapped_session():
    """Session 1 in the JAX package: 15 scans around the courtyard; the
    final state as numpy, and the poses."""
    scene = jsyn.default_scene()
    poses = jsyn.circle_trajectory(N, radius=20.0, angular_rate=0.035)
    state = jpipe.init_slam_state(CFG)
    for k in range(N):
        nxt = min(k + 1, N - 1)
        scan = jsyn.raycast_scan(
            scene, Pose(poses.R[k], poses.t[k]), CFG.sensor,
            next_pose=Pose(poses.R[nxt], poses.t[nxt]), motion=k + 1 < N)
        state, _ = jpipe.slam_scan_step(
            state, *scan, CFG, k * 0.1,
            run_mapping=(k % CFG.mapping_every == 0), bootstrap=(k == 1))
    assert int(state.mapping.kf.count) >= 3
    return to_numpy_tree(state), poses


def _session2_jax(scan):
    """Session 2, scan 0, in the JAX package: fresh odometry on the
    restored map (the belief still at session 1's end), then
    relocalization."""
    s1, _ = mapped_session()
    jst = jpipe.init_slam_state(CFG)._replace(
        mapping=to_jax_tree(s1.mapping), loops=to_jax_tree(s1.loops))
    jst, _ = jpipe.slam_scan_step(jst, *scan, CFG, 100.0, run_mapping=False)
    return jax.tree.map(np.asarray,
                        jreloc.relocalize_slam_state(jst, CFG))


def _session2_port(scan):
    """The same in the port, from the map carried across; also returns
    (t_bef, t_aft) before relocalization."""
    s1, _ = mapped_session()
    tst = tpipe.init_slam_state(TCFG, device="cpu")._replace(
        mapping=slam_state_from_numpy(s1.mapping, "cpu"),
        loops=slam_state_from_numpy(s1.loops, "cpu"))
    tst, _ = tpipe.slam_scan_step(tst, *(np.asarray(a) for a in scan), TCFG,
                                  100.0, run_mapping=False)
    before = [npy(a) for p in (tst.mapping.t_bef, tst.mapping.t_aft)
              for a in p]
    tst, tdiag = treloc.relocalize_slam_state(tst, TCFG)
    return tst, tdiag, before


def test_relocalize_recovers_kidnapped_pose():
    """A scan from mid-course, with the belief at the session's end many
    metres and a heading turn away, relocalizes to its true pose, as in the
    JAX package."""
    _, poses = mapped_session()
    gt_world = Pose(poses.R[4], poses.t[4])
    scan = jsyn.raycast_scan(jsyn.default_scene(), gt_world, CFG.sensor)
    gt = jse3.relative(Pose(poses.R[0], poses.t[0]), gt_world)
    jst, jdiag = _session2_jax(scan)
    tst, tdiag, before = _session2_port(scan)
    assert np.linalg.norm(before[3] - np.asarray(gt.t)) > 3.0
    assert bool(tdiag.accepted) and bool(jdiag.accepted)
    assert int(tdiag.candidate) >= 0
    assert int(tdiag.n_candidates) == int(jdiag.n_candidates)
    assert abs(float(tdiag.fitness) / float(jdiag.fitness) - 1) < 0.05
    t_aft = tst.mapping.t_aft
    np.testing.assert_allclose(npy(t_aft.t), jst.mapping.t_aft.t, atol=1e-2)
    assert rot_angle_deg(npy(t_aft.R), jst.mapping.t_aft.R) < 0.1
    assert float(np.linalg.norm(npy(t_aft.t) - np.asarray(gt.t))) < 0.5
    assert rot_angle_deg(npy(t_aft.R), np.asarray(gt.R)) < 5.0
    # The rebase anchors t_bef at the odometry pose: the fused output is
    # the relocalized pose at once.
    fused = tpipe.fusion_mod.fuse(tst.odom.pose, tst.mapping.t_bef, t_aft)
    np.testing.assert_allclose(npy(fused.t), npy(t_aft.t), atol=1e-5)
    assert bool(tst.mapping.cache.stale) and bool(tst.mapping.initialized)


def test_relocalize_rejects_unmapped_place():
    """A scan of another world is rejected and leaves the state's
    correction as it was (the JAX package's rejection is
    tests/test_relocalize.py's)."""
    scan = jsyn.raycast_scan(jsyn.loop_scene(),
                             Pose(jnp.eye(3), jnp.array([0.0, 0.0, 0.8])),
                             CFG.sensor)
    tst, tdiag, before = _session2_port(scan)
    assert not bool(tdiag.accepted)
    after = [npy(a) for p in (tst.mapping.t_bef, tst.mapping.t_aft)
             for a in p]
    for b, a in zip(before, after):
        np.testing.assert_array_equal(b, a)
