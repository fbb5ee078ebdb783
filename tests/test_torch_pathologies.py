"""Real-sensor pathologies and degenerate scans on the port: the contracts
of tests/test_real_pathologies.py and tests/test_degenerate_stream.py,
with the port's pipeline on the CPU, and the combined case against the JAX
pipeline on the same scans.

Cut to CPU size: 5 scans a case (the JAX test runs 30) at the CPU-sized map
caps of tests/_torch_parity.py (the JAX test runs DEFAULT); chip_smoke's
``[pathologies]`` phase runs the 30 DEFAULT scans.  Bounds are the JAX
test's: every fused position finite, and its error under max(factor x the
clean run's largest error, floor), with the factors 4 (wedges, dead rings,
dropout), 6 (spin warp, moving object), 8 (everything at once) and the
floor 0.15 m (0.3 m for everything at once).  The degenerate stream (a
blackout and a 20-point scan mid-stream): every float leaf of the state and
every fused pose finite, and the last position 0.1-20 m from the origin.
Parity: the combined case's scans through both packages, fused positions
within 1e-3 m over the first 4 scans (float summation order, as
tests/test_torch_pipeline.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu.models import pipeline as jpipe
from legoloam_tpu_torch.models import pipeline
from legoloam_tpu_torch.ops.se3 import Pose
from legoloam_tpu_torch.utils import synthetic

from _torch_parity import JCFG, TCFG, npy

N_SCANS = 5
N_PARITY = 4
BOUNDS = {"wedges": (4.0, 0.15), "dead_rings": (4.0, 0.15),
          "dropout": (4.0, 0.15), "spin_warp": (6.0, 0.15),
          "moving_object": (6.0, 0.15), "everything": (8.0, 0.3)}


@pytest.fixture(scope="module")
def clean_run():
    scene = synthetic.default_scene()
    poses = synthetic.circle_trajectory(N_SCANS + 1, radius=18.0,
                                        angular_rate=0.0075)
    scans = [synthetic.raycast_scan(
        scene, Pose(poses.R[k], poses.t[k]), TCFG.sensor,
        next_pose=Pose(poses.R[k + 1], poses.t[k + 1]),
        motion=True) for k in range(N_SCANS)]
    fused, _ = pipeline.run_slam_sequence(scans, TCFG, device="cpu")
    gt = npy(poses.t[:N_SCANS] - poses.t[0])
    err = np.linalg.norm(npy(fused.t) - gt, axis=1)
    return scene, poses, scans, gt, float(err.max())


@pytest.mark.parametrize("case", synthetic.PATHOLOGIES)
def test_pathology_degrades_gracefully(case, clean_run):
    scene, poses, clean, gt, clean_max = clean_run
    scans = synthetic.pathology_scans(case, scene, poses, TCFG.sensor,
                                      clean=clean)
    fused, _ = pipeline.run_slam_sequence(scans, TCFG, device="cpu")
    t = npy(fused.t)
    assert np.isfinite(t).all(), "NaN/inf pose under pathology"
    factor, floor = BOUNDS[case]
    err = float(np.linalg.norm(t - gt, axis=1).max())
    assert err < max(clean_max * factor, floor), (err, clean_max)
    if case == "everything":
        j_fused, _ = jpipe.run_slam_sequence(
            [tuple(jnp.asarray(npy(a)) for a in s)
             for s in scans[:N_PARITY]], JCFG)
        gap = np.abs(t[:N_PARITY] - np.asarray(j_fused.t)).max()
        assert gap < 1e-3, gap


def _finite_state(tree):
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            assert torch.isfinite(tree).all(), "non-finite state leaf"
        return
    for leaf in tree:
        _finite_state(leaf)


def test_blackout_and_sparse_scans_mid_stream():
    """An all-invalid scan and a 20-point ground scan mid-sequence leave the
    state finite, and the pose recovers and keeps advancing."""
    scene = synthetic.default_scene()
    n = 8
    poses = synthetic.circle_trajectory(n + 1, radius=20.0,
                                        angular_rate=0.0075)
    good = [synthetic.raycast_scan(
        scene, Pose(poses.R[k], poses.t[k]), TCFG.sensor,
        next_pose=Pose(poses.R[k + 1], poses.t[k + 1]),
        motion=True) for k in range(n)]
    P = TCFG.sensor.n_points
    blackout = (torch.zeros(P, 3), torch.zeros(P, dtype=torch.bool),
                torch.zeros(P, dtype=torch.int32))
    sparse_pts = torch.zeros(P, 3)
    sparse_pts[:20, 0] = torch.linspace(2.0, 10.0, 20)
    sparse_pts[:20, 2] = -0.8
    sparse_valid = torch.zeros(P, dtype=torch.bool)
    sparse_valid[:20] = True
    sparse = (sparse_pts, sparse_valid, torch.zeros(P, dtype=torch.int32))

    seq = [good[0], good[1], blackout, good[2], sparse, good[3], good[4],
           good[5]]
    state = pipeline.init_slam_state(TCFG, "cpu")
    for k, s in enumerate(seq):
        state, out = pipeline.slam_scan_step(state, *s, TCFG, 0.1 * k,
                                             run_mapping=(k % 3 == 0))
        _finite_state(state)
        assert torch.isfinite(out.fused_pose.t).all()
        assert torch.isfinite(out.fused_pose.R).all()
    norm = math.hypot(*npy(out.fused_pose.t).tolist())
    assert 0.1 < norm < 20.0, norm
