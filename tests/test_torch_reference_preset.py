"""``config.REFERENCE`` on the port end to end, and the scan-1 bootstrap on
a fast start: the contracts of tests/test_reference_preset.py and
tests/test_bootstrap.py::test_bootstrap_recovers_fast_start, with the
port's pipeline on the CPU.

Bounds are the JAX tests': the preset flips exactly the documented knobs;
5 scans stay finite with a keyframe; 33 scans keep the fused ATE under
0.60 m with at least two keyframes (``slow``); on the circuit's 0.8 m a
scan start the bootstrap ends 13 scans under 0.8x the plain run's end
error and under 0.8 m (``slow``).  Map caps are the JAX tests' CPU sizes;
chip_smoke's ``[reference]`` phase runs the preset at DEFAULT capacities.
"""

import dataclasses

import numpy as np
import pytest
import torch

from legoloam_tpu.config import REFERENCE as JREF
from legoloam_tpu_torch.config import DEFAULT, REFERENCE
from legoloam_tpu_torch.models import pipeline
from legoloam_tpu_torch.ops.se3 import Pose
from legoloam_tpu_torch.utils import metrics, synthetic

from _torch_parity import port_cfg

SMALL_MAP = dict(max_keyframes=128, submap_corner_cap=8192,
                 submap_surf_cap=16384, scan_corner_cap=1024,
                 scan_surf_cap=4096)


def test_reference_preset_values():
    """The preset flips exactly the documented knobs, and equals the JAX
    package's preset field by field."""
    assert port_cfg(JREF) == REFERENCE
    assert REFERENCE.feat.edge_per_section == 2
    assert REFERENCE.feat.edge_less_per_section == 20
    assert REFERENCE.feat.surf_per_section == 4
    assert REFERENCE.odom.max_iterations == 25
    assert REFERENCE.odom.corr_refresh_every == 5
    assert REFERENCE.odom.step_damping == 0.05
    assert REFERENCE.odom.robust_after_iter == 5
    assert REFERENCE.odom.warp_blend == 1.0
    assert REFERENCE.mapping.corr_refresh_every == 1
    assert REFERENCE.mapping.min_lm_keyframes == 0
    assert REFERENCE.mapping.max_step_trans == 0.0
    assert REFERENCE.mapping.prior_trans_std == 0.0
    assert REFERENCE.mapping.ground_anchor == 0.0
    assert REFERENCE.loop.enabled == DEFAULT.loop.enabled is False
    assert REFERENCE.mapping.keyframe_dist == 0.3
    assert REFERENCE.sensor == DEFAULT.sensor


def _ref_run(n):
    """n scans of the reference preset along the 20 m courtyard arc (the
    last scan rigid); returns the fused positions, the final state and the
    trajectory."""
    cfg = REFERENCE.replace(mapping=dataclasses.replace(
        REFERENCE.mapping, **SMALL_MAP))
    scene = synthetic.default_scene()
    poses = synthetic.circle_trajectory(n, radius=20.0, angular_rate=0.0075)
    state = pipeline.init_slam_state(cfg, "cpu")
    fused = []
    for k in range(n):
        nxt = min(k + 1, n - 1)
        scan = synthetic.raycast_scan(
            scene, Pose(poses.R[k], poses.t[k]), cfg.sensor,
            next_pose=Pose(poses.R[nxt], poses.t[nxt]), motion=k + 1 < n)
        state, out = pipeline.slam_scan_step(
            state, *scan, cfg, k * 0.1,
            run_mapping=(k % cfg.mapping_every == 0))
        fused.append(out.fused_pose.t)
    return torch.stack(fused), state, poses


def test_reference_preset_smoke():
    """One mapping cadence of full SLAM under the reference-exact
    configuration stays finite."""
    fused, state, _ = _ref_run(5)
    assert torch.isfinite(fused).all()
    assert int(state.mapping.kf.count) >= 1


@pytest.mark.slow
def test_reference_preset_end_to_end():
    """33 scans under the reference-exact configuration: finite, bounded
    ATE (the bound catches divergence, not parity).  The last scan is
    excluded, as in the JAX test."""
    fused, state, poses = _ref_run(33)
    assert torch.isfinite(fused).all()
    assert int(state.mapping.kf.count) >= 2
    ate = float(metrics.ate_rmse(fused[:-1], poses.t[1:]))
    assert ate < 0.60, ate


@pytest.mark.slow
def test_bootstrap_recovers_fast_start():
    """Circuit regime (0.8 m a scan from a standing start): with the
    bootstrap the early fused trajectory ends measurably closer to ground
    truth than without (measured with the JAX package: plain ~1.35 m,
    bootstrap ~0.53 m)."""
    cfg = DEFAULT.replace(mapping=dataclasses.replace(
        DEFAULT.mapping, submap_merge_batch=1, **SMALL_MAP))
    half, n = 60.0, 13
    scene = synthetic.circuit_scene(half)
    poses = synthetic.circuit_trajectory(n + 1, half=half)
    scans = [synthetic.raycast_scan(
        scene, Pose(poses.R[k], poses.t[k]), cfg.sensor,
        next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True)
        for k in range(n)]

    def run(bootstrap):
        st = pipeline.init_slam_state(cfg, "cpu")
        traj = []
        for k, s in enumerate(scans):
            st, out = pipeline.slam_scan_step(
                st, *s, cfg, k * 0.1,
                run_mapping=(k % cfg.mapping_every == 0),
                bootstrap=(bootstrap and k == 1))
            traj.append(out.fused_pose.t.numpy())
        return np.stack(traj)

    R0 = poses.R[0].numpy()
    gt = (poses.t[:n].numpy() - poses.t[0].numpy()) @ R0
    e_plain = float(np.linalg.norm(run(False)[-1] - gt[-1]))
    e_boot = float(np.linalg.norm(run(True)[-1] - gt[-1]))
    assert e_boot < 0.8 * e_plain, (e_boot, e_plain)
    assert e_boot < 0.8, e_boot
