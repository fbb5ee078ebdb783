"""The port's scan generator against the JAX package's: same scenes, same
trajectories, equal validity, and ray-cast points to 1e-4 m — or 1e-4 of
the range for grazing rays, where float32 rounding of a small ray-direction
component is amplified by 1/|d| in the hit distance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu.config import DEFAULT as JD
from legoloam_tpu.ops.se3 import Pose as JPose
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch.ops.se3 import Pose as TPose
from legoloam_tpu_torch.utils import synthetic as tsyn

from _torch_parity import npy, port_cfg


@pytest.mark.parametrize("name", ["default_scene", "loop_scene"])
def test_scenes_equal(name):
    a, b = getattr(tsyn, name)(), getattr(jsyn, name)()
    assert np.array_equal(npy(a.boxes), np.asarray(b.boxes))
    assert np.array_equal(npy(a.cylinders), np.asarray(b.cylinders))


def test_circle_trajectory():
    a = tsyn.circle_trajectory(50, radius=30.0, angular_rate=0.009)
    b = jsyn.circle_trajectory(50, radius=30.0, angular_rate=0.009)
    np.testing.assert_allclose(npy(a.R), np.asarray(b.R), atol=1e-6)
    np.testing.assert_allclose(npy(a.t), np.asarray(b.t), atol=1e-5)


@pytest.mark.parametrize("scene_name,motion", [
    ("default_scene", False), ("default_scene", True), ("loop_scene", True)])
def test_raycast_scan(scene_name, motion):
    poses = jsyn.circle_trajectory(3, radius=30.0 if scene_name ==
                                   "loop_scene" else 8.0, angular_rate=0.05)
    jp0, jp1 = (JPose(poses.R[k], poses.t[k]) for k in (1, 2))
    tp0, tp1 = (TPose(torch.tensor(np.asarray(poses.R[k])),
                      torch.tensor(np.asarray(poses.t[k])))
                for k in (1, 2))
    pj, vj, rj = jsyn.raycast_scan(getattr(jsyn, scene_name)(), jp0,
                                   JD.sensor, next_pose=jp1, motion=motion)
    pt, vt, rt = tsyn.raycast_scan(getattr(tsyn, scene_name)(), tp0,
                                   port_cfg(JD.sensor), next_pose=tp1,
                                   motion=motion)
    assert np.array_equal(npy(vt), np.asarray(vj))
    assert np.array_equal(npy(rt), np.asarray(rj))
    np.testing.assert_allclose(npy(pt), np.asarray(pj), rtol=1e-4,
                               atol=1e-4)
    assert npy(vt).mean() > 0.5


def test_raycast_noise_from_generator():
    """Range noise comes from the caller's torch.Generator: the same seed
    gives the same scan."""
    sensor = port_cfg(JD.sensor)
    pose = TPose(torch.eye(3), torch.tensor([0.0, 0.0, 0.8]))
    scene = tsyn.default_scene()
    a = tsyn.raycast_scan(scene, pose, sensor, noise_sigma=0.02,
                          generator=torch.Generator().manual_seed(3))
    b = tsyn.raycast_scan(scene, pose, sensor, noise_sigma=0.02,
                          generator=torch.Generator().manual_seed(3))
    c = tsyn.raycast_scan(scene, pose, sensor)
    assert torch.equal(a[0], b[0])
    v = a[1] & c[1]
    d = (a[0][v].norm(dim=1) - c[0][v].norm(dim=1))
    assert 0.015 < float(d.std()) < 0.025
