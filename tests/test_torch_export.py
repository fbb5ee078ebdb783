"""Map and trajectory export and the RPE metric against the JAX package
(``legoloam_tpu/utils/export.py``, ``utils/metrics.py::rpe``).

Tolerances: the global map of a keyframe store carried across from a JAX
run has the same voxel set (equal validity, slot by slot, in the same key
order) and centroids within 1e-5 m (the two packages round the keyframe
transforms differently: XLA:CPU contracts into FMA); the PCD and TUM files
written from the same numpy input are byte-identical; RPE agrees to 1e-6 m
and 1e-6 rad.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu.ops import se3 as jse3
from legoloam_tpu.ops.se3 import Pose as JPose
from legoloam_tpu.utils import export as jex
from legoloam_tpu.utils import metrics as jmet
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch.ops.se3 import Pose as TPose
from legoloam_tpu_torch.utils import export as tex
from legoloam_tpu_torch.utils import metrics as tmet
from legoloam_tpu_torch.utils.interop import slam_state_from_numpy

from _torch_parity import jax_run, to_jax_tree


@pytest.mark.parametrize("cap", [1 << 16, 2048])
def test_global_map_matches_jax(cap, tmp_path):
    """At 2048 slots the map overflows, and both drop the same
    highest-key voxels."""
    states, _ = jax_run(6)
    kf = states[-1].mapping.kf
    jp, jv = jex.assemble_global_map(to_jax_tree(kf), leaf=0.4, cap=cap)
    tp, tv = tex.assemble_global_map(slam_state_from_numpy(kf, "cpu"),
                                     leaf=0.4, cap=cap)
    jp, jv = np.asarray(jp), np.asarray(jv)
    assert tp.shape == (cap, 3)
    assert np.array_equal(tv.numpy(), jv)
    assert int(jv.sum()) > min(1000, cap - 1)
    assert np.abs(tp.numpy() - jp).max() < 1e-5
    a, b = tmp_path / "port.pcd", tmp_path / "jax.pcd"
    tex.write_pcd(str(a), tp, tv)
    jex.write_pcd(str(b), tp.numpy(), tv.numpy())
    assert a.read_bytes() == b.read_bytes()
    assert np.array_equal(tex.read_pcd_xyz(str(a)), tp.numpy()[tv.numpy()])


def test_trajectory_files_identical(tmp_path):
    rng = np.random.default_rng(3)
    n = 40
    poses = jsyn.figure8_trajectory(n)
    R = np.array(poses.R)
    # Rotations of every quaternion branch (trace > 0 and the three
    # largest-diagonal cases).
    R[:4] = np.array([np.eye(3), np.diag([1.0, -1, -1]),
                      np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])])
    t = rng.normal(0, 10, (n, 3)).astype(np.float32)
    times = np.arange(n) * 0.1
    a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
    tex.write_trajectory_tum(str(a), torch.from_numpy(times),
                             TPose(torch.from_numpy(R), torch.from_numpy(t)))
    jex.write_trajectory_tum(str(b), times, JPose(jnp.asarray(R),
                                                  jnp.asarray(t)))
    assert a.read_bytes() == b.read_bytes()
    assert len(a.read_text().splitlines()) == n


@pytest.mark.parametrize("delta", [1, 5])
def test_rpe_matches_jax(delta):
    ref = jsyn.circle_trajectory(60, radius=20.0, angular_rate=0.03)
    rng = np.random.default_rng(4)
    est_t = np.asarray(ref.t) + rng.normal(0, 0.05, (60, 3)).astype(
        np.float32)
    yaw = np.cumsum(rng.normal(0.03, 0.004, 60)).astype(np.float32)
    est = JPose(jse3.rot_z(jnp.asarray(yaw)), jnp.asarray(est_t))
    jt, jr = jmet.rpe(est, ref, delta=delta)
    tt_, tr = tmet.rpe(TPose(torch.from_numpy(np.array(est.R)),
                             torch.from_numpy(est_t)),
                       TPose(torch.from_numpy(np.array(ref.R)),
                             torch.from_numpy(np.array(ref.t))),
                       delta=delta)
    assert abs(float(tt_) - float(jt)) < 1e-6
    assert abs(float(tr) - float(jr)) < 1e-6
    assert float(jt) > 0.01 and float(jr) > 0.001
