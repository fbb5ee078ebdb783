"""The long-horizon evaluation (``legoloam_tpu_torch/evals/long.py``, port
of ``tools/eval_long.py``): its report, returned numbers and ``--save``
file on every world and option at CPU sizes, its trajectories against the
JAX tool's on the same scans, and (``slow``) the accuracy locks of
tests/test_circuit_drift.py and tests/test_noimu_mapping.py on the port.

Tolerances: against the JAX tool, fused and odometry-only positions within
1e-3 m over 7 noiseless scans with equal keyframe counts (float summation
order, as tests/test_torch_pipeline.py), ground truth within 1e-5 m.  The
slow locks keep the JAX tests' bounds: circuit (360 scans, sigma 2 cm) fused
end drift < 1% of the path, odometry < 8%; ring (90 scans, no IMU) fused
ATE < 0.5x odometry-only and < 0.4 m, the final mapped rotation
|det - 1| < 1e-4.  The 800-scan ring and the 1150-scan circuit are
chip_smoke's ``[long ring]`` and ``[long circuit]`` phases.
"""

import importlib.util
import math
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from legoloam_tpu.config import DEFAULT as JD
from legoloam_tpu.ops.se3 import Pose as JPose
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch.evals import long
from legoloam_tpu_torch.utils import synthetic as tsyn

import _torch_parity  # noqa: F401  (one intra-op thread per worker)

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--backend", "cpu", "--preset", "small"]
# The JAX tool's --set-map for the port's --preset small capacities.
SMALL_MAP = ["max_keyframes=128", "submap_corner_cap=4096",
             "submap_surf_cap=8192", "scan_corner_cap=1024",
             "scan_surf_cap=4096"]
KEYS = {"fused_t": (3,), "odom_t": (3,), "gt_t": (3,), "fused_R": (3, 3),
        "odom_R": (3, 3), "mapped_t": (3,), "gt_R": (3, 3)}


@pytest.mark.parametrize("extra", [
    ["--world", "courtyard"],
    ["--world", "loop", "--imu"],
    ["--world", "circuit", "--circuit-half", "60", "--noise", "0.02"],
    ["--traj", "figure8", "--loop", "--set-map", "ground_anchor=0",
     "--set-odo", "max_iterations=10"]],
    ids=["courtyard", "loop-imu", "circuit-noise", "figure8-loop"])
def test_long_eval_reports_and_saves(extra, tmp_path, capsys):
    n = 11 if "--loop" in extra else 5
    path = tmp_path / "run.npz"
    res = long.main(SMALL + ["--scans", str(n), "--save", str(path)] + extra)
    out = capsys.readouterr().out
    assert f"scans {n}, keyframes {res['keyframes']}, path" in out
    assert "ATE RMSE  odometry-only:" in out and "end drift" in out
    assert f"saved trajectories -> {path}" in out
    for k in ("path", "ate_odom", "ate_fused", "drift_odom", "drift_fused"):
        assert math.isfinite(res[k]) and res[k] >= 0.0, k
    assert res["path"] > 0.5
    assert res["keyframes"] >= 1 and res["closures"] == 0
    assert abs(np.linalg.det(res["mapped_R"]) - 1.0) < 1e-4
    data = np.load(path)
    assert set(data.files) == set(KEYS) | {"kf_t", "kf_count"}
    for k, shape in KEYS.items():
        assert data[k].shape == (n,) + shape, k
        assert np.isfinite(data[k]).all(), k
    assert data["kf_t"].shape == (128, 3) and int(data["kf_count"]) == \
        res["keyframes"]
    np.testing.assert_allclose(data["gt_t"][0], 0.0, atol=1e-6)


def test_long_eval_noise_is_seeded(tmp_path):
    """--noise draws one seeded generator a scan: two runs agree bit for
    bit, and differ from the noiseless run."""
    runs = []
    for noise in ("0.02", "0.02", "0"):
        path = tmp_path / f"{len(runs)}.npz"
        long.main(SMALL + ["--scans", "3", "--noise", noise, "--save",
                           str(path)])
        runs.append(np.load(path)["odom_t"])
    assert np.array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])


def test_long_eval_rejects_unknown_overrides():
    with pytest.raises(AttributeError):
        long.main(SMALL + ["--scans", "1", "--set-map", "no_such_field=1"])


def _jax_tool(argv):
    """``tools/eval_long.py`` run in this process with ``argv``."""
    spec = importlib.util.spec_from_file_location(
        "eval_long_jax", REPO / "tools" / "eval_long.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = sys.argv
    sys.argv = ["eval_long.py", *argv]
    try:
        mod.main()
    finally:
        sys.argv = saved


def test_long_eval_matches_jax_tool(tmp_path, monkeypatch):
    """The courtyard world, 7 noiseless scans: the port's evaluation with
    the JAX tool's scans (its jitted ray cast, fed through the port's
    ``raycast_scan``) against the JAX tool at the same capacities."""
    n = 7
    j_path, t_path = tmp_path / "jax.npz", tmp_path / "port.npz"
    _jax_tool(["--scans", str(n), "--save", str(j_path)]
              + [a for kv in SMALL_MAP for a in ("--set-map", kv)])

    scene = jsyn.default_scene()
    poses = jsyn.circle_trajectory(n + 1, radius=26.0, angular_rate=0.009)
    ray = jax.jit(lambda a, b, c, d: jsyn.raycast_scan(
        scene, JPose(a, b), JD.sensor, next_pose=JPose(c, d), motion=True))
    casts = iter(range(n))

    def jax_scan(scene_t, pose, sensor, **kw):
        k = next(casts)
        np.testing.assert_allclose(pose.t.numpy(), np.asarray(poses.t[k]),
                                   atol=1e-5)
        out = ray(poses.R[k], poses.t[k], poses.R[k + 1], poses.t[k + 1])
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    monkeypatch.setattr(tsyn, "raycast_scan", jax_scan)
    res = long.main(SMALL + ["--scans", str(n), "--save", str(t_path)])
    j, t = np.load(j_path), np.load(t_path)
    assert int(j["kf_count"]) == int(t["kf_count"]) == res["keyframes"]
    np.testing.assert_allclose(t["gt_t"], j["gt_t"], atol=1e-5)
    for key in ("fused_t", "odom_t", "mapped_t"):
        gap = np.abs(t[key] - j[key]).max()
        assert gap < 1e-3, (key, gap)


@pytest.mark.slow
def test_circuit_end_drift_under_one_percent():
    """tests/test_circuit_drift.py on the port: 360 circuit scans at
    sigma 2 cm, DEFAULT."""
    res = long.main(["--backend", "cpu", "--world", "circuit", "--scans",
                     "360", "--noise", "0.02"])
    assert math.isfinite(res["drift_fused"])
    assert res["drift_fused"] < 0.01 * res["path"], res
    assert res["drift_odom"] < 0.08 * res["path"], res


@pytest.mark.slow
def test_noimu_fused_beats_odometry_on_ring_lap():
    """tests/test_noimu_mapping.py on the port: 90 ring scans without IMU,
    DEFAULT."""
    res = long.main(["--backend", "cpu", "--world", "loop", "--scans", "90"])
    assert math.isfinite(res["ate_fused"]) and math.isfinite(res["ate_odom"])
    assert res["ate_fused"] < 0.5 * res["ate_odom"], res
    assert res["ate_fused"] < 0.4, res
    R = res["mapped_R"].astype(np.float64)
    assert abs(np.linalg.det(R) - 1.0) < 1e-4
