"""The two end-to-end evaluations (``legoloam_tpu_torch/evals``, ports of
``tools/eval_kidnap.py`` and ``tools/eval_loop_recovery.py``) and the
synthetic worlds they drive, against the JAX package's generators.

Tolerances (those of tests/test_torch_synthetic.py): scenes exact,
trajectories to 1e-5, ray-cast points to 1e-4 m or 1e-4 of the range with
equal validity and rings.  The evaluations run to their tables at CPU sizes
(a few scans, small caps); their full-size numbers come from chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch

from legoloam_tpu.config import DEFAULT as JD
from legoloam_tpu.ops.se3 import Pose as JPose
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch.evals import kidnap, loop_recovery
from legoloam_tpu_torch.ops.se3 import Pose as TPose
from legoloam_tpu_torch.utils import synthetic as tsyn

from _torch_parity import npy, port_cfg


@pytest.mark.parametrize("half", [100.0, 30.0])
def test_circuit_scene_equal(half):
    a, b = tsyn.circuit_scene(half), jsyn.circuit_scene(half)
    assert np.array_equal(npy(a.boxes), np.asarray(b.boxes))
    assert np.array_equal(npy(a.cylinders), np.asarray(b.cylinders))


@pytest.mark.parametrize("name,kw", [
    ("circuit_trajectory", dict(half=100.0)),
    ("circuit_trajectory", dict(half=40.0, corner=10.0, step=1.3)),
    ("figure8_trajectory", dict(radius=10.0))])
def test_trajectories_equal(name, kw):
    a = getattr(tsyn, name)(1200 if name.startswith("circuit") else 150,
                            **kw)
    b = getattr(jsyn, name)(1200 if name.startswith("circuit") else 150,
                            **kw)
    np.testing.assert_allclose(npy(a.R), np.asarray(b.R), atol=1e-5)
    np.testing.assert_allclose(npy(a.t), np.asarray(b.t), atol=1e-5)


@pytest.mark.parametrize("warp", [0.1, 0.05])
def test_spin_warp_scan_equal(warp):
    poses = jsyn.circuit_trajectory(3, half=100.0)
    jp0, jp1 = (JPose(poses.R[k], poses.t[k]) for k in (1, 2))
    tp0, tp1 = (TPose(torch.tensor(np.asarray(poses.R[k])),
                      torch.tensor(np.asarray(poses.t[k]))) for k in (1, 2))
    pj, vj, rj = jsyn.raycast_scan(jsyn.circuit_scene(), jp0, JD.sensor,
                                   next_pose=jp1, motion=True,
                                   spin_warp=warp)
    pt, vt, rt = tsyn.raycast_scan(tsyn.circuit_scene(), tp0,
                                   port_cfg(JD.sensor), next_pose=tp1,
                                   motion=True, spin_warp=warp)
    assert np.array_equal(npy(vt), np.asarray(vj))
    assert np.array_equal(npy(rt), np.asarray(rj))
    np.testing.assert_allclose(npy(pt), np.asarray(pj), rtol=1e-4,
                               atol=1e-4)
    plain = tsyn.raycast_scan(tsyn.circuit_scene(), tp0, port_cfg(JD.sensor),
                              next_pose=tp1, motion=True)
    assert not torch.equal(plain[0], pt)       # the warp moves points


def _finite(x):
    return all(math.isfinite(v) for v in x) if isinstance(x, (list, tuple)) \
        else math.isfinite(x)


def test_kidnap_eval_runs(capsys):
    res = kidnap.main(["--backend", "cpu", "--preset", "small", "--s1", "6",
                       "--s2", "3", "--candidates", "8"])
    out = capsys.readouterr().out
    assert "| A: stale belief, no reloc |" in out
    assert "| B: ICP relocalization |" in out
    assert res["reloc"]["accepted"] is True
    for arm in ("A", "B"):
        assert _finite([res[arm][k] for k in ("abs", "umeyama", "drift")])
    assert res["B"]["abs"] < res["A"]["abs"]


def test_loop_recovery_eval_runs(capsys):
    res = loop_recovery.main(["--backend", "cpu", "--preset", "small",
                              "--pre", "6", "--post", "6", "--recent", "1",
                              "--half", "100"])
    out = capsys.readouterr().out
    assert "closure OFF" in out and "closures accepted:" in out
    assert len(res["rows"]) == 6
    assert all(_finite(r[2:]) for r in res["rows"])
    assert _finite([res["final_off"], res["final_on"], res["pre_level"]])
    with pytest.raises(ValueError, match="--recent"):
        loop_recovery.main(["--backend", "cpu", "--preset", "small",
                            "--pre", "1", "--post", "6"])
