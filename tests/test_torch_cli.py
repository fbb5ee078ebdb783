"""The command-line runner, ``python -m legoloam_tpu_torch``, against the JAX
package's (``legoloam_tpu/cli.py``) on the same scan files.

Tolerance: the fused trajectories of both CLIs over the same 6 .lpk files
agree to 1e-3 m (the pipeline tolerance of tests/test_torch_pipeline.py),
with equal keyframe counts; a run resumed from the CLI's checkpoint
continues exactly as the uninterrupted run (the same TUM lines but for the
time column, which restarts with the session).  ``--mesh N`` (gloo ranks
with ``--backend cpu``) against the single device: fused positions within
0.05 m (the mesh rebuilds its submap every step, the single device folds
keyframes in batches; tests/test_pipeline_dist.py's bound), equal keyframe
counts, and checkpoints that resume across the two and across N.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from legoloam_tpu import cli as jcli
from legoloam_tpu_torch import cli as tcli
from legoloam_tpu_torch.utils import io as tio

from _torch_parity import ring_scans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ["trajectory_fused.txt", "trajectory_mapped.txt", "global_map.pcd",
           "checkpoint.npz", "profile.txt"]


def _tum(path):
    return np.loadtxt(path, ndmin=2)


def _write_scans(d, n):
    scans, _ = ring_scans(n)
    d.mkdir(exist_ok=True)
    paths = []
    for k, (pts, valid, ring) in enumerate(scans):
        p = d / f"scan_{k:04d}.lpk"
        tio.write_lpk(p, pts, ring, valid)
        paths.append(str(p))
    return paths


def test_synthetic_run_writes_outputs(tmp_path, capsys):
    out = tmp_path / "run"
    rc = tcli.main(["--synthetic", "12", "--preset", "small", "--backend",
                    "cpu", "--out", str(out), "--map-every", "6",
                    "--checkpoint-every", "5", "--debug-dump",
                    str(tmp_path / "dbg"), "--debug-every", "5"])
    assert rc == 0
    for name in OUTPUTS:
        assert (out / name).exists(), name
    assert _tum(out / "trajectory_fused.txt").shape == (12, 8)
    assert sorted(os.listdir(tmp_path / "dbg")) == [
        "scan_000000.npz", "scan_000005.npz", "scan_000010.npz"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("[legoloam_tpu_torch] done: 12 scans, ")
    assert "slam_step" in (out / "profile.txt").read_text()


def test_files_match_jax_cli(tmp_path):
    paths = _write_scans(tmp_path / "scans", 6)
    args = ["--scans", *paths, "--preset", "small"]
    assert tcli.main(args + ["--backend", "cpu",
                             "--out", str(tmp_path / "port")]) == 0
    assert jcli.main(args + ["--out", str(tmp_path / "jax")]) == 0
    t = _tum(tmp_path / "port" / "trajectory_fused.txt")
    j = _tum(tmp_path / "jax" / "trajectory_fused.txt")
    assert t.shape == j.shape == (6, 8)
    assert np.array_equal(t[:, 0], j[:, 0])
    assert np.abs(t[:, 1:4] - j[:, 1:4]).max() < 1e-3
    tm = _tum(tmp_path / "port" / "trajectory_mapped.txt")
    jm = _tum(tmp_path / "jax" / "trajectory_mapped.txt")
    assert tm.shape == jm.shape


def test_resume_continues_the_run(tmp_path):
    """Split at a multiple of ``mapping_every``, where the resumed session's
    mapping cadence (by its own scan index) keeps the run's phase."""
    paths = _write_scans(tmp_path / "scans", 6)
    base = ["--preset", "small", "--backend", "cpu"]
    assert tcli.main(["--scans", *paths, *base,
                      "--out", str(tmp_path / "direct")]) == 0
    assert tcli.main(["--scans", *paths[:3], *base,
                      "--out", str(tmp_path / "first")]) == 0
    assert tcli.main(["--scans", *paths[3:], *base, "--resume",
                      str(tmp_path / "first" / "checkpoint.npz"),
                      "--out", str(tmp_path / "second")]) == 0
    direct = _tum(tmp_path / "direct" / "trajectory_fused.txt")
    first = _tum(tmp_path / "first" / "trajectory_fused.txt")
    second = _tum(tmp_path / "second" / "trajectory_fused.txt")
    assert np.array_equal(first[:, 1:], direct[:3, 1:])
    assert np.array_equal(second[:, 1:], direct[3:, 1:])
    assert np.array_equal(second[:, 0], direct[:3, 0])
    assert _tum(tmp_path / "second" / "trajectory_mapped.txt").shape == \
        _tum(tmp_path / "direct" / "trajectory_mapped.txt").shape


def test_argument_errors(tmp_path):
    with pytest.raises(SystemExit) as e:
        tcli.main(["--synthetic", "2", "--backend", "cpu", "--relocalize",
                   "--out", str(tmp_path / "a")])
    assert e.value.code == 2
    # --mesh on the cards with fewer cards than ranks (none here).
    with pytest.raises(SystemExit) as e:
        tcli.main(["--synthetic", "2", "--mesh", "4",
                   "--out", str(tmp_path / "b")])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        tcli.main(["--synthetic", "2", "--backend", "cpu", "--mesh", "-1",
                   "--out", str(tmp_path / "b")])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        tcli.main(["--backend", "cpu", "--out", str(tmp_path / "c")])
    assert e.value.code == 2


def test_mesh_runs_and_checkpoints_cross_over(tmp_path):
    """``--backend cpu --mesh 2`` writes the five outputs and follows the
    single-device run; its checkpoint resumes without ``--mesh``, and a
    single-device checkpoint resumes under ``--mesh 3``."""
    paths = _write_scans(tmp_path / "scans", 6)
    base = ["--preset", "small", "--backend", "cpu"]

    def run(name, files, *extra):
        assert tcli.main(["--scans", *files, *base, *extra,
                          "--out", str(tmp_path / name)]) == 0
        return _tum(tmp_path / name / "trajectory_fused.txt")

    direct = run("direct", paths)
    mesh = run("mesh", paths, "--mesh", "2")
    for name in OUTPUTS:
        assert (tmp_path / "mesh" / name).exists(), name
    assert np.abs(mesh[:, 1:4] - direct[:, 1:4]).max() < 0.05
    assert _tum(tmp_path / "mesh" / "trajectory_mapped.txt").shape == \
        _tum(tmp_path / "direct" / "trajectory_mapped.txt").shape

    run("mesh_first", paths[:3], "--mesh", "2")
    single_after = run("single_after", paths[3:], "--resume",
                       str(tmp_path / "mesh_first" / "checkpoint.npz"))
    run("single_first", paths[:3])
    mesh_after = run("mesh_after", paths[3:], "--mesh", "3", "--resume",
                     str(tmp_path / "single_first" / "checkpoint.npz"))
    for after in (single_after, mesh_after):
        assert np.abs(after[:, 1:4] - direct[3:, 1:4]).max() < 0.05
    assert _tum(tmp_path / "mesh_after" / "trajectory_mapped.txt").shape == \
        _tum(tmp_path / "direct" / "trajectory_mapped.txt").shape


def test_needs_a_card_without_backend_cpu(tmp_path):
    """No CUDA device and no ``--backend cpu``: ``python -m
    legoloam_tpu_torch`` exits non-zero with the device rule's message."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-m", "legoloam_tpu_torch", "--synthetic", "2",
         "--out", str(tmp_path / "run")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "run").exists()


def test_stage_timer_and_device_trace(tmp_path):
    """``StageTimer`` counts and sums each stage (on the CPU without
    synchronising); ``device_trace`` writes a Chrome trace of its block."""
    from legoloam_tpu_torch.utils import profiling

    timer = profiling.StageTimer("cpu")
    assert not timer.sync
    for _ in range(3):
        with timer.stage("a"):
            torch.ones(64).sum()
    assert timer.counts["a"] == 3 and timer.totals["a"] > 0
    assert timer.rates()["a"] > 0
    assert timer.summary().startswith("a ")
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(256, 256) @ torch.ones(256, 256)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
