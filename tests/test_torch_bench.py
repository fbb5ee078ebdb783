"""The port's bench (``legoloam_tpu_torch/bench.py``, port of the JAX
package's ``bench.py``) on the CPU at the small preset: its growing-map loop
against the JAX package's on the same scans, and every mode's summary line.

The grow loop runs over the JAX package's ray-cast scans (its jitted cast
fed through the port's ``synthetic.raycast_scan``, as
tests/test_torch_long.py does) and is held against the JAX bench's loop
(``bench.py:172-212``: no bootstrap, mapping every ``mapping_every`` scans,
``maybe_decimate(margin=64)`` after each window) at the same capacities.  A
62-keyframe margin below a 66-keyframe store and ``decimate_keep_recent=1``
make the guard decimate inside the run at a 4-scan window.  Tolerance:
fused positions within 1e-3 m (float summation order, as
tests/test_torch_pipeline.py), equal keyframe counts and decimations.
"""

import contextlib
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legoloam_tpu.config as jcfg_mod
from legoloam_tpu.models import pipeline as jpipe
from legoloam_tpu.ops.se3 import Pose as JPose
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch import bench
from legoloam_tpu_torch.models import step_graph
from legoloam_tpu_torch.utils import synthetic as tsyn

import _torch_parity  # noqa: F401  (one intra-op thread per worker)

SMALL = ["--backend", "cpu", "--preset", "small"]
N, WINDOW = 12, 4
DECIMATE = ["--set-map", "max_keyframes=66", "--set-map",
            "decimate_keep_recent=1"]
# The JAX configuration of the port's --preset small plus DECIMATE.
JCFG = jcfg_mod.DEFAULT.replace(mapping=jcfg_mod.apply_overrides(
    jcfg_mod.DEFAULT.mapping,
    ["submap_corner_cap=4096", "submap_surf_cap=8192",
     "scan_corner_cap=1024", "scan_surf_cap=4096", "max_keyframes=66",
     "decimate_keep_recent=1"]))


def _jax_scans(n):
    scene = jsyn.loop_scene()
    poses = jsyn.circle_trajectory(n + 1, radius=30.0, angular_rate=0.009)
    ray = jax.jit(lambda a, b, c, d: jsyn.raycast_scan(
        scene, JPose(a, b), JCFG.sensor, next_pose=JPose(c, d), motion=True))
    scans = [tuple(np.asarray(a) for a in ray(
        poses.R[k], poses.t[k], poses.R[k + 1], poses.t[k + 1]))
        for k in range(n)]
    return scans, np.asarray(poses.t)


def _jax_grow(scans, window):
    """The JAX bench's grow loop (``bench.py:172-212``) over ``scans``:
    fused positions, keyframes, decimations."""
    state = jpipe.init_slam_state(JCFG)
    fused, fired = [], 0
    for k, s in enumerate(scans):
        state, out = jpipe.slam_scan_step(
            state, *(jnp.asarray(a) for a in s), JCFG, 0.1 * k,
            run_mapping=(k % JCFG.mapping_every == 0), run_loop=False)
        fused.append(np.asarray(out.fused_pose.t))
        if (k + 1) % window == 0:
            state, did = jpipe.maybe_decimate(state, JCFG, margin=64)
            fired += bool(did)
    return np.stack(fused), int(state.mapping.kf.count), fired


def _port_grow(scans, j_t, runner=None):
    """The port's bench at ``--grow N`` with ``DECIMATE`` and a WINDOW-scan
    window, over the JAX package's ``scans``: (the summary, its stderr).
    ``runner``: a runner class for the step graph (None: eager)."""
    casts = iter(range(N))

    def jax_scan(scene, pose, sensor, **kw):
        k = next(casts)
        np.testing.assert_allclose(pose.t.numpy(), j_t[k], atol=1e-4)
        assert kw.get("noise_sigma", 0.0) == 0.0 and kw["motion"]
        return tuple(torch.from_numpy(np.array(a)) for a in scans[k])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsyn, "raycast_scan", jax_scan)
        if runner is not None:
            mp.setattr(step_graph, "make_runner",
                       lambda device, graph=True, read_fn=None:
                       runner(read_fn))
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            res = bench.main(SMALL + ["--grow", str(N)] + DECIMATE,
                             window=WINDOW)
    return res, err.getvalue()


@pytest.fixture(scope="module")
def grown():
    """The JAX package's scans, the JAX bench loop's result over them, and
    the port's bench (eager) over the same scans."""
    scans, j_t = _jax_scans(N)
    return scans, j_t, _jax_grow(scans, WINDOW), _port_grow(scans, j_t)


def test_grow_loop_matches_jax_bench_with_decimation(grown):
    scans, j_t, (j_fused, j_kf, j_fired), (res, err) = grown
    assert res["decimations"] == j_fired >= 1
    assert res["kf"] == j_kf and res["overflow"] == 0
    assert np.abs(res["fused"] - j_fused).max() < 1e-3
    np.testing.assert_allclose(res["gt"], j_t[:N] - j_t[0], atol=1e-4)
    assert err.count("[grow] decimated keyframe store ->") == j_fired
    assert err.count("[grow] scans ") == N // WINDOW == len(res["windows"])
    assert "[grow] trajectory:" in err and "[mem] single-device state" in err
    assert res["metric"] == \
        f"slam_grow{N}_scans_per_sec (ring world, growing map, cpu)"


def test_grow_loop_replays_across_decimation(grown):
    """The grow loop on the step graph's static-buffer path
    (``StaticRunner``: the warm-up's chains re-run from their buffers,
    the decimated store copied in by ``StepGraph.load``) equals the eager
    loop bitwise, the scans after each decimation included, and records no
    chain inside a window."""
    scans, j_t, _, (res, _) = grown
    s_res, s_err = _port_grow(scans, j_t, step_graph.StaticRunner)
    assert s_res["decimations"] == res["decimations"] >= 1
    assert np.array_equal(s_res["fused"], res["fused"])
    assert s_res["kf"] == res["kf"]
    assert [w["captures"] for w in s_res["windows"]] == [0] * (N // WINDOW)
    assert s_err.count("captures=0") == N // WINDOW


# Every mode's flags (at CPU sizes) and its metric, the JAX bench's name.
MODES = {
    "grow-circuit": (["--grow", "3", "--world", "circuit", "--noise",
                      "0.02"], "slam_grow3_scans_per_sec (circuit h=100, "
                      "growing map, cpu)"),
    "cycle": (["--cycle"], "slam_scans_per_sec (VLP-16 synthetic, cpu)"),
    "loop": (["--loop"], "slam_loop_scans_per_sec (VLP-16 synthetic, cpu)"),
    "slam-block": (["--slam-block"],
                   "slam_scans_per_sec (VLP-16 synthetic, cpu)"),
    "odometry": (["--odometry", "--block", "2"],
                 "odometry_scans_per_sec (VLP-16 synthetic, cpu)"),
    "odometry-streaming": (["--odometry", "--block", "1"],
                           "odometry_scans_per_sec (VLP-16 synthetic, cpu)"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_prints_the_jax_bench_line(mode, capsys):
    flags, metric = MODES[mode]
    res = bench.main(SMALL + ["--warmup", "1", "--scans", "2"] + flags)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == res["metric"] == metric
    assert line["unit"] == "scans/sec"
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert abs(line["vs_baseline"] - line["value"] / 10.0) <= 0.006
    assert "[bench] kernel launches in the timed run:" in err


@pytest.mark.parametrize("mode, chains", [("cycle", 5), ("slam-block", 4)])
def test_cycled_modes_replay_the_warmup_graphs(mode, chains, capsys,
                                               monkeypatch):
    """Captured (here through ``StaticRunner``), a cycled SLAM mode warms
    up past the submap cache's first skip, whatever ``--warmup`` says: the
    warm-up records every chain (a step: the non-mapping step, a mapping
    step's front and its three submap branches; a block: its front and the
    three branches) and the timed run none.  ``submap_merge_batch=2``
    brings the first skip within the 24-scan warm-up at the small
    preset."""
    monkeypatch.setattr(step_graph, "make_runner",
                        lambda device, graph=True, read_fn=None:
                        step_graph.StaticRunner(read_fn))
    bench.main(SMALL + ["--warmup", "1", "--scans", "6", f"--{mode}",
                        "--set-map", "submap_merge_batch=2"])
    err = capsys.readouterr().err
    assert f"({chains} graph captures), graph captures 0," in err


def test_defaults_and_mode_selection():
    """The JAX bench's defaults; no mode flag is the 1024-scan grow run,
    a micro-mode flag turns it off."""
    a = bench.parse([])
    assert (a.grow, a.scans, a.warmup, a.block, a.world, a.half, a.noise,
            a.chunk, a.sensor, a.backend) == (1024, 60, 12, 12, "ring",
                                               100.0, 0.0, 2048, None, None)
    assert a.mapping and not a.odometry
    for flag in ("--cycle", "--odometry", "--loop", "--slam-block"):
        assert bench.parse([flag]).grow == 0
    assert not bench.parse(["--odometry"]).mapping
    assert bench.parse(["--loop", "--grow", "256"]).grow == 256


def test_no_device_raises_without_backend():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--cycle"])
