"""The port's SLAM step with loop closure on against the benchmark's plain
loop reference (``benchmark/reference/step_loop.py``) on the CPU, and the
reference's loop cadence against the port's ``LoopScheduler``.

The run: ``benchmark/tests/tiny_loop.py``'s configuration (the 16 x 360
sensor, the ``recent`` submap, a keyframe one second old a candidate) on
the benchmark's ring scans, 24 scans with an attempt every 5th, through at
least one accepted closure and its re-solve.  The port runs its eager
``StepGraph`` with ``run_loop`` from ``LoopScheduler``; the reference
decides it from the scan's index (``programs/slam_loop.loop_due``).

Tolerances, each case its own:

  * ``exact_knn``: the port's CPU k-NN replaced by ``knn_exact``, the
    search that kernel K3 returns bit for bit on the card: every pose, the
    keyframe store, the loop factors and every other state entry equal,
    bit for bit (the reference is a frozen plain copy of the same ops);
  * ``plain_knn``: the port's own CPU k-NN (the JAX package's matrix-form
    selection) may pick another neighbour on near ties, so positions and
    keyframe translations agree to 1e-3 m and rotation entries to 1e-3
    (these 24 scans, with 2 closures, drift 3.4e-4 m and 8.2e-5); the
    factor store's endpoints, count and validity equal.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import generator, harness
from benchmark.reference import config as rc
from benchmark.reference import step_loop
from benchmark.tests import tiny, tiny_loop
from legoloam_tpu_torch import config as pc
from legoloam_tpu_torch.models import pipeline
from legoloam_tpu_torch.models.step_graph import StepGraph
from legoloam_tpu_torch.ops import knn_cuda
from legoloam_tpu_torch.ops.segments import leaves

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
SCANS = 24
OUTPUTS = ("odom_pose", "mapped_pose", "fused_pose")
TOL = {"exact_knn": (0.0, 0.0), "plain_knn": (1e-3, 1e-3)}


def _loop_due():
    return harness.load_program(BENCH, "slam_loop").loop_due


def _run(monkeypatch, knn):
    if knn == "exact_knn":
        monkeypatch.setattr(knn_cuda, "knn_plain",
                            lambda q, qv, r, rv, k: knn_cuda.knn_exact(
                                q, qv, r, rv, k))
    d = tiny_loop.loop_pipeline()
    cfg = harness.build_config(pc.PipelineConfig(), d)
    rcfg = harness.build_config(rc.PipelineConfig(), d)
    stream = generator.ScanStream(tiny.TRAFFIC, 12345678901, cfg.sensor,
                                  "cpu")
    sg = StepGraph(pipeline.init_slam_state(cfg, "cpu"), cfg)
    sched = pipeline.LoopScheduler(cfg)
    due = _loop_due()
    state = step_loop.init_slam_state(rcfg, "cpu")
    outs, attempts = [], []
    for k in range(SCANS):
        scan = stream.scan(k)
        t = k * cfg.sensor.scan_period
        run_loop = sched.due(t)
        assert run_loop == due(k, rcfg)
        attempts.append(run_loop)
        out = sg.step(*scan, t, run_mapping=k % cfg.mapping_every == 0,
                      run_loop=run_loop)
        state, rout = step_loop.slam_step(
            state, *scan, torch.tensor(t, dtype=torch.float32), rcfg,
            k % cfg.mapping_every == 0, run_loop)
        outs.append((out, rout))
    return sg, state, outs, attempts


@pytest.mark.parametrize("knn", list(TOL))
def test_port_step_matches_the_loop_reference_through_a_closure(
        monkeypatch, knn):
    sg, state, outs, attempts = _run(monkeypatch, knn)
    pos_tol, rot_tol = TOL[knn]
    assert sum(attempts) == 4
    assert int(sg.state.loops.count) == int(state.loops.count) >= 1
    for out, rout in outs:
        for name in OUTPUTS:
            p, r = getattr(out, name), getattr(rout, name)
            assert (p.t - r.t).abs().max() <= pos_tol, name
            assert (p.R - r.R).abs().max() <= rot_tol, name
    kf, rkf = sg.state.mapping.kf, state.mapping.kf
    n = int(kf.count)
    assert int(rkf.count) == n
    assert (kf.t[:n] - rkf.t[:n]).abs().max() <= pos_tol
    assert (kf.R[:n] - rkf.R[:n]).abs().max() <= rot_tol
    lf, rlf = sg.state.loops, state.loops
    for f in ("i", "j", "valid", "count", "dropped"):
        assert torch.equal(getattr(lf, f), getattr(rlf, f)), f
    if knn == "exact_knn":
        # Every entry of the state, the tree the benchmark compares.
        for a, b in zip(leaves(sg.state), leaves(state), strict=True):
            assert torch.equal(a, b)


def test_reference_cadence_is_the_schedulers_on_the_mix():
    """Over the mix's first 20,000 scans (scan k stamped k * 0.1 s), the
    port's ``LoopScheduler`` on data time and the reference's rule from
    the scan's index decide the same attempts."""
    doc = json.loads((BENCH / "configs" / "vlp16_loop.json").read_text())
    cfg = harness.build_config(pc.PipelineConfig(), doc["pipeline"])
    rcfg = harness.build_config(rc.PipelineConfig(), doc["pipeline"])
    sched, due = pipeline.LoopScheduler(cfg), _loop_due()
    decided = [sched.due(k * cfg.sensor.scan_period) for k in range(20001)]
    assert decided == [due(k, rcfg) for k in range(20001)]
    assert sum(decided) == 2000
