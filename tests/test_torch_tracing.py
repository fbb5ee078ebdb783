"""The tracer (``legoloam_tpu_torch/utils/profiling.py``) on the CPU: the
span tree of a program's steps through ``StaticRunner`` (the graph
runner's dataflow), nothing recorded when it is off, the profiler's clock,
the LM's iteration share, the raw spans' bound, the device spans and gaps
from stand-in timing events, the benchmark's readers of it, and the CLI's
``profile.txt``.

Tolerance: a program's ``slam.step`` span and the profiler's event of the
same name start and end within 50 us of each other (both are stamped on
the same host clock around the same call).
"""

import contextlib
import dataclasses
from pathlib import Path

import pytest
import torch

from legoloam_tpu_torch.config import DEFAULT
from legoloam_tpu_torch.models import odometry, pipeline, step_graph
from legoloam_tpu_torch.ops.se3 import Pose
from legoloam_tpu_torch.parallel.dryrun import TINY_FEAT, TINY_SENSOR
from legoloam_tpu_torch.utils import profiling, synthetic

ROOT = Path(__file__).resolve().parents[1]
CLOCK_TOL_NS = 50_000

READERS = ("launch_ms_per_scan", "step_host_ms_per_scan",
           "graph_nodes_per_scan", "host_gap_ms_per_scan", "front_chain_ms",
           "lm_useful_iter_share", "mapping_chain_ms",
           "read_wait_ms_per_mapping_scan")


def _cfg():
    """The tiny sensor, small map caps, the submap cache folding one
    keyframe a batch (so every branch is met within a few mapping
    steps)."""
    return DEFAULT.replace(
        sensor=TINY_SENSOR, feat=TINY_FEAT,
        mapping=dataclasses.replace(
            DEFAULT.mapping, max_keyframes=16, scan_corner_cap=64,
            scan_surf_cap=128, submap_corner_cap=256, submap_surf_cap=512,
            submap_merge_batch=1))


@pytest.fixture(scope="module")
def scans():
    scene = synthetic.default_scene()
    return [synthetic.raycast_scan(
        scene, Pose(torch.eye(3), torch.tensor([0.2 * k, 0.0, 0.8])),
        TINY_SENSOR) for k in range(24)]


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


def _slam(cfg, scans, upto):
    """A StepGraph on a StaticRunner, stepped over scans [0, upto)."""
    sg = step_graph.StepGraph(pipeline.init_slam_state(cfg, "cpu"), cfg,
                              runner=step_graph.StaticRunner())
    for k in range(upto):
        _step(sg, cfg, scans, k)
    return sg


def _step(sg, cfg, scans, k):
    return sg.step(*scans[k], k * cfg.sensor.scan_period,
                   run_mapping=k % cfg.mapping_every == 0,
                   bootstrap=k == 1)


def _odometry(cfg):
    return step_graph.OdometryGraph(
        odometry.init_state(cfg.odom, cfg.feat, "cpu"), cfg,
        runner=step_graph.StaticRunner())


def test_span_tree_of_a_mapping_and_a_tracking_step(scans):
    cfg = _cfg()
    warm = 18                  # past the submap cache's first skip
    sg = _slam(cfg, scans, warm)
    assert profiling.summary()["steps"] == 0   # nothing traced so far
    r0, n0 = sg.rt.replays, sg.rt.reads
    with profiling.tracing():
        for k in (warm, warm + 1):
            _step(sg, cfg, scans, k)
    s = profiling.summary()
    assert (s["steps"], s["scans"], s["mapping_scans"]) == (2, 2, 1)
    assert s["replays"] == sg.rt.replays - r0 == 3
    assert s["reads"] == sg.rt.reads - n0 == 1
    roots = [sp for sp in s["raw"] if sp.name == "slam.step"]
    assert [(r.step, r.parent) for r in roots] == [(warm, None),
                                                   (warm + 1, None)]
    want = {warm: ["slam.inputs", "slam.replay front",
                   "slam.read submap branch",
                   "slam.replay submap+mapping+fuse", "slam.outputs"],
            warm + 1: ["slam.inputs", "slam.replay front+fuse",
                       "slam.outputs"]}
    for root in roots:
        kids = sorted((sp for sp in s["raw"] if sp.parent == root.sid),
                      key=lambda sp: sp.start_ns)
        assert [sp.name for sp in kids] == want[root.step]
        assert all(sp.step == root.step for sp in kids)
        assert all(root.start_ns <= sp.start_ns <= sp.end_ns <= root.end_ns
                   for sp in kids)
    # Every span of a traced step is in the tree; the chains as named.
    assert {sp.step for sp in s["raw"]} == {warm, warm + 1}
    assert sorted(s["chains"]) == ["front", "front+fuse",
                                   "submap+mapping+fuse"]
    assert all(c["nodes"] == 0 and c["device_ms"] == []
               for c in s["chains"].values())
    child = sum(v["ms"] for n, v in s["spans"].items()
                if n.startswith(("slam.replay ", "slam.read ")))
    assert s["step_host_ms"] == pytest.approx(s["step_ms"] - child)


def test_off_records_nothing(scans, monkeypatch):
    cfg = _cfg()

    def refuse(*a, **k):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(profiling.Tracer, "begin", refuse)
    og = _odometry(cfg)
    sg = _slam(cfg, scans, 4)
    for k in range(3):
        og.step(*scans[k])
    s = profiling.summary()
    assert s["steps"] == s["replays"] == s["reads"] == 0
    assert s["spans"] == {} and s["raw"] == [] and s["chains"] == {}
    assert sg.rt.replays > 0 and og.rt.replays > 0
    assert sg.rt.tracer is None and og.rt.tracer is None


def test_spans_share_the_profilers_clock(scans):
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg()
    og = _odometry(cfg)
    for k in range(2):                 # capture, then one replay, untraced
        og.step(*scans[k])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(2, 5):
            og.step(*scans[k])
    og.step(*scans[5])                 # after the session: not traced
    s = profiling.summary()
    assert (s["steps"], s["replays"]) == (3, 3)
    mine = sorted((sp.start_ns, sp.end_ns) for sp in s["raw"]
                  if sp.name == "slam.step")
    evs = prof.profiler.kineto_results.events()
    theirs = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in evs if e.name() == "slam.step")
    assert len(mine) == len(theirs) == 3
    for (a0, a1), (b0, b1) in zip(mine, theirs):
        assert abs(a0 - b0) < CLOCK_TOL_NS and abs(a1 - b1) < CLOCK_TOL_NS
    names = {e.name() for e in evs}
    assert {"slam.inputs", "slam.replay odometry", "slam.outputs"} <= names


def test_lm_share_equals_the_outputs_diag(scans):
    cfg = _cfg()
    og = _odometry(cfg)
    outs = []
    with profiling.tracing():
        for k in range(6):
            outs.append(og.step(*scans[k]))
        blk = og.block(*(torch.stack(a) for a in zip(*scans[6:10])))
    used = sum(int(o.diag.surf_iters) + int(o.diag.corner_iters)
               for o in outs)
    used += int(blk.diag.surf_iters.sum() + blk.diag.corner_iters.sum())
    s = profiling.summary()
    assert s["scans"] == 10 and s["steps"] == 7
    assert s["lm_run"] == 10 * 2 * cfg.odom.max_iterations
    assert 0 < s["lm_used"] == used <= s["lm_run"]


def test_raw_spans_of_the_last_steps_only(scans, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_STEPS", 3)
    profiling.reset()
    og = _odometry(_cfg())
    with profiling.tracing() as tr:
        with profiling.span(tr, "raycast"):    # a stage outside a step
            pass
        for k in range(5):
            og.step(*scans[k])
    s = profiling.summary()
    assert (s["steps"], s["spans"]["slam.step"]["count"]) == (5, 5)
    assert s["spans"]["raycast"]["count"] == 1
    assert sorted({sp.step for sp in s["raw"]}) == [2, 3, 4]
    assert all(sp.name != "raycast" for sp in s["raw"])


class _Event:
    """A timing event on a stand-in card: ``t``, its time in ms, is set
    once it has run; ``elapsed_time`` raises before, as torch's does."""

    def __init__(self):
        self.t = None

    def record(self, stream):
        stream.recorded.append(self)

    def query(self):
        return self.t is not None

    def elapsed_time(self, end):
        if self.t is None or end.t is None:
            raise RuntimeError("elapsed_time of an event that has not run")
        return end.t - self.t


class _Stream:
    def __init__(self):
        self.device = torch.device("cpu")
        self.recorded = []


def test_device_spans_start_at_the_later_of_stream_and_launch(monkeypatch):
    tr = profiling.TRACER
    stream, side = _Stream(), _Stream()
    monkeypatch.setattr(tr, "_event", _Event)
    monkeypatch.setattr(tr, "_side", lambda device: side)
    program = object()
    for k in range(2):
        root = tr.begin(program, k, 1, False, torch.device("cpu"))
        tr.replay("odometry", 10, lambda: None, stream)
        tr.end(root)
    (a0, a1, b0, b1), (a_l, b_l) = stream.recorded, side.recorded
    # Chain a: the stream idle, its launch returns at 3 ms, it ends at 10.
    a0.t, a_l.t, a1.t = 0.0, 3.0, 10.0
    tr._poll(block=False)          # b has not run: left pending, no raise
    assert tr.chains["odometry"].device_ms == [7.0] and len(tr._pending) == 1
    # Chain b: recorded 2 ms after a ended, launched at 15 ms, done at 20.
    b0.t, b1.t = 12.0, 20.0
    tr._poll(block=False)          # its launch event has not run
    assert len(tr._pending) == 1
    b_l.t = 15.0
    tr._poll(block=False)
    s = profiling.summary()
    assert s["chains"]["odometry"]["device_ms"] == [7.0, 5.0]
    assert (s["gap_ms"], s["gaps"]) == (5.0, 1)
    # Behind the stream's earlier work the before-event starts the span.
    root = tr.begin(program, 2, 1, False, torch.device("cpu"))
    tr.replay("odometry", 10, lambda: None, stream)
    tr.end(root)
    c0, c1 = stream.recorded[4:]
    c0.t, side.recorded[2].t, c1.t = 20.0, 18.0, 26.0
    tr._poll(block=False)
    s = profiling.summary()
    assert s["chains"]["odometry"]["device_ms"] == [7.0, 5.0, 6.0]
    assert (s["gap_ms"], s["gaps"]) == (5.0, 2)


def _hand_built():
    """A tracer as after 4 traced scans, 2 of them mapping, on the card:
    chains with device spans, a submap read, LM iterations."""
    tr = profiling.TRACER
    tr.steps = tr.scans = 4
    tr.mapping_scans = 2
    tr.nodes = 2 * 100 + 2 * 60 + 2 * 40
    tr.step_ns, tr.step_self_ns = 40_000_000, 6_000_000
    tr.spans = {"slam.read submap branch": [2, 18_000_000],
                "slam.replay front+fuse": [2, 400_000]}
    for name, nodes, launch_ns, dev, gap in (
            ("front+fuse", 100, 400_000, [8.0, 9.0], 0.5),
            ("front", 60, 300_000, [7.0, 10.0], 0.25),
            ("submap+mapping+fuse", 40, 200_000, [2.0, 3.0], 0.0)):
        c = tr.chains[name] = profiling._Chain(nodes)
        c.replays, c.launch_ns, c.device_ms, c.gap_ms = 2, launch_ns, dev, gap
    tr.gap_ms, tr.gaps = 0.75, 5
    tr._lm = [torch.tensor(3), torch.tensor([2, 1])]
    tr.lm_run = 40


def test_readers_of_the_tracer():
    from benchmark import harness

    bench = ROOT / "benchmark"
    readers = {m: harness.load_reader(bench, m) for m in READERS}
    # The readers read the tracer, not the harness's context.
    assert all(r(None) is None for r in readers.values())
    _hand_built()
    want = {"launch_ms_per_scan": 0.9 / 4,
            "step_host_ms_per_scan": 6.0 / 4,
            "graph_nodes_per_scan": 400 / 4,
            "host_gap_ms_per_scan": 0.75 / 4,
            "front_chain_ms": 8.5,          # median of 8, 9, 7, 10
            "lm_useful_iter_share": 100.0 * 6 / 40,
            "mapping_chain_ms": 2.5,
            "read_wait_ms_per_mapping_scan": 18.0 / 2}
    for m, r in readers.items():
        assert r(None) == pytest.approx(want[m]), m


LOOP_READERS = ("loop_ms_per_attempt", "loop_reads_per_attempt",
                "cg_iters_per_solve", "loop_device_share")


def _loop_run(runner):
    """``benchmark/tests/tiny_loop.py``'s loop configuration on the ring's
    scans: 14 scans untraced, then scan 15 traced, an attempt that closes
    a loop (a keyframe one second old is a candidate).  Returns (the
    StepGraph, its runner's tallies before the traced scan)."""
    from benchmark import generator, harness
    from benchmark.tests import tiny, tiny_loop

    cfg = harness.build_config(DEFAULT, tiny_loop.loop_pipeline())
    stream = generator.ScanStream(tiny.TRAFFIC, 12345678901, cfg.sensor,
                                  "cpu")
    sg = step_graph.StepGraph(pipeline.init_slam_state(cfg, "cpu"), cfg,
                              runner=runner)
    sched = pipeline.LoopScheduler(cfg)
    before = None
    for k in range(16):
        if k == 15:
            before = dict(sg.rt.tallies)
        t = k * cfg.sensor.scan_period
        with profiling.tracing() if k == 15 else contextlib.nullcontext():
            sg.step(*stream.scan(k), t, run_mapping=k % 3 == 0,
                    run_loop=sched.due(t))
    return sg, before


@pytest.mark.parametrize("runner", ["eager", "static"])
def test_a_loop_attempt_is_tallied_and_read(runner):
    """One traced attempt with a closure: the runner's and the tracer's
    tallies (the attempt, the closure, the ICP's iterations and the
    re-solve's CG iterations), its reads, its chains (on the static runner)
    and the benchmark's loop readers of them."""
    from benchmark import harness

    sg, before = _loop_run(step_graph.StaticRunner() if runner == "static"
                           else None)
    s = profiling.summary()
    tallies = {n: int(v) - int(before.get(n, 0))
               for n, v in sg.rt.tallies.items()}
    assert s["tallies"] == tallies
    assert tallies["loop_attempts"] == tallies["loops_closed"] == 1
    assert int(sg.state.loops.count) >= 1
    gn = sg.cfg.posegraph.gn_iters
    assert tallies["icp_iters"] >= 1 and tallies["cg_iters"] >= gn
    reads = {n[10:]: v["count"] for n, v in s["spans"].items()
             if n.startswith("slam.read ")}
    assert reads["loop accepted"] == 1
    assert reads["ICP stop"] >= 1 and reads["CG stop"] >= gn
    if runner == "static":
        # The chains replayed (those met before: a chain's first run is
        # its capture), named by their heads; the ICP's is "loop icp".
        assert {"loop+loop icp", "loop icp+loop", "pg"} <= set(s["chains"])
    bench = ROOT / "benchmark"
    got = {m: harness.load_reader(bench, m)(None) for m in LOOP_READERS}
    assert got["loop_reads_per_attempt"] == sum(
        reads[n] for n in ("ICP stop", "loop accepted", "CG stop"))
    assert got["cg_iters_per_solve"] == tallies["cg_iters"]
    # No device time on the CPU: the attempt's chains read 0 ms, and the
    # share has nothing to divide by.
    assert got["loop_ms_per_attempt"] == 0.0
    assert got["loop_device_share"] is None


def test_loop_readers_of_the_tracer():
    """The loop readers on a hand-built tracer: 2 attempts, one closed,
    with device spans on the loop's chains and on the others."""
    from benchmark import harness

    bench = ROOT / "benchmark"
    readers = {m: harness.load_reader(bench, m) for m in LOOP_READERS}
    assert all(r(None) is None for r in readers.values())
    _hand_built()
    tr = profiling.TRACER
    for name, dev in (("loop+loop icp", [3.0, 4.0]),
                      ("loop icp+loop", [1.0, 1.0]), ("pg", [20.0]),
                      ("pg+loop+fuse", [2.0]), ("loop+fuse", [1.0])):
        c = tr.chains[name] = profiling._Chain(10)
        c.replays, c.device_ms = len(dev), dev
    tr.spans.update({"slam.read ICP stop": [5, 1_000_000],
                     "slam.read loop accepted": [2, 1_000_000],
                     "slam.read CG stop": [12, 1_000_000]})
    for n, x in (("loop_attempts", 2), ("loops_closed", 1),
                 ("cg_iters", torch.tensor(40)),
                 ("icp_iters", torch.tensor(30))):
        tr.tally(n, x)
    loop_ms = 3.0 + 4.0 + 1.0 + 1.0 + 20.0 + 2.0 + 1.0
    every = loop_ms + 8.0 + 9.0 + 7.0 + 10.0 + 2.0 + 3.0
    want = {"loop_ms_per_attempt": loop_ms / 2,
            "loop_reads_per_attempt": (5 + 2 + 12) / 2,
            "cg_iters_per_solve": 40.0,
            "loop_device_share": 100.0 * loop_ms / every}
    for m, r in readers.items():
        assert r(None) == pytest.approx(want[m]), m


def test_cli_profile_holds_chains_and_launches(tmp_path):
    from legoloam_tpu_torch import cli

    out = tmp_path / "run"
    assert cli.main(["--synthetic", "4", "--preset", "small", "--backend",
                     "cpu", "--out", str(out)]) == 0
    text = (out / "profile.txt").read_text()
    lines = text.splitlines()
    assert lines[0].startswith("4 scans in ") and "scans/s" in lines[0]
    assert any(ln.split()[:4] == ["chain", "replays", "nodes", "launch"]
               for ln in lines)
    assert "traced: 4 steps, 4 scans (2 mapping)" in text
    assert "read submap branch: 2 x " in text
    assert "odometry LM iterations used " in text
    assert any(ln.startswith("raycast ") for ln in lines)
    assert lines[-1].startswith("kernel launches: ")
