"""CPU tests of the ``slam_loop`` program kind: a tiny loop-closure cell
(``tiny_loop.py``) through the harness, with the step's chains recorded
as the card's graph runner records them, and its reference's independence
from the port through a closure."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.tests import tiny, tiny_loop

COUNTS = '''"""Whether the window kept the program's loop counters (a test
metric)."""


def read(ctx):
    keys = ("loop_attempts", "loops_closed", "loops_dropped", "icp_iters",
            "cg_iters")
    return float(all(k in ctx.rec.counts for k in keys))
'''


def test_tiny_loop_cell_is_correct_with_no_capture_in_the_window(
        tmp_path, monkeypatch):
    """The warm-up (a lap of the mix's circle and 6 attempts) meets every
    chain of the step, loop attempts included: with the step's chains
    recorded as on the card (``StaticRunner``, the graph runner's
    dataflow), none is new inside the window.  The port's CPU k-NN is
    ``knn_exact``, as K3 is on the card, so the check compares like with
    like.  The warm-up's fixed 72 scans close loops (a keyframe half a
    second old a candidate) whatever the window's length, which the host's
    speed sets."""
    from legoloam_tpu_torch.models import step_graph
    from legoloam_tpu_torch.ops import knn_cuda
    runners = []

    def make_runner(device, graph=True, read_fn=None):
        runners.append(step_graph.StaticRunner(read_fn))
        return runners[-1]

    monkeypatch.setattr(step_graph, "make_runner", make_runner)
    monkeypatch.setattr(knn_cuda, "knn_plain",
                        lambda q, qv, r, rv, k: knn_cuda.knn_exact(
                            q, qv, r, rv, k))
    bench, spec, cell = tiny.make(tmp_path, tiny_loop.LOOP_TRAFFIC,
                                  name="tiny.loop")
    (bench / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "pipeline": tiny_loop.loop_pipeline(0.5)}))
    (bench / "metrics" / "loop_counts_in_window.py").write_text(COUNTS)
    spec["per_layer"].append({
        "name": "loop_counts_in_window", "unit": "flag", "better": "higher",
        "source": "program_counter", "layer": "loop closure",
        "moves": "scans_per_s", "workloads": [cell["name"]]})
    res = tiny.run(bench, spec, cell, seconds=1.0, trace=True)
    assert res["correct"]
    assert res["compared"]["graph_captures_in_window"]["value"] == 0
    assert res["metrics"]["loop_counts_in_window"]["value"] == 1.0
    (rt,) = runners
    assert int(rt.tallies["loops_closed"]) >= 1
    assert int(rt.tallies["icp_iters"]) > 0 and int(rt.tallies["cg_iters"]) > 0


def test_loop_reference_loads_nothing_of_the_port():
    """``slam_loop``'s ``Reference`` on the tiny loop configuration, stepped
    through an accepted closure, loads nothing of the port or of JAX."""
    code = (
        "import sys\n"
        "from benchmark import generator, harness\n"
        "from benchmark.reference import config as rc\n"
        "from benchmark.tests import tiny, tiny_loop\n"
        "cfg = harness.build_config(rc.PipelineConfig(), "
        "tiny_loop.loop_pipeline())\n"
        "stream = generator.ScanStream(tiny.TRAFFIC, 7, cfg.sensor, 'cpu')\n"
        "ref = harness.load_program(tiny.BENCH, 'slam_loop').Reference(cfg, "
        "'cpu')\n"
        "state = ref.empty()\n"
        "for k in range(21):\n"
        "    state, out = ref.step(state, k, stream.scan(k))\n"
        "print(int(state.loops.count))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'legoloam_tpu_torch', 'legoloam_tpu', 'jax'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    closed, loaded = p.stdout.strip().splitlines()[-2:]
    assert int(closed) >= 1
    assert loaded == "[]"
