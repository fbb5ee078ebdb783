"""CPU tests of the benchmark harness: discovery by name, the result
line, the no-JAX rule, the reference's independence, the yardstick's
arithmetic, the open loop's accounting, and faults planted in the timed
path that the check must catch.  ``test_control_fails_on_the_card`` needs a
CUDA card and skips without one."""

from __future__ import annotations

import ast
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import pytest
import torch

from benchmark import drivers, harness, run, trace, yardstick
from benchmark.tests import tiny

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_new_config_mix_limits_and_metric_are_found_by_name(tmp_path):
    bench, spec, cell = tiny.make(tmp_path)
    before = {p: p.read_bytes() for p in (BENCH / "configs").iterdir()}
    res = tiny.run(bench, spec, cell, trace=True)
    assert res["correct"]
    assert res["metrics"]["scans_in_window"]["value"] == res["attempted"]
    assert {p: p.read_bytes() for p in (BENCH / "configs").iterdir()} \
        == before
    names = [m["name"] for m in harness.cell_metrics(spec, cell["name"],
                                                     False)]
    assert names == ["scans_per_s", "setup_s"]


TINY_KIND = '''"""A kind added as a file: the slam kind, counting its steps."""

from pathlib import Path

from benchmark import harness

_slam = harness.load_program(Path(__file__).resolve().parents[1], "slam")
Reference = _slam.Reference


class Program(_slam.Program):
    def __init__(self, *args):
        super().__init__(*args)
        self.steps = 0

    def step(self, k, scan):
        self.steps += 1
        return super().step(k, scan)

    def counters(self):
        return {**super().counters(), "steps": self.steps}
'''
STEPS_METRIC = '''"""Steps the program counted in the window."""


def read(ctx):
    return float(ctx.rec.counts["steps"]) if "steps" in ctx.rec.counts \
        else None
'''


def _tree(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()
            and not {"tests", "__pycache__"} & set(p.relative_to(root).parts)}


def test_new_program_kind_is_found_by_name(tmp_path):
    before = _tree(BENCH)
    bench, spec, cell = tiny.make(tmp_path,
                                  {**tiny.TRAFFIC, "program": "tiny_kind"})
    (bench / "programs" / "tiny_kind.py").write_text(TINY_KIND)
    (bench / "metrics" / "steps_in_window.py").write_text(STEPS_METRIC)
    spec["per_layer"].append({
        "name": "steps_in_window", "unit": "scans", "better": "higher",
        "source": "program_counter", "layer": "driver", "moves":
        "scans_per_s", "workloads": [cell["name"]]})
    res = tiny.run(bench, spec, cell, trace=True)
    assert res["correct"]
    assert res["metrics"]["steps_in_window"]["value"] == res["attempted"] > 0
    assert _tree(BENCH) == before


def test_unknown_program_kind_names_its_file(tmp_path):
    bench, spec, cell = tiny.make(tmp_path,
                                  {**tiny.TRAFFIC, "program": "no_such_kind"})
    with pytest.raises(ValueError, match=r"programs/no_such_kind\.py"):
        tiny.run(bench, spec, cell)


def test_result_line_holds_the_contract_keys(tmp_path, capsys):
    bench, spec, cell = tiny.make(tmp_path)
    res = tiny.run(bench, spec, cell)
    run.emit(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert set(line["metrics"]) == {"scans_per_s", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(line["device"])
    last = err.strip().splitlines()[-len(line["compared"]):]
    assert [s.split()[0] for s in last] == list(line["compared"])
    assert all(" limit " in s for s in last)


def test_breakdown_of_a_trace():
    tr = trace.Trace(window_us=1000.0, busy_us=400.0, scans=2,
                     kernels={"void k1(int)": [300.0, 4], "k2": [100.0, 1]},
                     gaps={"cudaGraphLaunch": 500.0, "host": 100.0})
    b = trace.breakdown(tr)
    assert [n for n, _ in b["device_ops"]] == ["void k1(int)", "k2"]
    assert [n for n, _ in b["idle_gaps"]] == ["cudaGraphLaunch", "host"]
    assert [s for _, s in b["device_ops"] + b["idle_gaps"]] == pytest.approx(
        [3e-4, 1e-4, 5e-4, 1e-4])
    assert trace.kernel_time(tr, r"\bk1\b") == (300.0, 4)


def test_no_jax_module_after_a_run(tmp_path):
    code = (
        "import json, sys, time\n"
        "from pathlib import Path\n"
        "from benchmark.tests import tiny\n"
        "from benchmark import harness\n"
        f"b, s, c = tiny.make(Path({str(tmp_path)!r}))\n"
        "r = tiny.run(b, s, c, seconds=0.2)\n"
        "print(json.dumps([r['correct'], harness.forbidden_modules(),\n"
        "    'legoloam_tpu_torch' in sys.modules]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [True, [], True]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("legoloam_tpu_torch.fake", "jaxtyping_fake", "jax_fake"):
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == [] or all(
        m.split(".")[0] in harness.FORBIDDEN
        for m in harness.forbidden_modules())
    assert "legoloam_tpu_torch.fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "legoloam_tpu.fake", object())
    assert "legoloam_tpu.fake" in harness.forbidden_modules()


YARDSTICK_FILES = ["generator.py", "yardstick.py", "compare.py", "trace.py"]


@pytest.mark.parametrize("path", sorted(
    [p.name for p in (BENCH / "reference").glob("*.py")]
    + YARDSTICK_FILES))
def test_reference_and_yardstick_import_nothing_of_the_port(path):
    f = BENCH / "reference" / path
    if not f.exists():
        f = BENCH / path
    tree = ast.parse(f.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"legoloam_tpu_torch", "legoloam_tpu", "jax",
                        "jaxlib", "flax"}


def test_reference_loads_nothing_of_the_port():
    """Every program kind's ``Reference``, built and stepped once on the
    tiny configuration, loads nothing of the port or of JAX."""
    code = (
        "import sys\n"
        "import benchmark.reference.step, benchmark.compare\n"
        "from benchmark import generator, harness\n"
        "from benchmark.reference import config as rc\n"
        "from benchmark.tests import tiny\n"
        "cfg = harness.build_config(rc.PipelineConfig(), "
        "tiny.tiny_pipeline())\n"
        "scan = generator.ScanStream(tiny.TRAFFIC, 7, cfg.sensor, 'cpu')"
        ".scan(0)\n"
        "kinds = sorted(p.stem for p in (tiny.BENCH / 'programs')"
        ".glob('*.py'))\n"
        "for kind in kinds:\n"
        "    ref = harness.load_program(tiny.BENCH, kind).Reference(cfg, "
        "'cpu')\n"
        "    state, out = ref.step(ref.empty(), 0, scan)\n"
        "    assert out and all(p.t.shape == (3,) for p in out.values())\n"
        "print(kinds)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'legoloam_tpu_torch', 'legoloam_tpu', 'jax'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    kinds, loaded = p.stdout.strip().splitlines()[-2:]
    assert "slam" in kinds and "odometry" in kinds
    assert loaded == "[]"


def test_idle_share_and_kernel_bytes():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert yardstick.union_us(iv) == 4.0
    assert yardstick.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert yardstick.idle_share(4.0, 10.0) == pytest.approx(0.6)
    # K1 at VLP-16: seed and horizontal masks (N H), vertical (N-1) H, and
    # three int32 outputs.
    assert yardstick.ccl_bytes(16, 1800) == 2 * 28800 + 15 * 1800 \
        + 12 * 28800
    assert yardstick.picks_bytes(16, 1800) == 13 * 28800 + 64
    ms, by = yardstick.bound_ms(yardstick.picks_bytes(16, 1800),
                                yardstick.picks_ops(16, 1800))
    assert by == "bytes"
    assert ms == pytest.approx(374464 / 3.35e12 * 1e3)
    assert yardstick.percentile(range(1, 101), 0.95) == 95


class _State(NamedTuple):
    x: torch.Tensor


class _Pose(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor


class _SlowProgram:
    """Steps of ``fast`` s, scan ``slow_at`` one of ``slow`` s."""

    outputs = (drivers.HOST_POSE,)

    def __init__(self, fast, slow, slow_at):
        self.fast, self.slow, self.slow_at = fast, slow, slow_at
        self.state = _State(torch.zeros(2))

    def is_mapping(self, k):
        return k % 3 == 0

    def step(self, k, scan):
        time.sleep(self.slow if k == self.slow_at else self.fast)
        return {drivers.HOST_POSE: _Pose(torch.eye(3), torch.zeros(3))}

    def maintain(self):
        return False

    def counters(self):
        return {"replays": 0, "reads": 0, "captures": 0}


class _Stream:
    def scans(self, k0, k1):
        return [None] * (k1 - k0)


def test_open_loop_counts_from_due_times_and_late_poses():
    period, slow = 0.05, 0.12
    prog = _SlowProgram(0.002, slow, slow_at=3)
    clock = drivers.Clock("cpu")
    stager = drivers.Stager(_Stream(), 64, clock)
    stager.first()
    plan = drivers.Plan([(0, 1)])
    rec = drivers.open_loop(prog, stager, {"rate_hz": 1 / period}, 0.5,
                            plan, None)
    assert rec.scans == len(rec.latency_ms) == 10
    lat = rec.latency_ms
    # Scan 3 takes 120 ms; scan 4, due 50 ms after it, starts 70 ms late;
    # scan 5 starts 20 ms late and lands before scan 6 is due.
    assert lat[3] == pytest.approx(1e3 * slow, abs=15)
    assert lat[4] == pytest.approx(1e3 * (slow - period) + 2, abs=15)
    assert lat[5] == pytest.approx(1e3 * (slow - 2 * period) + 4, abs=15)
    assert rec.late == 2
    assert all(x < 20 for i, x in enumerate(lat) if i not in (3, 4, 5))
    assert len(rec.generator_lag_ms) == 8
    assert rec.window_s == pytest.approx(10 * period, abs=0.03)
    assert rec.kinds == [k % 3 == 0 for k in range(10)]


class _StepsUp:
    """Steps of ``slow`` s until ``at`` s after the first, then of ``fast``
    s: the card's start transient."""

    n_warm = 0

    def __init__(self, slow, fast, at):
        self.slow, self.fast, self.at, self.t0 = slow, fast, at, None

    def step(self, k, scan):
        self.t0 = self.t0 or time.perf_counter()
        late = time.perf_counter() - self.t0 >= self.at
        time.sleep(self.fast if late else self.slow)


@pytest.mark.parametrize("at, until_steady, seconds, lasts, ends", [
    (1.0, True, 0.0, (1.2, 2.2), (1.2, 2.2)),
    (99.0, True, 0.0, (1.5, 1.9), None),
    (99.0, False, 0.5, (0.5, 0.7), None),
], ids=["ends_at_the_step_up", "capped_without_one", "fixed_off_the_card"])
def test_preroll_waits_for_the_start_transient(monkeypatch, at, until_steady,
                                               seconds, lasts, ends):
    monkeypatch.setattr(harness, "STEADY_S", 0.2)
    monkeypatch.setattr(harness, "STEADY_CAP_S", 1.5)
    stager = drivers.Stager(_Stream(), 64, drivers.Clock("cpu"))
    stager.first()
    took, ended, rates = harness.preroll(_StepsUp(0.006, 0.004, at), stager,
                                         seconds, until_steady)
    assert lasts[0] <= took <= lasts[1]
    if ends is None:
        assert ended is None
    else:
        assert ends[0] <= ended <= ends[1]
        assert rates[-1] > 1.3 * rates[0]


def _unchanged(real):
    from legoloam_tpu_torch.models.pipeline import SlamOutput

    def body(state, *a, **k):
        return state, SlamOutput(state.odom.pose, state.mapping.t_aft,
                                 state.odom.pose, None)
    return body


def _half_the_points(real):
    def body(state, points, valid, *a, **k):
        keep = torch.arange(valid.shape[0], device=valid.device) % 2 == 0
        return real(state, points, valid & keep, *a, **k)
    return body


def _answer_altered(real):
    def body(state, *a, **k):
        state, out = real(state, *a, **k)
        f = out.fused_pose
        return state, out._replace(fused_pose=f._replace(t=f.t + 0.01))
    return body


@pytest.mark.parametrize("fault", [_unchanged, _half_the_points,
                                   _answer_altered],
                         ids=["state_unchanged", "half_the_points",
                              "answer_altered"])
def test_a_fault_in_the_timed_path_is_not_correct(tmp_path, monkeypatch,
                                                  fault):
    from legoloam_tpu_torch.models import pipeline
    monkeypatch.setattr(pipeline, "step_body", fault(pipeline.step_body))
    bench, spec, cell = tiny.make(tmp_path)
    res = tiny.run(bench, spec, cell, seconds=0.2)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["compared"].values())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    return "cuda"


def test_control_fails_on_the_card(tmp_path, card):
    """The control (the reference with TF32 on, in the program's place) is
    not correct at the tiny size, on three seeds."""
    from benchmark import control
    bench, spec, cell = tiny.make(tmp_path)
    for seed in (11, 12, 13):
        res = tiny.run(bench, spec, cell, seed=seed, seconds=0.5,
                       device=card, judged=control.tf32_in_place)
        assert res["correct"] is False
        assert math.isfinite(res["compared"]["pose_gap_m"]["value"])
