"""CPU test of the ``pg_scan_ms_per_attempt`` reader on a hand-made trace
and tracer summary: it sums the link scans' kernels under either
implementation (K5's two kernels, PyTorch's outer-dimension scan) and no
other kernel, divides by the tracer's ``loop_attempts`` tally, and reads
None without an attempt or a trace."""

from __future__ import annotations

import types
from pathlib import Path

import pytest

from benchmark import harness, trace

BENCH = Path(__file__).resolve().parents[1]

K5_ROWS = ("void (anonymous namespace)::link_scan_rows(float const*, int "
           "const*, float*, int)")
K5_RANGES = ("void (anonymous namespace)::link_scan_ranges(float const*, int "
             "const*, long const*, long const*, float*, float*, int, int)")
TORCH_SCAN = ("void at::native::tensor_kernel_scan_outer_dim<float, unsigned "
              "int, std::plus<float> >(float*, float const*, unsigned int, "
              "unsigned int, unsigned int, float, std::plus<float>)")
OTHERS = {
    "void at::native::tensor_kernel_scan_innermost_dim<float, 16, 32>(...)":
        [900.0, 3],
    "void (anonymous namespace)::class_nn_scan<1>(float const*, ...)":
        [700.0, 9],
    "void (anonymous namespace)::link_scan_helper(float const*)": [50.0, 1],
}


def _ctx(kernels):
    tr = trace.Trace(window_us=1e6, busy_us=5e5, scans=40,
                     kernels={**OTHERS, **kernels})
    return types.SimpleNamespace(trace=tr, rec=None)


@pytest.fixture
def tallies(monkeypatch):
    from legoloam_tpu_torch.utils import profiling
    summary = {"scans": 40, "tallies": {"loop_attempts": 4,
                                        "loops_closed": 4}}
    monkeypatch.setattr(profiling, "summary", lambda: summary)
    return summary


@pytest.mark.parametrize("kernels,us", [
    ({K5_ROWS: [40.0, 32], K5_RANGES: [600.0, 192]}, 640.0),
    ({TORCH_SCAN: [111_300.0, 224]}, 111_300.0),
])
def test_reads_the_link_scans_over_the_attempts(tallies, kernels, us):
    read = harness.load_reader(BENCH, "pg_scan_ms_per_attempt")
    assert read(_ctx(kernels)) == pytest.approx(us * 1e-3 / 4)
    tallies["tallies"]["loop_attempts"] = 8
    assert read(_ctx(kernels)) == pytest.approx(us * 1e-3 / 8)


def test_reads_none_without_an_attempt_or_a_trace(tallies):
    read = harness.load_reader(BENCH, "pg_scan_ms_per_attempt")
    ctx = _ctx({K5_RANGES: [600.0, 192]})
    assert read(types.SimpleNamespace(trace=None, rec=None)) is None
    tallies["tallies"]["loop_attempts"] = 0
    assert read(ctx) is None
    del tallies["tallies"]["loop_attempts"]
    assert read(ctx) is None
    tallies["scans"] = 0
    assert read(ctx) is None


def test_an_attempt_without_a_scan_kernel_reads_zero(tallies):
    """Attempts with no closure run no re-solve: 0 ms, not None."""
    read = harness.load_reader(BENCH, "pg_scan_ms_per_attempt")
    assert read(_ctx({})) == 0.0
