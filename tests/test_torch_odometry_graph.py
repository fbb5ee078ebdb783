"""The odometry-only program (``step_graph.OdometryGraph``, the counterpart
of the JAX package's compiled ``odometry_scan_step`` and
``odometry_scan_block``) on the CPU, through ``StaticRunner`` (the CUDA graph
runner's dataflow: a chain of segments recorded at its first sighting and
re-run from its static buffers after), against the eager body and the JAX
package.

The body must read nothing back to the host: a ``TorchDispatchMode`` raises
on ``_local_scalar_dense`` and on the ops the step body may not run
(tests/test_torch_step_graph.py's list) while it runs, outside the plain
version of kernel K1, which runs only on the CPU.

Tolerances: the static path equals the eager body bitwise (poses, diags and
state); ``odometry_scan_block`` against the JAX package's jitted
``odometry_scan_block`` on the same scans, poses within 1e-3 m (float
summation order, as tests/test_torch_pipeline.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu.models import pipeline as jpipe
from legoloam_tpu_torch.models import odometry as odom
from legoloam_tpu_torch.models import pipeline as tpipe
from legoloam_tpu_torch.models import step_graph
from legoloam_tpu_torch.ops import ccl_cuda
from legoloam_tpu_torch.ops.segments import leaves

from _torch_parity import JCFG, TCFG, npy, ring_scans
from test_torch_step_graph import HostReads

N = 6
aten = torch.ops.aten


class NoReads(HostReads):
    """``HostReads`` that also raises on a host read."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.plain and func is aten._local_scalar_dense.default:
            raise AssertionError("host read inside the odometry body")
        return super().__torch_dispatch__(func, types, args, kwargs)


@pytest.fixture
def no_reads(monkeypatch):
    m = NoReads()
    plain_fn = ccl_cuda.label_propagation_plain

    def plain(*a, **k):
        m.plain += 1
        try:
            return plain_fn(*a, **k)
        finally:
            m.plain -= 1

    monkeypatch.setattr(ccl_cuda, "label_propagation_plain", plain)
    return m


def _scans():
    scans, _ = ring_scans(N)
    return [tuple(torch.from_numpy(np.array(a)) for a in s) for s in scans]


def _block(scans):
    return tuple(torch.stack([s[j] for s in scans]) for j in range(3))


def _fresh():
    return odom.init_state(TCFG.odom, TCFG.feat, "cpu")


@pytest.fixture(scope="module")
def eager():
    """The eager body scan by scan: (poses, diags, final state)."""
    st, outs = _fresh(), []
    for s in _scans():
        st, out = tpipe.odometry_scan_step(st, *s, TCFG)
        outs.append(out)
    return outs, st


def _cat(trees):
    """Equal trees of (B, ...) tensors -> one tree, concatenated."""
    if isinstance(trees[0], torch.Tensor):
        return torch.cat(trees)
    return type(trees[0])(*(_cat(list(x)) for x in zip(*trees)))


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b),
                                                 strict=True))


def test_static_step_equals_eager_and_replays(eager, no_reads):
    """A first pass records the scan's chain; a fresh state loaded into
    the same buffers replays it, one replay a scan, bitwise."""
    outs, st = eager
    g = step_graph.OdometryGraph(_fresh(), TCFG,
                                 runner=step_graph.StaticRunner())
    scans = _scans()
    for _ in range(2):
        replays = g.rt.replays
        with no_reads:
            got = [g.step(*s) for s in scans]
        assert all(_equal(a, b) for a, b in zip(got, outs))
        assert _equal(g.state, st)
        g.load(_fresh())
    assert len(g.rt.chains) == 1 and g.rt.replays - replays == N
    assert g.reads == 0


@pytest.mark.parametrize("B", [1, 3])
def test_static_block_equals_eager(eager, no_reads, B):
    """Blocks of B scans: one chain (one replay a block after the first),
    rows equal to the eager scans bitwise; ``pipeline.odometry_scan_block``
    on the CPU is the same body eagerly."""
    outs, st = eager
    scans = _scans()
    g = step_graph.OdometryGraph(_fresh(), TCFG,
                                 runner=step_graph.StaticRunner())
    rows = []
    with no_reads:
        for b in range(0, N, B):
            rows.append(g.block(*_block(scans[b:b + B])))
    assert g.rt.replays == N // B - 1 and len(g.rt.chains) == 1
    want = tpipe._stack(outs)
    assert _equal(_cat(rows), want)
    assert _equal(g.state, st)
    st_e, rows_e = _fresh(), []
    for b in range(0, N, B):
        st_e, r = tpipe.odometry_scan_block(st_e, *_block(scans[b:b + B]),
                                            TCFG)
        rows_e.append(r.pose.t)
    assert torch.equal(torch.cat(rows_e), want.pose.t)


def test_run_odometry_sequence_replays_one_program(eager, monkeypatch):
    """``run_odometry_sequence`` drives one ``OdometryGraph`` (here on a
    ``StaticRunner``): one chain, recorded at the first scan and replayed
    at every later one, poses bitwise to the eager body's.  The functional
    ``odometry_scan_step`` / ``_block`` keep nothing: the state given is
    not written."""
    outs, _ = eager
    runners = []

    def make_runner(device, graph=True, read_fn=None):
        runners.append(step_graph.StaticRunner(read_fn))
        return runners[-1]

    monkeypatch.setattr(step_graph, "make_runner", make_runner)
    scans = _scans()
    poses, diags = tpipe.run_odometry_sequence(scans, TCFG, device="cpu")
    assert len(runners) == 1
    rt = runners[0]
    assert len(rt.chains) == 1 and rt.replays == N - 1 and rt.reads == 0
    assert torch.equal(poses.R, torch.stack([o.pose.R for o in outs]))
    assert torch.equal(poses.t, torch.stack([o.pose.t for o in outs]))
    assert _equal(tpipe._stack(diags), tpipe._stack([o.diag for o in outs]))
    # The functional drivers: a state in, a new state out, the input
    # unwritten; nothing asks for a runner.
    start = _fresh()
    before = [t.clone() for t in leaves(start)]
    s, _ = tpipe.odometry_scan_step(start, *scans[0], TCFG)
    s, _ = tpipe.odometry_scan_step(s, *scans[1], TCFG)
    mid = [t.clone() for t in leaves(s)]
    tpipe.odometry_scan_block(s, *_block(scans[2:]), TCFG)
    tpipe.odometry_scan_block(start, *_block(scans), TCFG)
    assert all(torch.equal(a, b) for a, b in zip(leaves(start), before))
    assert all(torch.equal(a, b) for a, b in zip(leaves(s), mid))
    assert len(runners) == 1


def test_block_matches_jax_jitted_block(eager):
    """``odometry_scan_block`` through the program against the JAX
    package's jitted ``odometry_scan_block`` over the same scans."""
    scans, _ = ring_scans(N)
    g = step_graph.OdometryGraph(_fresh(), TCFG,
                                 runner=step_graph.StaticRunner())
    rows = g.block(*_block(_scans()))
    _, j_out = jpipe.odometry_scan_block(
        jpipe.odom.init_state(JCFG.odom, JCFG.feat),
        *(jnp.stack([jnp.asarray(s[j]) for s in scans]) for j in range(3)),
        JCFG)
    assert np.abs(npy(rows.pose.t) - np.asarray(j_out.pose.t)).max() < 1e-3
    poses, diags = tpipe.run_odometry_sequence(scans, TCFG, device="cpu")
    assert len(diags) == N and torch.equal(poses.t, rows.pose.t)
