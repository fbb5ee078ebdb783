"""The per-scan step's body (``pipeline.step_body``) on the CPU: no host read
but its decisions, and the static-buffer path of ``models/step_graph.py``
(``StaticRunner``: the CUDA graph runner's dataflow, each segment run again
as a plain call) against the eager body and the JAX package.

A ``TorchDispatchMode`` around one step of each variant (plain, mapping,
bootstrap, IMU, a loop attempt) raises on the ops that read back to the
host or bring fresh host data into the body — ``nonzero``,
``masked_select``, a bool index, ``lift_fresh``, and the library ``eigh``
and ``svd`` whose error checks read back — and counts
``_local_scalar_dense``.  The count must equal the runner's own reads: 0 on
a non-mapping step, 1 on a mapping step (the submap branch), and on a loop
attempt one a chunk of ICP or CG iterations plus one for the acceptance.
The plain versions of kernels K1 and K3 run only on the CPU and may read
(K1's sweep loop, K3's empty-query shortcut); on the card they are kernels.

Tolerances: the static path equals the eager body bitwise; against the JAX
package's ``slam_scan_step``, fused positions to 1e-3 m and equal keyframe
counts (``tests/test_torch_pipeline.py``'s).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from legoloam_tpu_torch.models import pipeline as tpipe
from legoloam_tpu_torch.models import step_graph
from legoloam_tpu_torch.ops import ccl_cuda, deskew, knn_cuda
from legoloam_tpu_torch.ops.segments import leaves, map_tree
from legoloam_tpu_torch.utils import synthetic

from _torch_parity import TCFG, jax_run, npy, ring_scans

N = 9
aten = torch.ops.aten
# Loop closure on, with a time gap and radius that let the ring's own
# recent keyframes be candidates, so an attempt closes within 9 scans.
LOOP_CFG = TCFG.replace(loop=dataclasses.replace(
    TCFG.loop, enabled=True, min_time_gap=0.3, search_radius=20.0))
FORBIDDEN = {aten.nonzero, aten.masked_select, aten.lift_fresh,
             aten.lift_fresh_copy, aten._linalg_eigh, aten.linalg_eigh,
             aten._linalg_svd, aten.linalg_svd, aten.repeat_interleave,
             aten.unique_consecutive, aten._unique2}
INDEXING = {aten.index, aten.index_put, aten.index_put_,
            aten._index_put_impl_}


class HostReads(TorchDispatchMode):
    """Counts host reads; raises on the ops the step body must not run.
    ``plain`` > 0 while a kernel's plain version runs."""

    def __init__(self):
        super().__init__()
        self.reads = 0
        self.plain = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.plain:
            packet = func.overloadpacket
            if func is aten._local_scalar_dense.default:
                self.reads += 1
            elif packet in FORBIDDEN:
                raise AssertionError(f"{func} inside the step body")
            elif packet in INDEXING and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in (args[1] if len(args) > 1 else ()) or ()):
                raise AssertionError(f"{func} with a bool index")
        return func(*args, **kwargs)


@pytest.fixture
def mode(monkeypatch):
    m = HostReads()

    def plain(fn):
        def run(*a, **k):
            m.plain += 1
            try:
                return fn(*a, **k)
            finally:
                m.plain -= 1
        return run

    monkeypatch.setattr(ccl_cuda, "label_propagation_plain",
                        plain(ccl_cuda.label_propagation_plain))
    monkeypatch.setattr(knn_cuda, "knn_plain", plain(knn_cuda.knn_plain))
    return m


def _scans():
    scans, _ = ring_scans(N)
    return [tuple(torch.from_numpy(np.array(a)) for a in s) for s in scans]


def _integral():
    """The port's integral of synthetic IMU samples along the ring."""
    poses = synthetic.circle_trajectory(N + 1, radius=20.0,
                                        angular_rate=0.0075)
    ts, rpy, acc, gyro = synthetic.make_imu(poses)
    return deskew.integrate_imu(deskew.ImuWindow(
        ts, rpy, acc, gyro, torch.ones(ts.shape[0], dtype=torch.bool)))


def _run(runner, cfg=TCFG, n=N):
    """``n`` ring scans through a StepGraph on ``runner`` (None: eager):
    (fused positions, the StepGraph, a copy of the state after scan 5)."""
    sg = step_graph.StepGraph(tpipe.init_slam_state(cfg, "cpu"), cfg,
                              runner=runner)
    fused, mid = [], None
    for k, scan in enumerate(_scans()[:n]):
        out = sg.step(*scan, k * cfg.sensor.scan_period,
                      run_mapping=(k % cfg.mapping_every == 0),
                      bootstrap=(k == 1))
        fused.append(out.fused_pose.t)
        if k == 5:
            mid = map_tree(lambda t: t.clone(), sg.state)
    return torch.stack(fused), sg, mid


@pytest.fixture(scope="module")
def eager():
    return _run(None)


def test_static_path_matches_eager_and_jax(eager):
    fused, sg, _ = eager
    s_fused, ssg, _ = _run(step_graph.StaticRunner())
    assert torch.equal(s_fused, fused)
    assert all(torch.equal(a, b) for a, b in zip(leaves(ssg.state),
                                                  leaves(sg.state)))
    # One read a mapping step (scans 0, 3, 6), none on the others.
    assert ssg.reads == sg.reads == 3
    states, j_fused = jax_run(N)
    assert np.abs(npy(s_fused) - j_fused).max() < 1e-3
    assert int(ssg.state.mapping.kf.count) \
        == int(states[-1].mapping.kf.count) >= 2


# (run_mapping, run_loop, bootstrap, imu) of one step after scan 5, and the
# host reads it may make (None: a loop attempt's, counted by the runner).
VARIANTS = {
    "plain": (False, False, False, False, 0),
    "mapping": (True, False, False, False, 1),
    "bootstrap": (False, False, True, False, 0),
    "imu": (True, False, False, True, 1),
    "loop": (True, True, False, False, None),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_body_reads_only_its_decisions(eager, mode, variant):
    run_mapping, run_loop, bootstrap, imu, want = VARIANTS[variant]
    cfg = LOOP_CFG if run_loop else TCFG
    scan = _scans()[6]
    integ = _integral() if imu else None
    runs = []
    for runner in (step_graph.StaticRunner(), None):
        sg = step_graph.StepGraph(map_tree(lambda t: t.clone(), eager[2]),
                                  cfg, runner=runner)
        with mode if runner is not None else contextlib.nullcontext():
            before = mode.reads
            out = sg.step(*scan, 0.6, run_mapping=run_mapping,
                          run_loop=run_loop, imu_integral=integ,
                          bootstrap=bootstrap)
        runs.append((sg, out))
        if runner is not None:
            assert mode.reads - before == sg.reads
    (ssg, sout), (esg, eout) = runs
    if want is not None:
        assert ssg.reads == want
    else:
        # The ICP's chunks, the acceptance, and 8 GN steps of CG chunks.
        assert ssg.reads >= 2 + cfg.posegraph.gn_iters
        assert int(ssg.state.loops.count) == 1
    assert ssg.reads == esg.reads
    assert torch.equal(sout.fused_pose.t, eout.fused_pose.t)
    assert all(torch.equal(a, b) for a, b in zip(leaves(ssg.state),
                                                  leaves(esg.state)))


def test_static_runner_refuses_arguments_outside_static_buffers():
    """A segment may take an adopted buffer, a segment's result or a view
    of either; a tensor computed eagerly between segments (which, replayed,
    would read a result the deferred chain has not written yet) raises."""
    rt = step_graph.StaticRunner()
    x = rt.adopt(torch.arange(4.0))
    y = rt.seg(("t", "double"), lambda a: a * 2, x)
    rt.seg(("t", "head"), lambda a: a + 1, y[:2])
    with pytest.raises(ValueError, match="outside the static buffers"):
        rt.seg(("t", "stray"), lambda a: a - 1, y + 1)
