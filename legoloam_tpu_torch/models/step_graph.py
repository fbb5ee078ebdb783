"""The per-scan SLAM step as captured CUDA graphs: the port's counterpart of
the JAX package's compiled ``slam_scan_step`` (``jax.jit`` with the statics
``cfg``, ``run_loop``, ``bootstrap``; ``legoloam_tpu/models/pipeline.py``).

``StepGraph`` owns a static SLAM state and static input buffers and runs
``pipeline.step_body`` through a runner whose segments are CUDA graphs:

  * each segment is captured the first time it runs, keyed like the JAX
    statics — (run_mapping, run_loop, bootstrap, imu), and the submap
    branch for the mapping segments.  That first run is the step's real
    work, done eagerly on the capture stream (the warm-up: it builds the
    kernel library and sets the kernels' attributes); the capture follows
    and every later occurrence replays.  All graphs share one memory pool.
  * every value that crosses a segment boundary lives in a buffer made
    outside the pool (the state, the inputs, each segment's result), so
    the graphs can run in any order; only temporaries live in the pool.
  * the host reads are ``rt.read``'s: the submap branch once a mapping
    step, a loop attempt's stop flag once a chunk of ICP or CG iterations
    and its acceptance once.  A non-mapping step reads nothing.

The keyframe store stays the one in-place buffer: the mapping segment
writes a keyframe's row into it, and nothing copies it a step.  A replay
counts the kernel launches its capture recorded (``ops/_native.py``).

On the CPU, on a mesh (``parallel.pipeline_dist.MeshBackend``: its
collectives cannot be captured) and with ``graph=False`` the same body runs
eagerly.  On the card with the single-device backend a failed capture or
replay raises; nothing falls back to the eager body.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import PipelineConfig
from ..ops import _native
from ..ops.segments import Eager, bind, copy_tree, leaves, map_tree
from . import pipeline
from .pipeline import SINGLE, Backend, SlamOutput


@dataclass
class _Seg:
    out: object                        # the static result tree
    ptrs: tuple                        # the argument buffers it reads
    graph: torch.cuda.CUDAGraph | None = None
    launches: dict | None = None       # kernel launches a replay makes


class StaticRunner(Eager):
    """Segments over static buffers, each run again as a plain call: the
    graph runner's dataflow on any device (the CPU tests drive it).  A
    segment's first run binds its result buffers; a later run must read
    the same argument buffers and writes its result into them."""

    def __init__(self):
        super().__init__()
        self.segs: dict = {}

    def seg(self, key, fn, *args, into=None):
        ptrs = tuple(t.data_ptr() for t in leaves(args))
        s = self.segs.get(key)
        if s is None:
            s = self.segs[key] = self._first(key, fn, args, into, ptrs)
            return s.out
        if s.ptrs != ptrs:
            raise RuntimeError(f"segment {key}: its arguments are not the "
                               "buffers it first ran with")
        self._again(s, fn, args)
        return s.out

    def _first(self, key, fn, args, into, ptrs) -> _Seg:
        out = fn(*args)
        static = bind(into, out)
        copy_tree(static, out)
        return _Seg(static, ptrs)

    def _again(self, s: _Seg, fn, args) -> None:
        copy_tree(s.out, fn(*args))


class GraphRunner(StaticRunner):
    """Segments as CUDA graphs over static buffers: the first run is the
    eager warm-up on the capture stream, then the capture; later runs
    replay (see the module docstring)."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.replays = 0

    def _first(self, key, fn, args, into, ptrs) -> _Seg:
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            s = super()._first(key, fn, args, into, ptrs)
        torch.cuda.synchronize(self.device)
        before = _native.counts()
        s.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(s.graph, pool=self.pool,
                                  stream=self.stream):
                copy_tree(s.out, fn(*args))
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of segment {key} "
                               f"failed: {e}") from e
        after = _native.counts()
        s.launches = {n: after[n] - before[n] for n in after
                      if after[n] != before[n]}
        _native.add_counts({n: -c for n, c in s.launches.items()})
        return s

    def _again(self, s: _Seg, fn, args) -> None:
        s.graph.replay()
        _native.add_counts(s.launches)
        self.replays += 1


class StepGraph:
    """The per-scan step over a static state: ``step`` runs one scan,
    ``state`` is the state (its buffers are reused by the next step: copy
    what must outlive it), ``load`` copies a state in (a resumed
    checkpoint, a decimated store, a relocalized state).

    ``graph``: replay captured CUDA graphs on the card with the
    single-device backend (``False`` runs the eager body there, the
    reference that ``chip_smoke.py`` holds the graphs against).  The
    state given is adopted, not copied."""

    def __init__(self, state, cfg: PipelineConfig, backend: Backend = SINGLE,
                 graph: bool = True, runner: StaticRunner | None = None):
        self.cfg = cfg
        self.backend = backend
        self.device = state.odom.xi.device
        # ``runner``: a ``StaticRunner`` to drive the static-buffer path
        # where there is no card (the CPU tests).
        self.captured = runner is not None or bool(
            graph and self.device.type == "cuda" and backend.capturable)
        if runner is not None:
            self.rt = runner
        elif self.captured:
            self.rt = GraphRunner(self.device)
        else:
            self.rt = Eager()
        self._state = state
        self._inputs = None
        self._imu = None

    @property
    def state(self):
        return self._state

    @property
    def reads(self) -> int:
        """Host reads so far (the submap branch, a loop attempt's)."""
        return self.rt.reads

    def load(self, state) -> None:
        """Make ``state`` the step's state (copied into the static
        buffers when the step is captured)."""
        if self.captured:
            copy_tree(self._state, state)
        else:
            self._state = state

    def step(self, points, valid, ring, scan_time, run_mapping: bool,
             run_loop: bool = False, imu_integral=None,
             bootstrap: bool = False) -> SlamOutput:
        """One scan (``pipeline.slam_scan_step``'s arguments); returns
        its outputs, which later steps do not overwrite."""
        if not self.captured:
            self._state, out = pipeline.slam_scan_step(
                self._state, points, valid, ring, self.cfg, scan_time,
                run_mapping, run_loop, imu_integral, bootstrap, self.backend,
                rt=self.rt)
            return out
        dev = self.device
        inputs = tuple(torch.as_tensor(a, device=dev)
                       for a in (points, valid, ring))
        if self._inputs is None:
            self._inputs = tuple(a.clone() for a in inputs) + (
                torch.zeros((), device=dev),)
        else:
            copy_tree(self._inputs[:3], inputs)
        self._inputs[3].fill_(float(scan_time))
        if imu_integral is not None:
            imu_integral = pipeline._on(imu_integral, dev)
            if self._imu is None:
                self._imu = map_tree(lambda t: t.clone(), imu_integral)
            else:
                copy_tree(self._imu, imu_integral)
            imu_integral = self._imu
        state, out = pipeline.step_body(
            self._state, *self._inputs, self.cfg, run_mapping, run_loop,
            imu_integral, bootstrap, self.backend, rt=self.rt)
        assert all(a is b for a, b in zip(leaves(state), leaves(self._state)))
        return map_tree(lambda x: x.clone(), out)
