"""The per-scan SLAM step as captured CUDA graphs: the port's counterpart of
the JAX package's compiled ``slam_scan_step`` and ``slam_scan_block``
(``jax.jit`` with the statics ``cfg``, ``run_loop``, ``bootstrap`` and the
block length; ``legoloam_tpu/models/pipeline.py``), and with
``OdometryGraph`` of its compiled ``odometry_scan_step`` and
``odometry_scan_block`` (odometry alone: a scan one replay, a block of B
scans one replay, no host read), and with ``FrontendGraph`` of the
data-parallel frontend's ``jit(vmap(process_scan))`` (a batch of scans one
replay, no host read).

``StepGraph`` owns a static SLAM state and static input buffers and runs
``pipeline.step_body`` through a runner whose graphs are CUDA graphs:

  * a segment (``ops/segments.py``) is known by its key — like the JAX
    statics: (run_mapping, run_loop, bootstrap, imu), the submap branch —
    and by its argument buffers.  Its first run is real work, done eagerly
    on the capture stream (the warm-up: it builds the kernel library, sets
    the kernels' attributes, creates a communicator), and binds its result
    buffers.
  * the segments between two boundaries — a host read, a cut, the end of
    a step or a block — form a chain.  A chain seen for the first time
    runs eagerly and is captured as ONE graph at its end; every later
    time it is deferred to its end and replayed.  So a non-mapping step
    is one replay, a mapping step two (the submap branch is read between
    them), and a block of B scans without a loop attempt two: scan 0's
    front, the read, then everything else.  All graphs share one memory
    pool.
  * every value that crosses a segment boundary lives in a buffer made
    outside the pool (the state, the inputs, each segment's result), so
    the graphs can run in any order; only temporaries live in the pool.
  * the host reads are ``rt.read``'s: the submap branch once a mapping
    step, a loop attempt's stop flag once a chunk of ICP or CG iterations
    and its acceptance once.  A non-mapping step reads nothing.

The keyframe store stays the one in-place buffer: the mapping segment
writes a keyframe's row into it, and nothing copies it a step.  A replay
counts the kernel launches its capture recorded (``ops/_native.py``), and
a chain keeps its name and its graph's node count for the tracer
(``utils/profiling.py``), which a program's step consults once.

On the CPU, over gloo (``parallel.pipeline_dist.MeshBackend`` is
capturable on NCCL only) and with ``graph=False`` the same body runs
eagerly.  On the card a failed capture or replay raises; nothing falls
back to the eager body.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache, partial

import torch

from ..config import PipelineConfig
from ..ops import _native
from ..ops.segments import Eager, bind, copy_tree, leaves, map_tree
from ..utils import profiling
from . import pipeline
from .pipeline import SINGLE, Backend, SlamOutput


@dataclass
class _Chain:
    graph: torch.cuda.CUDAGraph | None = None
    launches: dict | None = None       # kernel launches a replay makes
    name: str = ""                     # its segments' key heads, "+"-joined
    nodes: int = 0                     # the graph's nodes (0 on the CPU)


class StaticRunner(Eager):
    """Segments over static buffers, chained between boundaries: the
    graph runner's dataflow on any device (the CPU tests drive it).  A
    segment's first run binds its result buffers.  A chain seen for the
    first time runs segment by segment as it comes and is then "captured"
    (recorded for later; on the CPU nothing is kept); a chain that matches
    a captured one is deferred to its end and replayed there (on the CPU
    each segment run again as a plain call, writing into its buffers).

    Every argument of a segment must lie in a static buffer: one that was
    adopted (``adopt``) or a segment's result, or a view of either.  A
    tensor that eager code computed between two segments would read
    results the deferred chain has not yet written, so it raises."""

    def __init__(self, read_fn=None):
        super().__init__(read_fn)
        self.static: set = set()   # storages of the static buffers
        self.segs: dict = {}       # (key, argument pointers) -> (id, out)
        self.heads: dict = {}      # segment id -> the head of its key
        self.chains: dict = {}     # tuple of segment ids -> _Chain
        self.prefixes: set = set()  # every prefix of a captured chain
        self.replays = 0
        self._open()

    def _open(self) -> None:
        self.pending: list = []    # (id, fn, args, out) of the open chain
        self.ran = 0               # how many of them have run
        self.ids: tuple = ()

    def adopt(self, tree):
        self.static.update(_storages(tree))
        return tree

    def seg(self, key, fn, *args, into=None):
        stray = _storages(args) - self.static
        if stray:
            raise ValueError(
                f"segment {key}: {len(stray)} argument(s) outside the static "
                "buffers (adopt the state and inputs; compute inside a "
                "segment what depends on another segment's result)")
        ident = (key, tuple(t.data_ptr() for t in leaves(args)))
        s = self.segs.get(ident)
        if s is None:
            self._run_pending()
            out = self._warm(fn, args, into)
            s = self.segs[ident] = (len(self.segs), out)
            self.heads[s[0]] = str(key[0])
            self.ran += 1
        else:
            out = s[1]
            if self.ran or self.ids + (s[0],) not in self.prefixes:
                # Not (or no longer) a captured chain: run as it comes.
                self._run_pending()
                self._run(fn, args, out)
                self.ran += 1
        self.pending.append((s[0], fn, args, out))
        self.ids += (s[0],)
        return out

    def _run_pending(self) -> None:
        for _, fn, args, out in self.pending[self.ran:]:
            self._run(fn, args, out)
        self.ran = len(self.pending)

    def _run(self, fn, args, out) -> None:
        copy_tree(out, fn(*args))

    def _warm(self, fn, args, into):
        out = fn(*args)
        static = bind(into, out)
        copy_tree(static, out)
        return self.adopt(static)

    def flush(self) -> None:
        if not self.pending:
            return
        pending, ids, ran = self.pending, self.ids, self.ran
        self._open()
        chain = self.chains.get(ids)
        tr = self.tracer
        if chain is not None and not ran:
            if tr is None:
                self._replay(chain, pending)
            else:
                tr.replay(chain.name, chain.nodes,
                          partial(self._replay, chain, pending),
                          self._stream())
            return
        for _, fn, args, out in pending[ran:]:
            self._run(fn, args, out)
        if chain is None:
            name = "+".join(dict.fromkeys(self.heads[i] for i in ids))
            with profiling.span(tr, "slam.capture " + name):
                chain = self._capture(pending)
            chain.name = name
            self.chains[ids] = chain
            self.prefixes.update(ids[:i] for i in range(1, len(ids) + 1))

    def _stream(self):
        """The stream replays run on (None: no device events)."""
        return None

    def _capture(self, pending) -> _Chain:
        return _Chain()

    def _replay(self, chain: _Chain, pending) -> None:
        for _, fn, args, out in pending:
            self._run(fn, args, out)
        self.replays += 1


class GraphRunner(StaticRunner):
    """Chains of segments as CUDA graphs over static buffers: a segment's
    first run is the eager warm-up on the capture stream; a chain seen for
    the first time runs eagerly and is captured at its end, and replayed
    every later time (see the module docstring)."""

    def __init__(self, device, read_fn=None):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        super().__init__(read_fn)

    def _warm(self, fn, args, into):
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = super()._warm(fn, args, into)
        torch.cuda.synchronize(self.device)
        return out

    def _stream(self):
        return torch.cuda.current_stream(self.device)

    def _capture(self, pending) -> _Chain:
        """Record the chain (its work was just done eagerly), count its
        graph's nodes, and instantiate it."""
        torch.cuda.synchronize(self.device)
        before = _native.counts()
        chain = _Chain(graph=torch.cuda.CUDAGraph(keep_graph=True))
        try:
            with torch.cuda.stream(self.stream):
                # thread_local: a communicator's watchdog thread may query
                # its events while this thread captures.
                chain.graph.capture_begin(self.pool,
                                          capture_error_mode="thread_local")
                try:
                    for _, fn, args, out in pending:
                        copy_tree(out, fn(*args))
                finally:
                    chain.graph.capture_end()
        except Exception as e:
            names = {i: key for (key, _), (i, _) in self.segs.items()}
            raise RuntimeError(
                "CUDA graph capture of the chain "
                f"{[names[p[0]] for p in pending]} failed: {e}") from e
        after = _native.counts()
        chain.launches = {n: after[n] - before[n] for n in after
                          if after[n] != before[n]}
        _native.add_counts({n: -c for n, c in chain.launches.items()})
        chain.nodes = graph_nodes(chain.graph)
        chain.graph.instantiate()
        return chain

    def _replay(self, chain: _Chain, pending) -> None:
        chain.graph.replay()
        _native.add_counts(chain.launches)
        self.replays += 1


@lru_cache(maxsize=None)
def _cu_graph_get_nodes():
    """``cuGraphGetNodes(graph, nodes, count)`` of ``libcuda``."""
    f = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    f.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.POINTER(ctypes.c_size_t)]
    f.restype = ctypes.c_int
    return f


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of a captured graph (made with ``keep_graph=True``), by
    ``cuGraphGetNodes`` with no node array: the count alone."""
    n = ctypes.c_size_t(0)
    rc = _cu_graph_get_nodes()(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return n.value


def _storages(tree) -> set:
    """The storage addresses of a tree's non-empty tensors."""
    return {t.untyped_storage().data_ptr() for t in leaves(tree)
            if t.numel()}


def make_runner(device, graph: bool = True, read_fn=None) -> Eager:
    """The runner a program (a step, a relocalization) owns on ``device``:
    a ``GraphRunner`` on the card with ``graph``, else the eager one."""
    if graph and torch.device(device).type == "cuda":
        return GraphRunner(device, read_fn)
    return Eager(read_fn)


def _put_row(j: int, out, rows):
    """Scan ``j``'s outputs into row ``j`` of the block's output tree, in
    place."""
    for d, s in zip(leaves(rows), leaves(out), strict=True):
        d[j].copy_(s)
    return rows


class _Program:
    """A compiled program's shell: a static state adopted by the runner,
    static input buffers kept by name and shape, and a block's (B, ...)
    output rows.  ``captured``: the runner is a ``StaticRunner`` (a
    ``GraphRunner`` on the card), else the body runs eagerly.  ``scans``:
    the scans stepped so far (a step's id is its first scan's number)."""

    def __init__(self, state, device, graph: bool, runner, read_fn=None):
        self.device = device
        # ``runner``: a ``StaticRunner`` to drive the static-buffer path
        # where there is no card (the CPU tests).
        if runner is not None:
            runner.read_fn = read_fn
            self.rt = runner
        else:
            self.rt = make_runner(device, graph, read_fn)
        self.captured = isinstance(self.rt, StaticRunner)
        self._state = self.rt.adopt(state)
        self._inputs: dict = {}
        self.scans = 0

    def _traced(self, scans: int, mapping: bool, body, *args):
        """``body(tr, *args)``, a step of ``scans`` scans: ``tr`` the
        tracer when tracing is on (the one check a step makes), else None.
        A traced step is a ``slam.step`` span, and counts the LM
        iterations of the ``diag`` its outputs carry."""
        seq = self.scans
        self.scans += scans
        tr = profiling.active()
        if tr is None:
            return body(None, *args)
        root = tr.begin(self, seq, scans, mapping, self.device)
        self.rt.tracer = tr
        out = None
        try:
            out = body(tr, *args)
        finally:
            self.rt.tracer = None
            diag = getattr(out, "diag", None)
            tr.end(root, diag, 2 * self.cfg.odom.max_iterations * scans
                   if diag is not None else 0)
        return out

    @property
    def state(self):
        return self._state

    @property
    def reads(self) -> int:
        """Host reads so far."""
        return self.rt.reads

    def load(self, state) -> None:
        """Make ``state`` the program's state (copied into the static
        buffers when the program is captured)."""
        if self.captured:
            copy_tree(self._state, state)
        else:
            self._state = state

    def _static(self, name, tree):
        """``tree`` (tensors or a NamedTuple of them) copied into the
        static input buffers kept under ``name`` and its shapes."""
        key = (name, tuple(t.shape for t in leaves(tree)))
        buf = self._inputs.get(key)
        if buf is None:
            buf = self._inputs[key] = self.rt.adopt(
                map_tree(lambda t: t.clone(), tree))
        else:
            copy_tree(buf, tree)
        return buf

    def _on(self, *arrays):
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def _row(self, j: int, n: int, out, rows):
        """Scan ``j`` of ``n``'s outputs into the block's output rows (made
        at scan 0: static when captured), as a segment."""
        if rows is None:
            rows = self._inputs.get(("block out", n)) if self.captured \
                else None
            if rows is None:
                rows = map_tree(lambda t: t.new_zeros((n, *t.shape)), out)
                if self.captured:
                    self._inputs[("block out", n)] = self.rt.adopt(rows)
        return self.rt.seg(("block", "row", j, n),
                           lambda o, r, j=j: _put_row(j, o, r), out, rows,
                           into=rows)


class StepGraph(_Program):
    """The per-scan step over a static state: ``step`` runs one scan,
    ``block`` B scans, ``state`` is the state (its buffers are reused by
    the next step: copy what must outlive it), ``load`` copies a state in
    (a resumed checkpoint, a decimated store, a relocalized state).

    ``graph``: replay captured CUDA graphs on the card with a capturable
    backend (``False`` runs the eager body there, the reference that
    ``chip_smoke.py`` holds the graphs against).  The state given is
    adopted, not copied."""

    def __init__(self, state, cfg: PipelineConfig, backend: Backend = SINGLE,
                 graph: bool = True, runner: StaticRunner | None = None):
        self.cfg = cfg
        self.backend = backend
        super().__init__(state, state.odom.xi.device,
                         graph and backend.capturable, runner,
                         backend.map_hooks.read)

    def step(self, points, valid, ring, scan_time, run_mapping: bool,
             run_loop: bool = False, imu_integral=None,
             bootstrap: bool = False) -> SlamOutput:
        """One scan (``pipeline.slam_scan_step``'s arguments); returns
        its outputs, which later steps do not overwrite."""
        return self._traced(1, run_mapping, self._step, points, valid, ring,
                            scan_time, run_mapping, run_loop, imu_integral,
                            bootstrap)

    def _step(self, tr, points, valid, ring, scan_time, run_mapping,
              run_loop, imu_integral, bootstrap) -> SlamOutput:
        if not self.captured:
            points, valid, ring, scan_time, imu_integral = \
                pipeline._step_inputs(self.device, points, valid, ring,
                                      scan_time, imu_integral)
            self._state, out = pipeline.step_body(
                self._state, points, valid, ring, scan_time, self.cfg,
                run_mapping, run_loop, imu_integral, bootstrap, self.backend,
                rt=self.rt)
            return out
        with profiling.span(tr, "slam.inputs"):
            scan = self._static("scan", self._on(points, valid, ring) + (
                torch.full((), float(scan_time), device=self.device),))
            if imu_integral is not None:
                imu_integral = self._static(
                    "imu", pipeline._on(imu_integral, self.device))
        state, out = pipeline.step_body(
            self._state, *scan, self.cfg, run_mapping, run_loop,
            imu_integral, bootstrap, self.backend, rt=self.rt)
        self.rt.flush()
        assert all(a is b for a, b in zip(leaves(state), leaves(self._state)))
        with profiling.span(tr, "slam.outputs"):
            return map_tree(lambda x: x.clone(), out)

    def block(self, points, valid, ring, scan_times, run_loop: bool = False,
              imu_integrals=None, bootstrap: bool = False) -> SlamOutput:
        """B consecutive scans ((B, P, 3), (B, P), (B, P), times (B,)),
        ``pipeline.slam_scan_block``'s contract: mapping (and with
        ``run_loop`` a loop attempt) on scan 0, the bootstrap on scan 1.
        Captured, the block's inputs are static (B, ...) buffers and its
        outputs a static (B, ...) tree written row by row inside the
        graphs; returns a copy of it."""
        return self._traced(points.shape[0], True, self._block, points,
                            valid, ring, scan_times, run_loop, imu_integrals,
                            bootstrap)

    def _block(self, tr, points, valid, ring, scan_times, run_loop,
               imu_integrals, bootstrap) -> SlamOutput:
        n = points.shape[0]
        dev = self.device
        with profiling.span(tr, "slam.inputs"):
            scans = self._on(points, valid, ring) + (torch.as_tensor(
                scan_times, dtype=torch.float32, device=dev),)
            if imu_integrals is not None:
                imu_integrals = pipeline._on(imu_integrals, dev)
            if self.captured:
                scans = self._static("block", scans)
                if imu_integrals is not None:
                    imu_integrals = self._static("block imu", imu_integrals)
        rows = None
        state = self._state
        for j in range(n):
            integ = None if imu_integrals is None else type(imu_integrals)(
                *(a[j] for a in imu_integrals))
            state, out = pipeline.step_body(
                state, *(a[j] for a in scans), self.cfg, j == 0,
                run_loop and j == 0, integ, bootstrap and j == 1,
                self.backend, rt=self.rt)
            rows = self._row(j, n, out, rows)
        self.rt.flush()
        if self.captured:
            assert all(a is b for a, b in zip(leaves(state),
                                              leaves(self._state)))
        self._state = state
        with profiling.span(tr, "slam.outputs"):
            return map_tree(lambda x: x.clone(), rows)


class OdometryGraph(_Program):
    """Odometry alone (``pipeline.odometry_body``: the frontend and the
    two-step LM) over a static ``OdometryState``: the counterpart of the
    JAX package's compiled ``odometry_scan_step`` and
    ``odometry_scan_block``.  ``step`` runs one scan, ``block`` B scans;
    the body reads nothing back, so on the card a scan is one graph
    replay and a block of B scans one replay.  The last clouds, which the
    next scan's class-NN reads, stay in the static state: nothing is
    copied a scan but the inputs into their static buffers and the
    outputs out of theirs.  ``state`` and ``load`` as ``StepGraph``'s;
    ``graph=False`` runs the eager body on the card."""

    def __init__(self, state, cfg: PipelineConfig, graph: bool = True,
                 runner: StaticRunner | None = None):
        self.cfg = cfg
        super().__init__(state, state.xi.device, graph, runner)

    def step(self, points, valid, ring) -> pipeline.OdometryOutput:
        """One scan; returns its outputs, which later scans do not
        overwrite."""
        return self._traced(1, False, self._step, points, valid, ring)

    def _step(self, tr, points, valid, ring) -> pipeline.OdometryOutput:
        with profiling.span(tr, "slam.inputs"):
            scan = self._on(points, valid, ring)
            if self.captured:
                scan = self._static("scan", scan)
        state, out = pipeline.odometry_body(self._state, *scan, self.cfg,
                                            rt=self.rt)
        self.rt.flush()
        if not self.captured:
            self._state = state
            return out
        with profiling.span(tr, "slam.outputs"):
            return map_tree(lambda x: x.clone(), out)

    def block(self, points, valid, ring) -> pipeline.OdometryOutput:
        """B consecutive scans ((B, P, 3), (B, P), (B, P)): B bodies in
        order, outputs stacked on a leading axis (a copy of the static
        rows when captured)."""
        return self._traced(points.shape[0], False, self._block, points,
                            valid, ring)

    def _block(self, tr, points, valid, ring) -> pipeline.OdometryOutput:
        n = points.shape[0]
        with profiling.span(tr, "slam.inputs"):
            scans = self._on(points, valid, ring)
            if self.captured:
                scans = self._static("block", scans)
        rows = None
        state = self._state
        for j in range(n):
            state, out = pipeline.odometry_body(
                state, *(a[j] for a in scans), self.cfg, rt=self.rt)
            rows = self._row(j, n, out, rows)
        self.rt.flush()
        self._state = state
        if not self.captured:
            return rows
        with profiling.span(tr, "slam.outputs"):
            return map_tree(lambda x: x.clone(), rows)


class FrontendGraph(_Program):
    """The frontend of a batch of scans (``pipeline.process_scans``) as one
    program: the counterpart of the JAX package's ``jit(vmap(
    process_scan))`` (``parallel/frontend_dp.py``).  A call copies the batch
    into static (B, P, ...) buffers and runs the body as one segment; on
    the card its first call with a batch shape runs eagerly (the warm-up,
    which also makes every ``device.const``) and is captured, and every
    later call with that shape is one graph replay with no host read.  A
    graph is kept for each batch shape seen.  The CPU runs it eagerly."""

    def __init__(self, cfg: PipelineConfig, device,
                 runner: StaticRunner | None = None):
        self.cfg = cfg
        super().__init__(None, torch.device(device), True, runner)

    def __call__(self, points, valid, ring) -> pipeline.ScanFeatures:
        """(B, P, 3), (B, P), (B, P) -> ``ScanFeatures`` with a leading
        (B,), which later calls do not overwrite."""
        return self._traced(points.shape[0], False, self._call, points,
                            valid, ring)

    def _call(self, tr, points, valid, ring) -> pipeline.ScanFeatures:
        if not self.captured:
            return pipeline.process_scans(*self._on(points, valid, ring),
                                          self.cfg)
        with profiling.span(tr, "slam.inputs"):
            scans = self._static("scans", self._on(points, valid, ring))
        out = self.rt.seg(("frontend",),
                          partial(pipeline.process_scans, cfg=self.cfg),
                          *scans)
        self.rt.flush()
        with profiling.span(tr, "slam.outputs"):
            return map_tree(lambda x: x.clone(), out)
