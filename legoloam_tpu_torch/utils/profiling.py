"""The port's tracer: host spans, device intervals and counters of its
programs' steps (``models/step_graph.py``), on the clock that
``torch.profiler`` stamps its host events with.

It is on while a ``torch.profiler`` session records (checked once a step)
and inside ``tracing()``; off, a step makes that one check and records
nothing: no span, no CUDA event, no ``record_function``.

A traced step records these spans, each with its parent span and the
step's id (the program's scan number, shared by every span of the step):

  * ``slam.step``: one a ``step`` / ``block`` / call of a program (the
    mapping ones are counted).  Its self time is the Python walk of the
    step's segments;
  * ``slam.inputs``: the copy of the inputs into the static buffers;
  * ``slam.replay <chain>``: the host time in ``graph.replay()``;
  * ``slam.read <what>``: the host blocked in a read (after the flush,
    whose replay is its own span);
  * ``slam.capture <chain>``: the capture of a chain;
  * ``slam.outputs``: the copy of the outputs out of the static buffers.

A chain is named by the heads of its segments' keys, joined with ``+``
(``front+fuse``, ``submap+mapping+fuse``, ``odometry``).  Each replay on
the card records three timing events: one on the stream before the
launch, one on an idle side stream when the launch returns (it runs at
once), and one on the stream after the graph.  The chain's work starts at
the later of the first two: behind the stream's earlier work, or at the
launch's end when the host was late.  Its device span runs from there to
the third; the device's gap before it from the previous chain's third
event, clamped at 0 (the host late with the launch, the launch included).
The events are read by a non-blocking ``query()`` at later steps or by
one synchronise in ``summary()``, never by a synchronise inside a step.

Counters: replays, reads, graph nodes launched (a chain's count is taken
at its capture), the odometry's LM iterations used (``diag``'s
``surf_iters + corner_iters``, read only in the summary) against those
run (``2 * max_iterations`` a scan), and what the step's code tallies on
its runner (``segments.Eager.tally``): a loop attempt's
``loop_attempts``, ``loops_closed`` (each a pose-graph re-solve) and
``icp_iters``, and the re-solve's GN steps' ``cg_iters``, the iteration
counts kept as tensors and summed only in the summary.  A loop attempt's
chains are named by their heads as any other (``loop+loop icp``,
``loop icp``, ``loop icp+loop``, ``loop+fuse``, ``pg``, ``pg+loop+fuse``).

Aggregates cover the whole traced period, spans outside a step (the CLI's
stages) included; raw spans those of the last ``MAX_STEPS`` steps.
``summary()`` returns both, ``reset()`` clears them.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from collections import deque
from typing import NamedTuple

import torch
from torch.autograd.profiler import record_function

MAX_STEPS = 1000     # steps whose raw spans are kept
LM_FOLD = 1024       # iteration counts kept before they are summed

_profiler_on = torch._C._autograd._profiler_enabled
now_ns = time.time_ns   # the clock of torch.profiler's host events


class Span(NamedTuple):
    sid: int             # the span's id
    name: str
    start_ns: int
    end_ns: int
    parent: int | None   # the enclosing span's id
    step: int            # the step's id (its first scan)


class _Open:
    """A span being recorded (a context manager)."""

    __slots__ = ("tr", "name", "child", "sid", "t0", "rf")

    def __init__(self, tr, name: str, child: bool):
        self.tr, self.name, self.child = tr, name, child

    def __enter__(self):
        # Stamped before the record opens and before it closes: the
        # profiler stamps its event at the start of each call.
        tr = self.tr
        tr._sid += 1
        self.sid = tr._sid
        tr._stack.append(self)
        self.t0 = now_ns()
        self.rf = None
        if _profiler_on():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        t1 = now_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.tr._close(self, t1)
        return False


class _NoSpan:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOSPAN = _NoSpan()


class _Chain:
    __slots__ = ("replays", "nodes", "launch_ns", "device_ms", "gap_ms")

    def __init__(self, nodes: int):
        self.replays, self.nodes, self.launch_ns = 0, nodes, 0
        self.device_ms: list = []
        self.gap_ms = 0.0


class Tracer:
    """Spans, device intervals and counters of traced steps (one thread).
    The module keeps one, ``TRACER``."""

    def __init__(self):
        self.pool: list = []     # timing events free for reuse
        self.side: dict = {}     # device -> a stream only the tracer uses
        self.reset()

    def reset(self) -> None:
        """Forget everything recorded (events in flight are dropped)."""
        self.steps = self.scans = self.mapping_scans = 0
        self.replays = self.reads = self.nodes = 0
        self.step_ns = self.step_self_ns = 0
        self.spans: dict = {}        # name -> [count, ns]
        self.chains: dict = {}       # name -> _Chain
        self.gap_ms, self.gaps = 0.0, 0
        self.lm_run = 0
        self._lm: list = []          # iteration count tensors
        self._tallies: dict = {}     # name -> [host int, tensors]
        self.raw: deque = deque(maxlen=MAX_STEPS)   # a step's Spans
        self._pending: deque = deque()   # replays whose events are unread
        self._prev = None            # the last read chain's after-event
        self._link = False           # the next chain follows the last one
        self._last = None            # (program, its next scan), last step
        self._stack: list = []       # open spans
        self._steps: list = []       # open: [id, child ns, program,
        #                              scans, mapping, its Spans]
        self._sid = 0
        self._last_ns = 0            # the last closed span's length
        self._profiled = False       # the last step ran under a profiler

    # -- spans ---------------------------------------------------------

    def span(self, name: str, child: bool = False) -> _Open:
        """A span over a ``with`` block; ``child``: its time is taken out
        of the step's self time (replays and reads)."""
        return _Open(self, name, child)

    def _close(self, s: _Open, t1: int) -> None:
        st = self._stack
        while st and st[-1] is not s:     # left open by an exception
            st.pop()
        st.pop()
        step = self._steps[-1] if self._steps else None
        ns = t1 - s.t0
        agg = self.spans.get(s.name)
        if agg is None:
            agg = self.spans[s.name] = [0, 0]
        agg[0] += 1
        agg[1] += ns
        if step is not None:
            if s.child:
                step[1] += ns
            step[5].append(Span(s.sid, s.name, s.t0, t1,
                                st[-1].sid if st else None, step[0]))
        self._last_ns = ns

    # -- steps ---------------------------------------------------------

    def begin(self, program, seq: int, scans: int, mapping: bool,
              device) -> _Open:
        """Open step ``seq`` (the program's scan number) of ``scans``
        scans; returns its open ``slam.step`` span."""
        if self._last != (id(program), seq):
            self._link = False
        on = _profiler_on()
        if on and not self._profiled:
            # A profiler session's first record on a thread sets the thread
            # up around its stamp (0.1-2 ms): a record of its own takes
            # that, so the spans' stamps stay within us of the profiler's.
            with record_function("slam.tracer"):
                pass
        self._profiled = on
        if device.type == "cuda":
            self._poll(block=False)
        spans: list = []
        self.raw.append(spans)
        self._steps.append([seq, 0, program, scans, mapping, spans])
        root = self.span("slam.step")
        root.__enter__()
        return root

    def end(self, root: _Open, diag=None, lm_run: int = 0) -> None:
        """Close the step opened by ``begin``; ``diag`` (an
        ``OdometryDiag`` of the returned outputs) and ``lm_run``, the LM
        iterations the step ran, count the LM's use."""
        t1 = now_ns()
        if root.rf is not None:
            root.rf.__exit__(None, None, None)
        seq, _, program, scans, mapping = self._steps[-1][:5]
        self._close(root, t1)
        sub = self._steps.pop()[1]
        ns = self._last_ns
        self.steps += 1
        self.scans += scans
        self.mapping_scans += int(mapping)
        self.step_ns += ns
        self.step_self_ns += ns - sub
        self._last = (id(program), seq + scans)
        if diag is not None:
            self._lm += [diag.surf_iters, diag.corner_iters]
            self.lm_run += lm_run
            if len(self._lm) >= 2 * LM_FOLD:
                self._lm = [torch.cat([t.reshape(-1).long()
                                       for t in self._lm]).sum()]

    # -- replays and reads ---------------------------------------------

    def replay(self, name: str, nodes: int, run, stream) -> None:
        """``run()`` replays chain ``name`` of ``nodes`` graph nodes;
        ``stream``: the card's stream it runs on (None on the CPU)."""
        ev0 = None
        if stream is not None:
            ev0 = self._event()
            ev0.record(stream)
        with self.span("slam.replay " + name, child=True):
            run()
        ns = self._last_ns
        c = self.chains.get(name)
        if c is None:
            c = self.chains[name] = _Chain(nodes)
        c.replays += 1
        c.launch_ns += ns
        self.replays += 1
        self.nodes += nodes
        if stream is not None:
            launched = self._event()
            launched.record(self._side(stream.device))
            ev1 = self._event()
            ev1.record(stream)
            self._pending.append((name, ev0, launched, ev1, self._link,
                                  stream.device))
            self._link = True

    def read(self, what: str) -> _Open:
        """The span of a host read of ``what``."""
        self.reads += 1
        return self.span("slam.read " + what, child=True)

    def tally(self, name: str, x) -> None:
        """Add ``x`` (an int, or a 0-d integer tensor of the tracer's own,
        which no later step writes) to the tally ``name``."""
        t = self._tallies.get(name)
        if t is None:
            t = self._tallies[name] = [0, []]
        if not isinstance(x, torch.Tensor):
            t[0] += x
            return
        t[1].append(x)
        if len(t[1]) >= LM_FOLD:
            t[1] = [torch.stack(t[1]).sum()]

    # -- device events -------------------------------------------------

    def _event(self):
        return self.pool.pop() if self.pool else torch.cuda.Event(
            enable_timing=True)

    def _side(self, device):
        """The tracer's own stream of ``device``: idle, so an event
        recorded there runs when the host records it."""
        st = self.side.get(device)
        if st is None:
            st = self.side[device] = torch.cuda.Stream(device)
        return st

    def _poll(self, block: bool) -> None:
        """Read the replays whose events have all run, in order; ``block``:
        all of them (the card synchronised)."""
        q = self._pending
        while q:
            name, ev0, launched, ev1, link, _ = q[0]
            if not block and not (ev1.query() and launched.query()):
                return
            q.popleft()
            start = launched if ev0.elapsed_time(launched) > 0 else ev0
            ms = start.elapsed_time(ev1)
            gap = 0.0
            prev = self._prev
            if prev is not None:
                if link:
                    gap = max(prev.elapsed_time(start), 0.0)
                    self.gap_ms += gap
                    self.gaps += 1
                self.pool.append(prev)
            self._prev = ev1
            c = self.chains[name]
            c.device_ms.append(ms)
            c.gap_ms += gap
            self.pool += [ev0, launched]

    # -- the summary ---------------------------------------------------

    def summary(self) -> dict:
        """Every aggregate and the raw spans (synchronises the devices
        whose events are unread)."""
        for dev in {p[5] for p in self._pending}:
            torch.cuda.synchronize(dev)
        self._poll(block=True)
        lm_used = int(torch.cat([t.reshape(-1).long() for t in self._lm])
                      .sum()) if self._lm else 0
        return {
            "steps": self.steps, "scans": self.scans,
            "mapping_scans": self.mapping_scans,
            "replays": self.replays, "reads": self.reads,
            "nodes": self.nodes,
            "step_ms": self.step_ns * 1e-6,
            "step_host_ms": self.step_self_ns * 1e-6,
            "spans": {n: {"count": c, "ms": ns * 1e-6}
                      for n, (c, ns) in self.spans.items()},
            "chains": {n: {"replays": c.replays, "nodes": c.nodes,
                           "launch_ms": c.launch_ns * 1e-6,
                           "device_ms": list(c.device_ms),
                           "gap_ms": c.gap_ms}
                       for n, c in self.chains.items()},
            "gap_ms": self.gap_ms, "gaps": self.gaps,
            "lm_used": lm_used, "lm_run": self.lm_run,
            "tallies": {n: c + (int(torch.stack(ts).sum()) if ts else 0)
                        for n, (c, ts) in self._tallies.items()},
            "raw": [sp for step in self.raw for sp in step],
        }


TRACER = Tracer()
_forced = 0


def active() -> Tracer | None:
    """The tracer while tracing is on (a ``tracing()`` block, or a
    ``torch.profiler`` session recording), else None: a step's one
    check."""
    if _forced or _profiler_on():
        return TRACER
    return None


def span(tr: Tracer | None, name: str):
    """``tr``'s span ``name``, or a no-op when ``tr`` is None."""
    return NOSPAN if tr is None else tr.span(name)


@contextlib.contextmanager
def tracing():
    """Trace every step inside the block (no profiler needed); yields the
    tracer."""
    global _forced
    _forced += 1
    try:
        yield TRACER
    finally:
        _forced -= 1


def summary() -> dict:
    """The tracer's summary (``Tracer.summary``)."""
    return TRACER.summary()


def reset() -> None:
    TRACER.reset()


def report(s: dict) -> list:
    """Lines for a summary: per chain its replays, graph nodes, launch ms,
    median device ms and the device's gap before it; the reads; the LM's
    iterations; every span name's time."""
    n = max(s["scans"], 1)
    lines = [f"traced: {s['steps']} steps, {s['scans']} scans "
             f"({s['mapping_scans']} mapping), {s['replays']} replays, "
             f"{s['reads']} reads, {s['nodes']} graph nodes "
             f"({s['nodes'] / n:.1f} a scan)",
             f"step host ms a scan {s['step_host_ms'] / n:.3f} (slam.step "
             "less its replays and reads), device gap ms a scan "
             f"{s['gap_ms'] / n:.3f} ({s['gaps']} gaps)",
             f"{'chain':32s} {'replays':>8s} {'nodes':>7s} "
             f"{'launch ms':>10s} {'device ms':>10s} {'gap ms':>8s}"]
    if not s["chains"]:
        lines.append("  (none: no graph was replayed)")
    for name, c in sorted(s["chains"].items()):
        r = max(c["replays"], 1)
        dev = f"{statistics.median(c['device_ms']):10.3f}" \
            if c["device_ms"] else f"{'-':>10s}"
        lines.append(f"{name:32s} {c['replays']:8d} {c['nodes']:7d} "
                     f"{c['launch_ms'] / r:10.3f} {dev} "
                     f"{c['gap_ms'] / r:8.3f}")
    for name, sp in sorted(s["spans"].items()):
        if name.startswith("slam.read "):
            lines.append(f"read {name[10:]}: {sp['count']} x "
                         f"{sp['ms'] / sp['count']:.3f} ms")
    if s["tallies"]:
        lines.append("tallied: " + ", ".join(
            f"{n} {v}" for n, v in sorted(s["tallies"].items())))
    if s["lm_run"]:
        lines.append(f"odometry LM iterations used {s['lm_used']} of "
                     f"{s['lm_run']} run "
                     f"({100.0 * s['lm_used'] / s['lm_run']:.1f}%)")
    for name in sorted(s["spans"], key=lambda k: -s["spans"][k]["ms"]):
        sp = s["spans"][name]
        lines.append(f"{name:28s} {sp['ms'] * 1e-3:8.3f}s total  "
                     f"{sp['count']:6d}x  {sp['ms'] / sp['count']:8.2f} "
                     "ms avg")
    return lines
