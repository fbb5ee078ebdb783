"""The loops that drive the system under test.

The program is a kind's ``Program`` (``programs/<kind>.py``, found by the
mix's ``program``; ``harness`` lists its members): it wraps the port's
step and owns its state, and nothing else of the benchmark touches
``legoloam_tpu_torch``.  A window keeps the delta of each of its
``counters()`` in ``Record.counts`` (``captures`` in ``Record.captures``).
A driver runs it over the scan stream for the measured window:

  * ``closed``: the next scan goes in as soon as the step call returns
    (offline map building, or a replay as fast as it goes);
  * ``open``: a scan is due every ``1 / rate_hz`` seconds, the step starts
    when it is due (or when the previous one finished, if later), and the
    scan's fused pose is copied to the host (a vehicle localising online).

Both stop the clock (the card synchronised) while the harness stages
scans, takes a snapshot of the state for the check, or starts and stops
the profiler: ray-casting stands in for the sensor, and the rest is the
benchmark's own work.  In a traced run the step calls before the profiled
scans are timed one by one with the card synchronised around each.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

# The output whose arrival on the host ends a scan's latency in the open
# loop (``pose_latency_p95_ms``).
HOST_POSE = "fused_pose"


def warm_scans(cfg) -> int:
    """Scans from a fresh map to past the submap cache's first skip (the
    young map folds every keyframe until it holds 2 batches, about one
    keyframe a mapping step, then 4 more mapping steps): every branch of
    the step is captured by then.  A frozen copy of the port's
    ``bench._warm_scans``."""
    return (2 * max(cfg.mapping.submap_merge_batch, 1) + 4) \
        * cfg.mapping_every


def flatten(tree, prefix: str = "") -> dict:
    """{dotted field path: tensor} of a NamedTuple tree of tensors."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if tree is None:
        return {}
    out = {}
    for name in tree._fields:
        out.update(flatten(getattr(tree, name),
                           f"{prefix}.{name}" if prefix else name))
    return out


class Clock:
    """Seconds that leave out the harness's pauses; pausing and resuming
    synchronise the card, so the work before a pause is counted."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.offset = 0.0
        self.paused_at = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def now(self) -> float:
        return time.perf_counter() - self.offset

    def pause(self) -> None:
        self.sync()
        self.paused_at = time.perf_counter()

    def resume(self) -> None:
        self.sync()
        self.offset += time.perf_counter() - self.paused_at
        self.paused_at = None


@dataclass
class Plan:
    """What the check needs from the window: the scans whose outputs are
    kept, and the scans before and after which the state is copied to the
    host.  Segment i covers scans [k0, k0 + n); the first starts at scan 0
    from the empty state."""

    segments: list

    @property
    def kept(self) -> set:
        return {k for k0, n in self.segments for k in range(k0, k0 + n)}

    @property
    def before(self) -> set:
        return {k0 for k0, _ in self.segments if k0 > 0}

    @property
    def after(self) -> set:
        return {k0 + n - 1 for k0, n in self.segments}

    @property
    def end(self) -> int:
        return max(k0 + n for k0, n in self.segments)


@dataclass
class Record:
    """What a window left for the check and the metrics."""

    scans: int = 0                 # scans stepped inside the window
    window_s: float = 0.0          # the window's seconds, pauses left out
    counts: dict = field(default_factory=dict)   # counter deltas, window
    captures: int = 0              # graph captures inside the window
    decimations: int = 0
    step_ms: dict = field(default_factory=lambda: {"mapping": [],
                                                   "tracking": []})
    latency_ms: list = field(default_factory=list)   # open loop, a scan
    kinds: list = field(default_factory=list)   # open loop: mapping scan?
    late: int = 0                  # open loop: poses after the next due
    generator_lag_ms: list = field(default_factory=list)
    outputs: dict = field(default_factory=dict)  # scan -> {name: pose}
    before: dict = field(default_factory=dict)   # scan -> host state
    after: dict = field(default_factory=dict)
    profile: object = None
    profiled_scans: int = 0
    stage_s: float = 0.0


def host_copy(state) -> dict:
    return {p: t.detach().to("cpu", copy=True)
            for p, t in flatten(state).items()}


class Stager:
    """Scans staged on the device a chunk at a time, the clock stopped."""

    def __init__(self, stream, chunk: int, clock: Clock):
        self.stream, self.chunk, self.clock = stream, int(chunk), clock
        self.base, self.scans = 0, []
        self.seconds = 0.0
        self.marks = []     # (scan, clock) at each restage

    def first(self) -> None:
        self.scans = self.stream.scans(0, self.chunk)
        self.clock.sync()

    def get(self, k: int):
        if not self.base <= k < self.base + len(self.scans):
            self.marks.append((k, self.clock.now()))
            self.clock.pause()
            t0 = time.perf_counter()
            self.scans = None
            self.base = k
            self.scans = self.stream.scans(k, k + self.chunk)
            self.clock.sync()
            self.seconds += time.perf_counter() - t0
            self.clock.resume()
        return self.scans[k - self.base]


class Tracer:
    """``torch.profiler`` over scans [start, start + n) of a traced run,
    with a ``bench.profiled`` record spanning them."""

    def __init__(self, start: int, n: int, clock: Clock):
        self.start, self.n, self.clock = int(start), int(n), clock
        self.prof = self.rec = None

    def timed(self, k: int) -> bool:
        """Whether step ``k`` is timed alone: the scans before the
        profiled ones (once the profiler has run, its hooks slow the host's
        launches)."""
        return k < self.start

    def before(self, k: int) -> None:
        if k == self.start:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            self.clock.pause()
            acts = [ProfilerActivity.CPU]
            if self.clock.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.rec = record_function("bench.profiled")
            self.rec.__enter__()
            self.clock.resume()

    def after(self, k: int) -> None:
        if k == self.start + self.n - 1:
            self.clock.sync()
            self.rec.__exit__(None, None, None)
            self.clock.pause()
            self.prof.__exit__(None, None, None)
            self.clock.resume()


def _label(name: str):
    from torch.profiler import record_function
    return record_function(name)


def _keep(rec: Record, plan: Plan, prog, k: int, out, clock: Clock) -> None:
    if k in plan.kept:
        rec.outputs[k] = out
    if k in plan.after:
        clock.pause()
        rec.after[k] = host_copy(prog.state)
        clock.resume()


def _snapshot_before(rec: Record, plan: Plan, prog, k: int,
                     clock: Clock) -> None:
    if k in plan.before:
        clock.pause()
        rec.before[k] = host_copy(prog.state)
        clock.resume()


def closed_loop(prog, stager: Stager, traffic: dict, seconds: float,
                plan: Plan, tracer: Tracer | None) -> Record:
    """Scans back to back for ``seconds``; then on, untimed, until the
    plan's last segment is complete."""
    clock = stager.clock
    rec = Record()
    every = int(traffic.get("decimate_every", 0))
    c0 = prog.counters()
    clock.sync()
    t0 = clock.now()
    k, open_ = 0, True
    while open_ or k < plan.end:
        scan = stager.get(k)
        _snapshot_before(rec, plan, prog, k, clock)
        timed = tracer is not None and tracer.timed(k) and open_
        if tracer is not None:
            tracer.before(k)
        if timed:
            clock.sync()
            ts = time.perf_counter()
        with _label("bench.step"):
            out = prog.step(k, scan)
        if timed:
            clock.sync()
            kind = "mapping" if prog.is_mapping(k) else "tracking"
            rec.step_ms[kind].append((time.perf_counter() - ts) * 1e3)
        if tracer is not None:
            tracer.after(k)
        _keep(rec, plan, prog, k, out, clock)
        k += 1
        if every and k % every == 0:
            with _label("bench.decimate"):
                rec.decimations += prog.maintain()
        if open_ and clock.now() - t0 >= seconds:
            clock.sync()
            rec.window_s = clock.now() - t0
            rec.scans = k
            c1 = prog.counters()
            rec.counts = {n: c1[n] - c0[n] for n in c1 if n != "captures"}
            rec.captures = c1["captures"] - c0["captures"]
            open_ = False
    clock.sync()
    rec.stage_s = stager.seconds
    if tracer is not None and tracer.prof is not None:
        rec.profile, rec.profiled_scans = tracer.prof, tracer.n
    return rec


def open_loop(prog, stager: Stager, traffic: dict, seconds: float,
              plan: Plan, tracer: Tracer | None) -> Record:
    """A scan due every ``1 / rate_hz`` s for ``seconds``: its step starts
    at its due time or when the previous step's pose reached the host,
    whichever is later; latency is from the due time to the fused pose
    (``HOST_POSE``) on the host.  A pose that lands after the next scan is
    due is late."""
    clock = stager.clock
    rec = Record()
    period = 1.0 / float(traffic["rate_hz"])
    n = max(int(round(seconds * float(traffic["rate_hz"]))), 1)
    every = int(traffic.get("decimate_every", 0))
    c0 = prog.counters()
    clock.sync()
    t0 = clock.now() + period
    for k in range(max(n, plan.end)):
        scan = stager.get(k)
        _snapshot_before(rec, plan, prog, k, clock)
        if tracer is not None:
            tracer.before(k)
        due = t0 + k * period
        with _label("bench.wait"):
            while True:
                rem = due - clock.now()
                if rem <= 0:
                    break
                if rem > 2e-3:
                    time.sleep(rem - 1e-3)
        ts = clock.now()
        with _label("bench.step"):
            out = prog.step(k, scan)
            out[HOST_POSE].t.to("cpu")
        te = clock.now()
        if tracer is not None:
            tracer.after(k)
        if k < n:
            rec.latency_ms.append((te - due) * 1e3)
            rec.kinds.append(prog.is_mapping(k))
            if tracer is not None and tracer.timed(k):
                kind = "mapping" if prog.is_mapping(k) else "tracking"
                rec.step_ms[kind].append((te - ts) * 1e3)
            rec.late += te > due + period
            if k == 0 or rec.latency_ms[-2] <= period * 1e3:
                rec.generator_lag_ms.append((ts - due) * 1e3)
        _keep(rec, plan, prog, k, out, clock)
        if every and (k + 1) % every == 0:
            with _label("bench.decimate"):
                rec.decimations += prog.maintain()
        if k == n - 1:
            clock.sync()
            rec.window_s = clock.now() - (t0 - period)
            rec.scans = n
            c1 = prog.counters()
            rec.counts = {m: c1[m] - c0[m] for m in c1 if m != "captures"}
            rec.captures = c1["captures"] - c0["captures"]
    clock.sync()
    rec.stage_s = stager.seconds
    if tracer is not None and tracer.prof is not None:
        rec.profile, rec.profiled_scans = tracer.prof, tracer.n
    return rec


DRIVERS = {"closed": closed_loop, "open": open_loop}
