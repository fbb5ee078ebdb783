"""The reduction of a traced window (``torch.profiler``) to what the
per-layer metrics and the result's ``breakdown`` read: the window's length,
the union of the device's intervals inside it, each kernel's device time
and count, and the idle gaps named by what the host was doing."""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from . import yardstick

WINDOW = "bench.profiled"
SHORT_GAP_US = 20.0
NAME_CHARS = 160    # of a kernel name in the breakdown


@dataclass
class Trace:
    window_us: float = 0.0
    busy_us: float = 0.0
    kernels: dict = field(default_factory=dict)   # name -> [us, count]
    gaps: dict = field(default_factory=dict)      # host op -> idle us
    scans: int = 0


def _ns(e, what: str) -> float:
    """An event's ``start`` or ``duration`` in ns (torch names the raw
    event's clocks ``*_ns`` or, in older releases, ``*_us``)."""
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else getattr(e, f"{what}_us")() * 1e3


def reduce(prof, scans: int) -> Trace | None:
    """The ``bench.profiled`` window of ``prof``, from the profiler's raw
    events (kernels, copies and sets on the device; operators, runtime
    calls and records on the host); None when the trace holds no such
    record or no device work inside it.  A record (``record_function``)
    also leaves an annotation on the device's timeline under its own name:
    a device event named as a host event is such an annotation, not
    device work."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = prof.profiler.kineto_results.events()
    on_dev = [e.device_type() == cuda for e in evs]
    host_names = {e.name() for e, d in zip(evs, on_dev) if not d}
    win = [e for e, d in zip(evs, on_dev) if e.name() == WINDOW and not d]
    if not win:
        return None
    w0 = _ns(win[0], "start") * 1e-3
    w1 = w0 + _ns(win[0], "duration") * 1e-3
    dev, host = [], []
    for e, d in zip(evs, on_dev):
        a = _ns(e, "start") * 1e-3
        b = a + _ns(e, "duration") * 1e-3
        name = e.name()
        if b <= w0 or a >= w1 or name == WINDOW:
            continue
        if not d:
            host.append((a, b, name))
        elif name not in host_names:
            dev.append((max(a, w0), min(b, w1), name))
    if not dev:
        return None
    tr = Trace(window_us=w1 - w0, scans=scans)
    iv = [(a, b) for a, b, _ in dev]
    tr.busy_us = yardstick.union_us(iv)
    kern = defaultdict(lambda: [0.0, 0])
    for a, b, name in dev:
        k = kern[name]
        k[0] += b - a
        k[1] += 1
    tr.kernels = dict(kern)
    # An idle gap of SHORT_GAP_US or more is named by the innermost host
    # event that spans its middle (the harness's own records, bench.*,
    # name the loop's part); shorter ones, between the kernels of one
    # graph or launch burst, are summed under one name.
    gaps = defaultdict(float)
    host.sort(key=lambda x: x[1] - x[0])
    for a, b in yardstick.gaps(iv, w0, w1):
        if b - a < SHORT_GAP_US:
            gaps[f"gaps under {SHORT_GAP_US:g} us"] += b - a
            continue
        mid = 0.5 * (a + b)
        name = next((n for s, e, n in host if s <= mid <= e), "host")
        gaps[name] += b - a
    tr.gaps = dict(gaps)
    return tr


def kernel_time(tr: Trace, pattern: str):
    """(device us, launches) of the kernels whose name matches the regular
    expression ``pattern`` (a word of the name: ``ccl_local``)."""
    us, n = 0.0, 0
    for name, (t, c) in tr.kernels.items():
        if re.search(pattern, name):
            us, n = us + t, n + c
    return us, n


def breakdown(tr: Trace) -> dict:
    """The ten device operations that took most time and the ten host
    activities the device waited on longest, in seconds."""
    ops = sorted(((n[:NAME_CHARS], v[0] * 1e-6)
                  for n, v in tr.kernels.items()),
                 key=lambda x: -x[1])[:10]
    idle = sorted(((n, v * 1e-6) for n, v in tr.gaps.items()),
                  key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
