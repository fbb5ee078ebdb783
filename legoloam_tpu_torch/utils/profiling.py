"""Per-stage wall-clock timing and device traces (port of
``legoloam_tpu/utils/profiling.py``).

Work on the card is asynchronous: a host clock around a launch measures the
launch.  ``StageTimer`` given a CUDA device therefore synchronises the card
at the end of every stage, so a stage's time is the work it enqueued and
scans/s is the card's rate, not the dispatch rate.  On the CPU it does not
synchronise.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


class StageTimer:
    """Accumulates wall-clock per named stage (one driver thread)."""

    def __init__(self, device=None):
        dev = torch.device(device) if device is not None else None
        self.sync = dev is not None and dev.type == "cuda"
        self.device = dev
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                torch.cuda.synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:28s} {tot:8.3f}s total  {n:6d}x  "
                         f"{tot / max(n, 1) * 1000:8.2f} ms avg")
        return "\n".join(lines)

    def rates(self) -> Dict[str, float]:
        """Per-stage calls/sec."""
        return {k: self.counts[k] / t for k, t in self.totals.items() if t > 0}


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler over the block (CPU and, where present, CUDA
    activity); writes ``logdir/trace.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
