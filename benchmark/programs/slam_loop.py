"""Program kind ``slam_loop``: the per-scan SLAM step with loop closure on,
and its reference.

``Program`` wraps the port's ``StepGraph`` as the ``slam`` kind does and
steps it with ``run_loop`` from the port's ``pipeline.LoopScheduler`` on
the scans' data time (an attempt every ``loop.cadence`` seconds of scan
timestamps); it imports the port only when it is built.  Its warm-up runs
through the first accepted closure of the mix's ring and its re-solve,
so every chain of a loop attempt (no candidate, rejected, accepted; the
ICP's and the CG's chunks) is captured before the window.

``Reference`` is ``reference/step_loop.py``: the plain step with the plain
loop attempt, which decides ``run_loop`` from the scan's index by the
scheduler's rule (``loop_due``).
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from benchmark import harness
from benchmark.reference import step_loop as ref

_slam = harness.load_program(Path(__file__).resolve().parents[1], "slam")

# Attempts the warm-up runs past the end of the first lap: the first
# candidate is found about 26 scans before it (7 m of a 30 m circle), and
# an attempt comes every 10 scans, so these take in the first accepted
# closure and its re-solve, and more attempts after it.
WARM_ATTEMPTS_AFTER_LAP = 6


def loop_due(k: int, cfg) -> bool:
    """``pipeline.LoopScheduler``'s decision at scan ``k`` of a run whose
    scan ``k`` is stamped ``k * scan_period``: the first scan starts the
    clock, then an attempt every ``cadence / scan_period`` scans (at 10 Hz
    and 1.0 s: every 10th scan; the program's tests hold the two equal over
    the mix's first 20,000 scans)."""
    every = max(round(cfg.loop.cadence / cfg.sensor.scan_period), 1)
    return cfg.loop.enabled and k > 0 and k % every == 0


def warm_scans(cfg, traffic: dict) -> int:
    """Scans from a fresh map through the first lap of the mix's circle
    and ``WARM_ATTEMPTS_AFTER_LAP`` attempts more."""
    lap = math.ceil(2.0 * math.pi / float(traffic["angular_rate"]))
    every = max(round(cfg.loop.cadence / cfg.sensor.scan_period), 1)
    return lap + WARM_ATTEMPTS_AFTER_LAP * every


class Program(_slam.Program):
    """``StepGraph.step`` with a loop attempt when the scheduler says so."""

    def __init__(self, cfg, device, traffic: dict):
        super().__init__(cfg, device, traffic)
        self.sched = self._pipeline.LoopScheduler(cfg)
        self.attempts = 0
        self.n_warm = warm_scans(cfg, traffic)

    def step(self, k: int, scan):
        t = k * self.cfg.sensor.scan_period
        run_loop = self.sched.due(t)
        self.attempts += run_loop
        out = self.sg.step(*scan, t, run_mapping=self.is_mapping(k),
                           run_loop=run_loop)
        return {"odom_pose": out.odom_pose, "mapped_pose": out.mapped_pose,
                "fused_pose": out.fused_pose}

    def restart(self) -> None:
        """A fresh, empty state and a fresh scheduler."""
        super().restart()
        self.sched = self._pipeline.LoopScheduler(self.cfg)

    def counters(self) -> dict:
        """The ``slam`` kind's, the attempts, the closures and the drops
        of the factor store, and the ICP and CG iterations the step's
        runner tallied (0 on a port without tallies); the tensors are
        read here, never inside a step."""
        loops = self.sg.state.loops
        tallies = getattr(self.sg.rt, "tallies", {})
        return {**super().counters(), "loop_attempts": self.attempts,
                "loops_closed": int(loops.count),
                "loops_dropped": int(loops.dropped),
                "icp_iters": int(tallies.get("icp_iters", 0)),
                "cg_iters": int(tallies.get("cg_iters", 0))}


class Reference:
    """``reference.step_loop.slam_step`` from the empty SLAM state."""

    def __init__(self, cfg, device):
        ref.check_config(cfg)
        self.cfg, self.device = cfg, torch.device(device)

    def empty(self):
        return ref.init_slam_state(self.cfg, self.device)

    def step(self, state, k: int, scan):
        t = torch.tensor(k * self.cfg.sensor.scan_period,
                         dtype=torch.float32, device=self.device)
        state, out = ref.slam_step(state, *scan, t, self.cfg,
                                   k % self.cfg.mapping_every == 0,
                                   loop_due(k, self.cfg))
        return state, out._asdict()
