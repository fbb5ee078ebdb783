"""Program kind ``odometry``: the frontend and the two-step LM alone, and
their reference.

``Program`` wraps the port's ``OdometryGraph`` and owns its state; it
imports the port only when it is built.  ``Reference`` is the plain
odometry step of ``reference/step.py``.
"""

from __future__ import annotations

import torch

from benchmark.reference import step as ref


class Program:
    """Odometry alone, ``OdometryGraph.step``: the frontend and the
    two-step LM, scan by scan."""

    outputs = ("pose",)

    def __init__(self, cfg, device, traffic: dict):
        from legoloam_tpu_torch.models import odometry
        from legoloam_tpu_torch.models.step_graph import OdometryGraph
        self.cfg, self.device = cfg, torch.device(device)
        self._odometry = odometry
        self.og = OdometryGraph(self._fresh(), cfg)
        self.n_warm = 3

    def _fresh(self):
        return self._odometry.init_state(self.cfg.odom, self.cfg.feat,
                                         self.device)

    def is_mapping(self, k: int) -> bool:
        return False

    def step(self, k: int, scan):
        return {"pose": self.og.step(*scan).pose}

    def restart(self) -> None:
        self.og.load(self._fresh())

    def maintain(self) -> bool:
        return False

    @property
    def state(self):
        return self.og.state

    def counters(self) -> dict:
        rt = self.og.rt
        return {"replays": getattr(rt, "replays", 0), "reads": rt.reads,
                "captures": len(getattr(rt, "chains", ()))}


class Reference:
    """``reference.step.odometry_step`` from the empty odometry state."""

    def __init__(self, cfg, device):
        ref.check_config(cfg)
        self.cfg, self.device = cfg, torch.device(device)

    def empty(self):
        return ref.init_odometry_state(self.cfg, self.device)

    def step(self, state, k: int, scan):
        state, pose = ref.odometry_step(state, *scan, self.cfg)
        return state, {"pose": pose}
