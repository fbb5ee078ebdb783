"""Program kind ``slam``: the per-scan SLAM step and its reference.

``Program`` wraps the port's ``StepGraph`` and owns its state; it imports
the port only when it is built.  ``Reference`` is the plain step of
``reference/step.py``, which has no loop closure and refuses a
configuration that turns it on.
"""

from __future__ import annotations

import torch

from benchmark.drivers import warm_scans
from benchmark.reference import step as ref


class Program:
    """The per-scan SLAM step, ``StepGraph.step``: mapping every
    ``mapping_every`` scans, and every ``decimate_every`` scans the
    keyframe store's saturation guard (``pipeline.maybe_decimate``)."""

    outputs = ("odom_pose", "mapped_pose", "fused_pose")

    def __init__(self, cfg, device, traffic: dict):
        from legoloam_tpu_torch.models import pipeline
        from legoloam_tpu_torch.models.step_graph import StepGraph
        self.cfg, self.device = cfg, torch.device(device)
        self._pipeline = pipeline
        self.margin = int(traffic["decimate_margin"])
        self.sg = StepGraph(pipeline.init_slam_state(cfg, self.device), cfg)
        self.n_warm = warm_scans(cfg)

    def is_mapping(self, k: int) -> bool:
        return k % self.cfg.mapping_every == 0

    def step(self, k: int, scan):
        out = self.sg.step(*scan, k * self.cfg.sensor.scan_period,
                           run_mapping=self.is_mapping(k))
        return {"odom_pose": out.odom_pose, "mapped_pose": out.mapped_pose,
                "fused_pose": out.fused_pose}

    def restart(self) -> None:
        """A fresh, empty state in the captured buffers."""
        self.sg.load(self._pipeline.init_slam_state(self.cfg, self.device))

    def maintain(self) -> bool:
        """The saturation guard; True when it decimated the store."""
        state, did = self._pipeline.maybe_decimate(self.sg.state, self.cfg,
                                                   margin=self.margin)
        if did:
            self.sg.load(state)
        return did

    @property
    def state(self):
        return self.sg.state

    def counters(self) -> dict:
        rt = self.sg.rt
        return {"replays": getattr(rt, "replays", 0), "reads": rt.reads,
                "captures": len(getattr(rt, "chains", ()))}


class Reference:
    """``reference.step.slam_step`` from the empty SLAM state."""

    def __init__(self, cfg, device):
        ref.check_config(cfg)
        self.cfg, self.device = cfg, torch.device(device)

    def empty(self):
        return ref.init_slam_state(self.cfg, self.device)

    def step(self, state, k: int, scan):
        t = torch.tensor(k * self.cfg.sensor.scan_period,
                         dtype=torch.float32, device=self.device)
        state, out = ref.slam_step(state, *scan, t, self.cfg,
                                   k % self.cfg.mapping_every == 0)
        return state, out._asdict()
