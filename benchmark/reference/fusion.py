"""Pose fusion (port of ``legoloam_tpu/models/fusion.py``; reference
``src/transformFusion.cpp``)."""

from __future__ import annotations

from . import se3
from .se3 import Pose


def fuse(odom_pose: Pose, t_bef: Pose, t_aft: Pose) -> Pose:
    """Fused pose at odometry rate with mapping accuracy:
    ``T_aft ∘ T_bef⁻¹ ∘ T_odom`` (transformFusion.cpp:181-216)."""
    return se3.project_through_correction(odom_pose, t_bef, t_aft)
