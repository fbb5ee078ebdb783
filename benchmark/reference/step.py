"""The per-scan SLAM step and odometry step, straight-line and eager: the
body of the port's ``pipeline.step_body`` (no IMU, no loop closure, no
bootstrap) and ``pipeline.odometry_body``, on the reference's copies of
the ops and models."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import features, fusion, mapping, odometry, projection, segmentation
from .config import PipelineConfig
from .se3 import Pose


class SlamState(NamedTuple):
    odom: odometry.OdometryState
    mapping: mapping.MapState


class StepOut(NamedTuple):
    odom_pose: Pose
    mapped_pose: Pose
    fused_pose: Pose


def check_config(cfg: PipelineConfig) -> None:
    """The reference runs the step without loop closure."""
    if cfg.loop.enabled:
        raise ValueError("the reference step has no loop closure; a "
                         "configuration with loop.enabled needs one")


def init_slam_state(cfg: PipelineConfig, device) -> SlamState:
    return SlamState(
        odom=odometry.init_state(cfg.odom, cfg.feat, device),
        mapping=mapping.init_state(cfg.mapping, device))


def init_odometry_state(cfg: PipelineConfig, device):
    return odometry.init_state(cfg.odom, cfg.feat, device)


def process_scan(points, valid, ring, cfg: PipelineConfig):
    """Frontend: raw scan -> ``features.ScanFeatures``."""
    img = projection.project_scan(points, valid, cfg.sensor, ring=ring)
    if not cfg.deskew:
        img = img._replace(rel_time=torch.ones_like(img.rel_time))
    seg = segmentation.segment(img, cfg.sensor, cfg.seg)
    return features.extract_features(img, seg, cfg.sensor, cfg.feat)


def odometry_step(state, points, valid, ring, cfg: PipelineConfig):
    """Frontend and the two-step LM: (new state, world pose)."""
    feats = process_scan(points, valid, ring, cfg)
    new_state, pose, _ = odometry.odometry_step(state, feats, cfg.odom)
    return new_state, pose


def slam_step(state: SlamState, points, valid, ring, scan_time,
              cfg: PipelineConfig, run_mapping: bool):
    """One SLAM step: frontend, odometry, on a mapping scan the submap and
    the scan-to-map step (the keyframe store written in place), fusion.
    ``scan_time`` a () float32 tensor.  Returns (state, ``StepOut``)."""
    feats = process_scan(points, valid, ring, cfg)
    odom_state, pose, _ = odometry.odometry_step(
        state.odom, feats, cfg.odom, xi_seed=state.odom.xi)
    mp = state.mapping
    if run_mapping:
        prep = mapping.mapping_prepare(
            mp, odom_state.last_corner, odom_state.last_surf,
            odom_state.last_outlier, pose, cfg.mapping)
        branch = None if prep.branch is None else int(prep.branch.item())
        mp, submap = mapping.submap_update(mp, prep, cfg.mapping, branch)
        mp = mapping.mapping_finish(
            mp, prep, submap, odom_state.pose, scan_time, cfg.mapping,
            ground_cloud=odom_state.last_flat)[0]
    fused = fusion.fuse(odom_state.pose, mp.t_bef, mp.t_aft)
    return (SlamState(odom=odom_state, mapping=mp),
            StepOut(odom_pose=odom_state.pose, mapped_pose=mp.t_aft,
                    fused_pose=fused))
