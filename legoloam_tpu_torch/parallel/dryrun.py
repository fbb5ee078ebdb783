"""A dry run of the distributed paths on ``n`` ranks at tiny shapes (the
port's twin of the JAX package's ``__graft_entry__.dryrun_multichip``).

    python -c "from legoloam_tpu_torch.parallel import dryrun; \\
               dryrun.dryrun_multichip(2, device='cpu')"

Each rank runs, in order: the data-parallel frontend on a batch of tiny
scans; the distributed pose-graph solve; the scan-to-map solve with the scan
rows split over the ranks; three steps of the distributed SLAM loop with a
loop-closure attempt, held to the single-device pipeline on the same scans
(1e-4 m, equal keyframe counts); and the distributed block driver with the
scan-1 bootstrap.  The shapes are tiny, the layouts the real ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT, FeatureConfig, PoseGraphConfig, SensorConfig
from ..models import pipeline as pipeline_mod
from ..models import posegraph
from ..ops.se3 import Pose
from ..utils import synthetic
from . import frontend_dp, mapping_dist, pipeline_dist, posegraph_dist
from .mesh import Mesh, launch

TINY_SENSOR = SensorConfig(name="tiny", n_scan=4, horizon_scan=128,
                           ang_res_x_deg=360.0 / 128, ang_res_y_deg=2.0,
                           ang_bottom_deg=3.0, ground_scan_ind=2)
TINY_FEAT = FeatureConfig(max_sharp=32, max_less_sharp=128, max_flat=64,
                          max_less_flat=256, max_outlier=64)


def _tiny_cfg(n: int):
    """The dry run's configuration for ``n`` ranks: the tiny sensor, a
    ``2n``-keyframe store, loop closure on."""
    tiny_map = dataclasses.replace(
        DEFAULT.mapping, max_keyframes=2 * n, scan_corner_cap=16 * n,
        scan_surf_cap=32 * n, submap_corner_cap=32 * n,
        submap_surf_cap=64 * n)
    tiny_loop = dataclasses.replace(
        DEFAULT.loop, enabled=True, icp_max_iters=4, cur_cap=64 * n,
        hist_cap=1 << (7 + (n - 1).bit_length()))
    return DEFAULT.replace(sensor=TINY_SENSOR, feat=TINY_FEAT,
                           mapping=tiny_map, loop=tiny_loop)


def _rank(mesh: Mesh):
    n, dev = mesh.size, mesh.device
    cfg = _tiny_cfg(n)
    scene = synthetic.default_scene().to(dev)
    scans = [synthetic.raycast_scan(
        scene, Pose(torch.eye(3, device=dev),
                    torch.tensor([0.2 * k, 0.0, 0.8], device=dev)),
        TINY_SENSOR) for k in range(n)]

    # 1. Data-parallel frontend.
    batch = tuple(torch.stack(x) for x in zip(*scans))
    feats, _ = frontend_dp.make_batched_frontend(cfg, mesh)(*batch)
    if not torch.isfinite(feats.sharp.xyz).all():
        raise RuntimeError("dry run: non-finite frontend features")

    # 2. Distributed pose graph.
    M, nn = 32, 16
    pg_cfg = PoseGraphConfig(gn_iters=2, pcg_iters=8)
    R = torch.eye(3, device=dev).expand(M, 3, 3).clone()
    t = torch.zeros((M, 3), device=dev)
    t[:nn, 0] = torch.arange(nn, dtype=torch.float32, device=dev)
    ct = torch.zeros((M, 3), device=dev)
    ct[:nn, 0] = 1.0
    loops = posegraph.add_loop_factor(
        posegraph.init_loop_factors(8, dev), 0, nn - 1,
        Pose(torch.eye(3, device=dev),
             torch.tensor([float(nn - 1), 0.0, 0.0], device=dev)), 1e-4)
    _, t_out = posegraph_dist.optimize_sharded(
        R, t, torch.tensor(nn, device=dev), R.clone(), ct, loops,
        Pose.identity(device=dev), pg_cfg, mesh)
    if not torch.isfinite(t_out).all():
        raise RuntimeError("dry run: non-finite pose-graph solve")

    # 3. Scan-to-map with the scan rows over the ranks.
    mcfg = dataclasses.replace(
        DEFAULT.mapping, scan_corner_cap=8 * n, scan_surf_cap=32 * n,
        submap_corner_cap=256, submap_surf_cap=1024)
    rs = np.random.RandomState(0)
    sub_c = torch.from_numpy(
        rs.rand(mcfg.submap_corner_cap, 3).astype(np.float32) * 10).to(dev)
    sub_s = torch.from_numpy(
        rs.rand(mcfg.submap_surf_cap, 3).astype(np.float32) * 10).to(dev)

    def ones(k):
        return torch.ones(k, dtype=torch.bool, device=dev)

    T, _, _, _ = mapping_dist.scan_to_map_sharded(
        Pose.identity(device=dev), sub_c[:mcfg.scan_corner_cap],
        ones(mcfg.scan_corner_cap), sub_s[:mcfg.scan_surf_cap],
        ones(mcfg.scan_surf_cap), sub_c, ones(mcfg.submap_corner_cap),
        sub_s, ones(mcfg.submap_surf_cap), mcfg, mesh)
    if not torch.isfinite(T.t).all():
        raise RuntimeError("dry run: non-finite scan-to-map pose")

    # 4. The distributed SLAM loop against the single device.
    dstate = pipeline_dist.init_dist_state(cfg, mesh)
    sstate = pipeline_mod.init_slam_state(cfg, dev)
    err = 0.0
    for k in range(3):
        step = dict(run_mapping=(k % cfg.mapping_every == 0),
                    run_loop=(k == 2))
        dstate, dout = pipeline_dist.slam_scan_step_dist(
            dstate, *scans[k % n], cfg, mesh, 0.1 * k, **step)
        sstate, sout = pipeline_mod.slam_scan_step(
            sstate, *scans[k % n], cfg, 0.1 * k, **step)
        err = max(err, float((dout.fused_pose.t - sout.fused_pose.t)
                             .abs().max()))
    if int(dstate.mapping.kf.count) != int(sstate.mapping.kf.count) \
            or not err < 1e-4:
        raise RuntimeError(f"dry run: mesh vs single device {err} m, "
                           f"{int(dstate.mapping.kf.count)} vs "
                           f"{int(sstate.mapping.kf.count)} keyframes")

    # 5. The distributed block driver with the bootstrap.
    blk = tuple(torch.stack([scans[i % n][j] for i in range(3)])
                for j in range(3))
    _, bout = pipeline_dist.slam_scan_block_dist(
        pipeline_dist.init_dist_state(cfg, mesh), *blk, cfg, mesh,
        torch.arange(3, dtype=torch.float32) * 0.1, bootstrap=True)
    if not torch.isfinite(bout.fused_pose.t).all():
        raise RuntimeError("dry run: non-finite block output")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the dry run on ``n_devices`` ranks: one per card under NCCL, or
    gloo ranks with ``device="cpu"``.  Raises if any rank fails."""
    launch(_rank, n_devices, device=device)

