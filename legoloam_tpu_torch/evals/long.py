"""Long-horizon SLAM evaluation (port of ``tools/eval_long.py``).

Runs N synthetic scans (ray-cast against a world with exact ground truth,
on the device, with motion distortion) through the full pipeline and
reports the ATE RMSE of the odometry-only and the fused trajectories, the
end drift and the path length — the accuracy ledgers of the JAX package
(the 800-scan ring, the 919 m circuit) on the port.

    python -m legoloam_tpu_torch.evals.long [--scans 500] [--loop] [--imu]
        [--world courtyard|loop|circuit] [--noise 0.02] [--save run.npz]

Range noise comes from one seeded ``torch.Generator`` a scan (seed = the
scan index), not from the JAX tool's split PRNG key, so noisy scans are not
bit-equal to the JAX tool's and noisy runs match its ledgers only
statistically.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="legoloam_tpu_torch.evals.long",
                                 description=__doc__)
    ap.add_argument("--scans", type=int, default=500)
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--imu", action="store_true",
                    help="feed synthetic IMU (de-skew + initial guess)")
    ap.add_argument("--backend", default=None, choices=["cpu", "cuda"],
                    help="cpu to run on the CPU; default: the CUDA device")
    ap.add_argument("--world", default="courtyard",
                    choices=["courtyard", "loop", "circuit"],
                    help="courtyard: 50x40 m block (stay <= ~120 scans at the"
                         " default radius or the path exits the walls); loop:"
                         " 90x90 m ring world built for full revisit laps;"
                         " circuit: ~766 m rounded-square course larger than"
                         " the submap radius (~957 scans a lap)")
    ap.add_argument("--radius", type=float, default=None)
    ap.add_argument("--angular-rate", type=float, default=0.009)
    ap.add_argument("--traj", default="circle", choices=["circle", "figure8"],
                    help="figure8: equal left/right turning (cancels "
                         "rotation-coupled sampling bias; revisits origin)")
    ap.add_argument("--save", default=None,
                    help="write trajectories (fused/odom/mapped/gt R+t) to NPZ")
    ap.add_argument("--set-map", action="append", default=[], metavar="K=V",
                    help="override MappingConfig fields, e.g. "
                         "--set-map ground_anchor=0 --set-map prior_trans_std=0")
    ap.add_argument("--set-odo", action="append", default=[], metavar="K=V",
                    help="override OdometryConfig fields, e.g. "
                         "--set-odo max_iterations=10")
    ap.add_argument("--circuit-half", type=float, default=100.0,
                    help="circuit world half-size (100 -> ~766 m lap; 200 "
                         "-> ~1570 m lap)")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="per-range Gaussian noise sigma in meters (realistic"
                         " VLP-16: ~0.03)")
    ap.add_argument("--preset", default="default",
                    choices=["default", "small"],
                    help="'small' shrinks map capacities (CPU runs)")
    args = ap.parse_args(argv)
    if args.radius is None:
        args.radius = 30.0 if args.world == "loop" else 26.0

    import dataclasses

    import numpy as np
    import torch

    from .. import config
    from ..cli import small_preset
    from ..config import DEFAULT
    from ..device import resolve_device
    from ..models import pipeline, step_graph
    from ..ops import deskew
    from ..ops.se3 import Pose
    from ..utils import metrics, synthetic

    dev = resolve_device(args.backend)
    cfg = small_preset(DEFAULT) if args.preset == "small" else DEFAULT
    if args.loop:
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, enabled=True))
    if args.set_map:
        cfg = cfg.replace(
            mapping=config.apply_overrides(cfg.mapping, args.set_map))
    if args.set_odo:
        cfg = cfg.replace(odom=config.apply_overrides(cfg.odom, args.set_odo))

    scene = (synthetic.loop_scene() if args.world == "loop"
             else synthetic.circuit_scene(args.circuit_half)
             if args.world == "circuit"
             else synthetic.default_scene()).to(dev)
    n = args.scans
    if args.world == "circuit":
        poses = synthetic.circuit_trajectory(n + 1, half=args.circuit_half,
                                             device=dev)
    elif args.traj == "figure8":
        # radius 8 keeps the lobes clear of the courtyard's interior
        # buildings; the loop world's central block rules figure8 out there.
        poses = synthetic.figure8_trajectory(n + 1, radius=8.0, device=dev)
    else:
        poses = synthetic.circle_trajectory(n + 1, radius=args.radius,
                                            angular_rate=args.angular_rate,
                                            device=dev)

    integ = None
    if args.imu:
        ts, rpy, acc, gyro = synthetic.make_imu(poses, scan_period=0.1)
        integ = deskew.integrate_imu(deskew.ImuWindow(
            ts, rpy, acc, gyro,
            torch.ones(ts.shape[0], dtype=torch.bool, device=dev)))

    def scan(k):
        gen = None
        if args.noise > 0:
            gen = torch.Generator(device=dev).manual_seed(k)
        return synthetic.raycast_scan(
            scene, Pose(poses.R[k], poses.t[k]), cfg.sensor,
            noise_sigma=args.noise, generator=gen,
            next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True)

    sg = step_graph.StepGraph(pipeline.init_slam_state(cfg, dev), cfg)
    sched = pipeline.LoopScheduler(cfg)
    fused, odoms = [], []
    fused_R, odom_R, mapped_t = [], [], []
    t0 = time.perf_counter()
    for k in range(n):
        out = sg.step(
            *scan(k), 0.1 * k,
            run_mapping=(k % cfg.mapping_every == 0),
            run_loop=sched.due(0.1 * k),
            imu_integral=integ, bootstrap=(k == 1))
        if (k + 1) % 100 == 0:
            float(out.fused_pose.t[0])        # host sync
            print(f"  scan {k + 1}/{n}  ({(k + 1) / (time.perf_counter() - t0):.1f} scans/s incl. raycast)",
                  flush=True)
            state, did = pipeline.maybe_decimate(sg.state, cfg, margin=48)
            if did:
                sg.load(state)
                print(f"  [decimate] keyframe store -> "
                      f"{int(state.mapping.kf.count)} kf", flush=True)
        fused.append(out.fused_pose.t)
        odoms.append(out.odom_pose.t)
        if args.save:
            fused_R.append(out.fused_pose.R)
            odom_R.append(out.odom_pose.R)
            mapped_t.append(out.mapped_pose.t)
    state = sg.state
    fused = torch.stack(fused).cpu().numpy()
    odoms = torch.stack(odoms).cpu().numpy()
    # The estimate frame is the scan-0 sensor frame: rebase ground truth by
    # the start pose (the circuit starts away from the origin).
    R0 = poses.R[0].cpu().numpy()
    gt = (poses.t[:n].cpu().numpy() - poses.t[0].cpu().numpy()) @ R0
    kf = int(state.mapping.kf.count)
    if args.save:
        np.savez(args.save,
                 fused_t=fused, odom_t=odoms, gt_t=gt,
                 fused_R=torch.stack(fused_R).cpu().numpy(),
                 odom_R=torch.stack(odom_R).cpu().numpy(),
                 mapped_t=torch.stack(mapped_t).cpu().numpy(),
                 gt_R=poses.R[:n].cpu().numpy(),
                 kf_t=state.mapping.kf.t.cpu().numpy(),
                 kf_count=kf)
        print(f"saved trajectories -> {args.save}")

    ate_f = float(metrics.ate_rmse(torch.from_numpy(fused),
                                   torch.from_numpy(gt)))
    ate_o = float(metrics.ate_rmse(torch.from_numpy(odoms),
                                   torch.from_numpy(gt)))
    drift_f = float(np.linalg.norm(fused[-1] - gt[-1]))
    drift_o = float(np.linalg.norm(odoms[-1] - gt[-1]))
    path_len = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    n_loops = int(state.loops.count)
    print(f"scans {n}, keyframes {kf}, path {path_len:.0f} m, "
          f"loop closures {n_loops}")
    print(f"ATE RMSE  odometry-only: {ate_o:.4f} m   fused: {ate_f:.4f} m")
    print(f"end drift odometry-only: {drift_o:.4f} m ({100 * drift_o / path_len:.3f}%)"
          f"   fused: {drift_f:.4f} m ({100 * drift_f / path_len:.3f}%)")
    return {"scans": n, "keyframes": kf, "path": path_len,
            "closures": n_loops, "ate_odom": ate_o, "ate_fused": ate_f,
            "drift_odom": drift_o, "drift_fused": drift_f,
            "mapped_R": state.mapping.t_aft.R.cpu().numpy()}


if __name__ == "__main__":
    main()
