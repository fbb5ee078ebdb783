"""Command-line runner: replay a recorded drive through the SLAM pipeline on
the card, as one deterministic process (port of ``legoloam_tpu/cli.py``;
reference: ``roslaunch lego_loam run.launch`` + ``rosbag play``).

    python -m legoloam_tpu_torch --scans /data/seq/*.lpk --out /tmp/run1
    python -m legoloam_tpu_torch --synthetic 200 --out /tmp/run1

It runs on the CUDA device; ``--backend cpu`` is the only way to the CPU.

Outputs (the reference's /tmp PCD dumps and more, mapOptmization.cpp:730-755):
    out/trajectory_fused.txt   TUM-format fused trajectory (10 Hz equivalent)
    out/trajectory_mapped.txt  TUM-format mapped keyframe trajectory
    out/global_map.pcd         voxel-downsampled world map
    out/checkpoint.npz         full resumable SLAM state (the JAX package's
                               keys: either package resumes it)
    out/profile.txt            per-stage wall-clock summary and the run's
                               launches of each CUDA kernel
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import sys

NAME = "legoloam_tpu_torch"


def small_preset(cfg):
    """``--preset small``: map capacities shrunk for CPU debugging."""
    return cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, max_keyframes=128, submap_corner_cap=4096,
        submap_surf_cap=8192, scan_corner_cap=1024, scan_surf_cap=4096))


def upload(scans, dev):
    """NumPy (xyz, valid, ring) triples -> float32, bool and int32 tensors on
    ``dev``.  To a CUDA device they go through two pinned host buffers in
    turn, each reused only after its previous copy has completed."""
    import torch

    if dev.type != "cuda":
        for triple in scans:
            yield tuple(torch.from_numpy(a) for a in triple)
        return
    slots = [None, None]
    for k, triple in enumerate(scans):
        slot = slots[k % 2]
        if slot is None:
            host = tuple(torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                                     pin_memory=True) for a in triple)
        else:
            host, done = slot
            done.synchronize()
        for h, a in zip(host, triple):
            h.numpy()[...] = a
        out = tuple(h.to(dev, non_blocking=True) for h in host)
        done = torch.cuda.Event()
        done.record()
        slots[k % 2] = (host, done)
        yield out


def main(argv=None):
    ap = argparse.ArgumentParser(prog=NAME, description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--scans", nargs="*", default=None,
                    help="scan files (.lpk/.bin/.pcd), in sequence order")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N ray-cast synthetic scans instead of files")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--sensor", default="vlp16",
                    choices=["vlp16", "hdl32e", "vls128", "os1_16", "os1_64"])
    ap.add_argument("--loop-closure", action="store_true")
    ap.add_argument("--imu", default=None, metavar="FILE.imu",
                    help="IMU1 sidecar (utils/io.py:write_imu) on the scan "
                         "clock; enables de-skew, the IMU-seeded initial "
                         "guess and the mapping attitude blend")
    ap.add_argument("--odometry-only", action="store_true",
                    help="skip mapping")
    ap.add_argument("--resume", default=None, help="checkpoint to resume from")
    ap.add_argument("--relocalize", action="store_true",
                    help="with --resume: relocalize the first scan in the "
                         "restored keyframe map (ICP hypothesis sweep, "
                         "models/relocalize.py) before continuing, for "
                         "sessions that do not restart where the previous "
                         "one ended")
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--map-every", type=int, default=2000, metavar="N",
                    help="export the downsampled global map every N scans "
                         "during the run; 0 = only at the end")
    ap.add_argument("--backend", default=None, choices=["cpu", "cuda"],
                    help="cpu to run on the CPU (the kernels' plain "
                         "versions); default: the CUDA device")
    ap.add_argument("--debug-dump", default=None, metavar="DIR",
                    help="write per-scan debug npz records (range image, "
                         "ground mask, cluster labels, pick sets, submap "
                         "occupancy, diag counters) every --debug-every "
                         "scans")
    ap.add_argument("--debug-every", type=int, default=50)
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="the distributed pipeline over an N-device mesh: "
                         "not ported yet (ROADMAP P14); 0 = single-device")
    ap.add_argument("--preset", default="default",
                    choices=["default", "small"],
                    help="'small' shrinks map capacities (CPU debugging)")
    args = ap.parse_args(argv)

    if args.mesh:
        ap.error(f"--mesh {args.mesh}: the distributed pipeline is not "
                 "ported to PyTorch yet (ROADMAP P14); run without --mesh")
    if args.relocalize and not args.resume:
        ap.error("--relocalize requires --resume (a restored keyframe map)")

    import torch

    from .config import DEFAULT, SENSORS
    from .device import resolve_device
    from .models import pipeline
    from .models import relocalize as reloc_mod
    from .ops import _native, deskew
    from .ops.se3 import Pose
    from .utils import checkpoint, export, io as lio, profiling, synthetic
    from .utils.debugdump import DebugDumper

    try:
        dev = resolve_device(args.backend)
    except RuntimeError as e:
        ap.error(str(e))
    _native.reset_counts()      # profile.txt reports this run's launches

    cfg = DEFAULT.replace(sensor=SENSORS[args.sensor])
    if args.preset == "small":
        cfg = small_preset(cfg)
    if args.loop_closure:
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, enabled=True))

    os.makedirs(args.out, exist_ok=True)
    timer = profiling.StageTimer(dev)

    # --- scan source ---
    loader = None
    if args.synthetic:
        scene = synthetic.default_scene().to(dev)
        n = args.synthetic
        poses = synthetic.circle_trajectory(n, radius=20.0,
                                            angular_rate=0.0075, device=dev)

        def scan_iter():
            for k in range(n):
                j = min(k + 1, n - 1)
                with timer.stage("raycast"):
                    scan = synthetic.raycast_scan(
                        scene, Pose(poses.R[k], poses.t[k]), cfg.sensor,
                        next_pose=Pose(poses.R[j], poses.t[j]),
                        motion=k + 1 < n)
                yield scan
    else:
        paths = []
        for p in (args.scans or []):
            paths.extend(sorted(glob.glob(p)) if any(c in p for c in "*?")
                         else [p])
        if not paths:
            ap.error("no scans given (use --scans or --synthetic N)")
        loader = lio.ScanLoader(
            paths, point_cap=cfg.sensor.n_points, n_scan=cfg.sensor.n_scan,
            ang_bottom_deg=cfg.sensor.ang_bottom_deg,
            ang_res_y_deg=cfg.sensor.ang_res_y_deg)

        def scan_iter():
            return upload(loader, dev)

    # --- run ---
    state = pipeline.init_slam_state(cfg, dev)
    if args.resume:
        fresh_odom = state.odom
        state = checkpoint.load_state(args.resume, state)
        if args.relocalize:
            # The robot restarts elsewhere: the odometry's previous scan
            # and velocity are the last session's, so odometry starts anew
            # (bootstrapped on scan 1) and only the map is resumed.
            state = state._replace(odom=fresh_odom)
    imu_seq = lio.ImuSequence.from_file(args.imu) if args.imu else None
    dumper = DebugDumper(args.debug_dump, every=args.debug_every)

    sched = pipeline.LoopScheduler(cfg)
    fused_R, fused_t, times = [], [], []
    for k, scan in enumerate(scan_iter()):
        t = k * cfg.sensor.scan_period
        integ = None
        if imu_seq is not None:
            with timer.stage("imu"):
                integ = deskew.integrate_imu(imu_seq.window_for(
                    t, cfg.sensor.scan_period, device=dev))
        with timer.stage("slam_step"):
            # A scan to be relocalized is not mapped: at the stale belief
            # it would enter the store as a keyframe at the wrong place,
            # which the relocalization then matches the scan against.
            run_mapping = not args.odometry_only \
                and (k % cfg.mapping_every == 0) \
                and not (k == 0 and args.relocalize)
            state, out = pipeline.slam_scan_step(
                state, *scan, cfg, t, run_mapping=run_mapping,
                run_loop=sched.due(t), imu_integral=integ,
                bootstrap=(k == 1 and (args.relocalize or not args.resume)))
        if k == 0 and args.relocalize:
            state, rdiag = reloc_mod.relocalize_slam_state(state, cfg)
            print(f"[reloc] accepted={bool(rdiag.accepted)} "
                  f"candidate={int(rdiag.candidate)} "
                  f"fitness={float(rdiag.fitness):.4f}")
            out = out._replace(fused_pose=state.mapping.t_aft)
        fused_R.append(out.fused_pose.R)
        fused_t.append(out.fused_pose.t)
        times.append(t)
        if dumper.due(k):
            with timer.stage("debug_dump"):
                dumper.maybe_dump(k, scan, cfg, state=state, diag=out.diag)
        if args.checkpoint_every and (k + 1) % args.checkpoint_every == 0:
            with timer.stage("checkpoint"):
                checkpoint.save_state(
                    os.path.join(args.out, "checkpoint.npz"), state)
        if args.map_every and (k + 1) % args.map_every == 0:
            with timer.stage("map_export"):
                kf_now = state.mapping.kf
                if int(kf_now.count):
                    pts, val = export.assemble_global_map(kf_now)
                    export.write_pcd(
                        os.path.join(args.out, "global_map.pcd"), pts, val)
        if (k + 1) % 100 == 0:
            print(f"[{NAME}] {k + 1} scans, "
                  f"{int(state.mapping.kf.count)} keyframes", file=sys.stderr)
            # No silent caps: warn the moment any fixed cap drops data, and
            # decimate the keyframe store before it saturates.
            fo = out.diag.feat_overflow.cpu().numpy()
            if fo.any():
                print("warning: feature caps overflowed this scan "
                      "[sharp,less_sharp,flat,less_flat,outlier]="
                      f"{fo.tolist()} — raise FeatureConfig caps",
                      file=sys.stderr)
            if int(state.loops.dropped):
                print(f"warning: {int(state.loops.dropped)} loop factors "
                      f"dropped (cap/decimation) — raise "
                      f"PoseGraphConfig.max_loop_factors", file=sys.stderr)
            if int(state.mapping.kf.overflow):
                print(f"warning: keyframe store overflowed "
                      f"{int(state.mapping.kf.overflow)} times — raise "
                      f"max_keyframes or decimate more aggressively",
                      file=sys.stderr)
            if int(state.mapping.cache.voxel_overflow):
                print(f"warning: submap voxel caps dropped "
                      f"{int(state.mapping.cache.voxel_overflow)} voxels "
                      f"— raise submap_*_cap", file=sys.stderr)
            state, did = pipeline.maybe_decimate(state, cfg, margin=48)
            if did:
                print(f"[{NAME}] keyframe store decimated to "
                      f"{int(state.mapping.kf.count)} "
                      f"(cap {cfg.mapping.max_keyframes})", file=sys.stderr)
    if loader is not None:
        loader.close()

    # --- outputs ---
    export.write_trajectory_tum(
        os.path.join(args.out, "trajectory_fused.txt"), times,
        Pose(torch.stack(fused_R), torch.stack(fused_t)))
    kf = state.mapping.kf
    n_kf = int(kf.count)
    if n_kf:
        export.write_trajectory_tum(
            os.path.join(args.out, "trajectory_mapped.txt"),
            kf.time[:n_kf], Pose(kf.R[:n_kf], kf.t[:n_kf]))
        pts, val = export.assemble_global_map(kf)
        export.write_pcd(os.path.join(args.out, "global_map.pcd"), pts, val)
    checkpoint.save_state(os.path.join(args.out, "checkpoint.npz"), state)
    with open(os.path.join(args.out, "profile.txt"), "w") as f:
        f.write(timer.summary() + "\n" + "kernel launches: " + ", ".join(
            f"{name} {k.launches}" for name, k in _native.KERNELS.items())
            + "\n")
    rate = timer.counts["slam_step"] / max(timer.totals["slam_step"], 1e-9)
    print(f"[{NAME}] done: {len(times)} scans, {n_kf} keyframes, "
          f"{rate:.1f} scans/s -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
