"""Benchmark: scans/sec of the full SLAM pipeline (default) or odometry only,
on the card (port of the JAX package's ``bench.py``, every flag and mode).

    python -m legoloam_tpu_torch.bench                 # full SLAM, growing map
    python -m legoloam_tpu_torch.bench --grow 20480 --world circuit --half 100
    python -m legoloam_tpu_torch.bench --cycle         # 12 cycled scans
    python -m legoloam_tpu_torch.bench --odometry [--block B]
    python -m legoloam_tpu_torch.bench --loop | --slam-block | --sensor vls128
    python -m legoloam_tpu_torch.bench --backend cpu --preset small --cycle

Prints ONE JSON line on stdout,
  {"metric": ..., "value": N, "unit": "scans/sec", "vs_baseline": N},
with the JAX bench's metric names; the device part of a name is the
platform, ``gpu`` or ``cpu``.  Baseline = 10 scans/s, the VLP-16's 10 Hz
rotation: ``vs_baseline`` is the real-time multiple.  On stderr: the
state's memory budget, in ``--grow`` one line a 128-scan window (scans/s,
keyframes, peak allocated memory, graph captures in the window), each
decimation and overflow, and the bounded-drift ledger (the fused
trajectory against ground truth rebased to the first pose); in every mode
the kernel launches of the timed run.

The steps run on the drivers' programs, which the bench owns: ``--grow``
and the cycled SLAM modes on a ``step_graph.StepGraph``, ``--slam-block`` on
``StepGraph.block`` (``pipeline.slam_scan_block``'s body), ``--odometry``
on a ``step_graph.OdometryGraph`` (the body of
``pipeline.odometry_scan_step`` / ``odometry_scan_block``).  On the card
each is captured CUDA graphs, and the timed run replays the warm-up's:
``--grow`` warms up on a throwaway state and loads a fresh one into the
same buffers; the cycled modes, as the JAX bench's, go on from the
warm-up's state.  A SLAM mode warms up past the submap cache's first skip
(60 scans at DEFAULT, where the JAX bench warms up over 4 scans in
``--grow`` and 12 steps in the cycled modes), so that no window holds a
capture.  ``--backend cpu`` runs the same bodies eagerly on the CPU;
without it the run needs a card.
Windows are timed with the card synchronised (``StepGraph.step`` ends its
chain of graphs, so nothing is left deferred).

Port-only: ``--preset small`` (map capacities shrunk for CPU runs), and
range noise (``--noise``) drawn from a ``torch.Generator`` seeded with the
scan index, where the JAX bench uses ``PRNGKey(k)``: noisy scans match the
JAX bench's only statistically.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

# Scans a ``--grow`` timing window spans.
WINDOW = 128


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="legoloam_tpu_torch.bench",
                                 description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--backend", default=None, choices=["cpu", "cuda"],
                    help="cpu to run on the CPU; default: the CUDA device")
    ap.add_argument("--scans", type=int, default=60)
    # Warmup must reach every step variant (mapping every 3rd scan, loop
    # closure every 10th) so that no capture lands inside the timed window;
    # captured, a SLAM mode warms up at least to past the submap cache's
    # first skip (``_warm_scans``).
    ap.add_argument("--warmup", type=int, default=12)
    ap.add_argument("--block", type=int, default=12,
                    help="scans per odometry program (1 = streaming)")
    ap.add_argument("--odometry", action="store_true",
                    help="bench the odometry-only path (no mapping)")
    ap.add_argument("--mapping", action="store_true",
                    help="(default) full SLAM cadence incl. scan-to-map")
    ap.add_argument("--loop", action="store_true",
                    help="full SLAM + loop-closure cadence (every 10th scan)")
    ap.add_argument("--slam-block", action="store_true",
                    help="mapping_every scans + one mapping step per block "
                         "(slam_scan_block; identical math to streaming)")
    ap.add_argument("--grow", type=int, default=None, metavar="N",
                    help="scale-realistic mode (default, N=1024): N DISTINCT "
                         "ring-world scans through full SLAM; scans/s per "
                         "window (stderr) + one summary JSON line")
    ap.add_argument("--cycle", action="store_true",
                    help="microbench: cycle 12 pre-staged scans "
                         "(constant-size map)")
    ap.add_argument("--world", default="ring", choices=["ring", "circuit"],
                    help="grow-mode world: 'ring' (the 188 m headline lap) "
                         "or 'circuit' (rounded-square lane, --half sets "
                         "size; the multi-lap endurance course)")
    ap.add_argument("--half", type=float, default=100.0,
                    help="circuit half-size in m (766 m lap at 100)")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="per-scan range noise sigma in m (grow mode)")
    ap.add_argument("--chunk", type=int, default=2048,
                    help="grow-mode staging chunk (scans ray-cast onto the "
                         "device at a time, outside the timed windows)")
    ap.add_argument("--sensor", default=None,
                    choices=["vlp16", "hdl32e", "vls128", "os1_16", "os1_64"],
                    help="sensor geometry (default vlp16)")
    ap.add_argument("--set-map", action="append", default=[], metavar="K=V",
                    help="override a MappingConfig field")
    ap.add_argument("--set-odo", action="append", default=[], metavar="K=V",
                    help="override an OdometryConfig field")
    ap.add_argument("--preset", default="default",
                    choices=["default", "small"],
                    help="'small' shrinks map capacities (CPU runs)")
    args = ap.parse_args(argv)
    args.mapping = not args.odometry
    if args.grow is None:
        non_grow = (args.cycle or args.odometry or args.loop
                    or args.slam_block)
        args.grow = 0 if non_grow else 1024
    return args


def config(args):
    """The run's configuration: DEFAULT or the sensor's, the small preset,
    the overrides."""
    from . import config as config_mod
    from .cli import small_preset
    cfg = config_mod.for_sensor(args.sensor) if args.sensor \
        else config_mod.DEFAULT
    if args.preset == "small":
        cfg = small_preset(cfg)
    if args.set_map or args.set_odo:
        cfg = cfg.replace(
            mapping=config_mod.apply_overrides(cfg.mapping, args.set_map),
            odom=config_mod.apply_overrides(cfg.odom, args.set_odo))
    if args.loop:
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, enabled=True))
    return cfg


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _captures(rt) -> int:
    """Chains of segments the runner has captured (0 when eager)."""
    return len(getattr(rt, "chains", ()))


def _warm_scans(cfg) -> int:
    """Scans from a fresh map to past the submap cache's first skip: the
    young map folds every keyframe until it holds 2 batches (about one
    keyframe a mapping step), then 4 more mapping steps."""
    return (2 * max(cfg.mapping.submap_merge_batch, 1) + 4) \
        * cfg.mapping_every


def _report(metric: str, value: float, launches: dict) -> dict:
    print(f"[bench] kernel launches in the timed run: "
          f"{json.dumps(launches)}", file=sys.stderr)
    line = {"metric": metric, "value": round(value, 2), "unit": "scans/sec",
            "vs_baseline": round(value / 10.0, 2)}
    print(json.dumps(line), flush=True)
    return dict(line, launches=launches)


def grow(args, cfg, dev, plat: str, window: int = WINDOW,
         graph: bool = True) -> dict:
    """``--grow N``: N distinct scans of the ring world (or the circuit)
    through the full pipeline without the scan-1 bootstrap, mapping every
    ``mapping_every`` scans, a loop attempt every 10th with ``--loop``, and
    after every ``window`` scans the keyframe store's saturation guard
    (``maybe_decimate(margin=64)``).  Returns the summary with the fused
    positions, the rebased ground truth and the windows.  ``graph=False``:
    the eager body on the card."""
    import numpy as np
    import torch

    from .models import pipeline
    from .models.step_graph import StepGraph
    from .ops import _native
    from .ops.se3 import Pose
    from .utils import memory, synthetic

    n = args.grow
    if args.world == "circuit":
        scene = synthetic.circuit_scene(args.half)
        poses = synthetic.circuit_trajectory(n + 1, half=args.half,
                                             device=dev)
        world_tag = f"circuit h={args.half:g}"
    else:
        scene = synthetic.loop_scene()
        poses = synthetic.circle_trajectory(n + 1, radius=30.0,
                                            angular_rate=0.009, device=dev)
        world_tag = "ring world"
    scene = scene.to(dev)
    sigma = float(args.noise)

    def cast(k):
        gen = torch.Generator(device=dev).manual_seed(k) if sigma > 0 \
            else None
        return synthetic.raycast_scan(
            scene, Pose(poses.R[k], poses.t[k]), cfg.sensor,
            noise_sigma=sigma, generator=gen,
            next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True)

    def stage(c0, c1):
        """Ray-cast scans [c0, c1) on the device, outside the timed
        windows (scan generation stands in for the sensor)."""
        out = [cast(k) for k in range(c0, c1)]
        _sync(dev)
        return out

    chunk = max(256, min(n, args.chunk))
    print(memory.summary(cfg), file=sys.stderr)
    print(f"[grow] {world_tag}: {n} distinct scans, staged in chunks of "
          f"{chunk}...", file=sys.stderr)
    scans = stage(0, min(chunk, n))

    # Warm up every step variant on a throwaway state; the timed run
    # replays the graphs it captured.  The submap cache's three branches
    # are three graphs here (one program in the JAX bench, whose warm-up is
    # 4 scans): the warm-up runs past the young map's folds (2 batches of
    # keyframes, about one a mapping step) into the first skip.
    sg = StepGraph(pipeline.init_slam_state(cfg, dev), cfg, graph=graph)
    for k in range(min(_warm_scans(cfg), len(scans))):
        sg.step(*scans[k], 0.1 * k, run_mapping=(k % cfg.mapping_every == 0),
                run_loop=args.loop and k % 10 == 0 and k > 0)
    sg.load(pipeline.init_slam_state(cfg, dev))
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    windows, decimations = [], 0
    stage_time = 0.0
    fused_t = []
    _native.reset_counts()
    caps0 = _captures(sg.rt)
    t_run0 = time.perf_counter()
    t0 = t_run0
    for k in range(n):
        j = k % chunk
        if j == 0 and k > 0:
            ts0 = time.perf_counter()
            scans = None            # the last chunk's memory first
            scans = stage(k, min(k + chunk, n))
            stage_time += time.perf_counter() - ts0
            t0 = time.perf_counter()
        out = sg.step(*scans[j], 0.1 * k,
                      run_mapping=(k % cfg.mapping_every == 0),
                      run_loop=args.loop and k % 10 == 0 and k > 0)
        fused_t.append(out.fused_pose.t)
        if (k + 1) % window == 0:
            _sync(dev)
            dt = time.perf_counter() - t0
            st = sg.state
            kf = int(st.mapping.kf.count)
            peak = torch.cuda.max_memory_allocated(dev) / 2**30 \
                if dev.type == "cuda" else 0.0
            caps = _captures(sg.rt) - caps0
            extra = f"   loops={int(st.loops.count)}" if args.loop else ""
            print(f"[grow] scans {k + 1 - window}-{k + 1}: "
                  f"{window / dt:7.1f} scans/s   kf={kf:4d}   "
                  f"peak_hbm={peak:.2f} GiB{extra}   captures={caps}",
                  file=sys.stderr)
            windows.append({"end": k + 1, "rate": window / dt, "kf": kf,
                            "captures": caps})
            # Keyframe-store saturation guard (the margin covers the <= 43
            # keyframes a 128-scan window can add); overflow is counted,
            # never silent.
            state, did = pipeline.maybe_decimate(st, cfg, margin=64)
            if did:
                sg.load(state)
                decimations += 1
                print(f"[grow] decimated keyframe store -> "
                      f"{int(state.mapping.kf.count)} kf", file=sys.stderr)
            if int(sg.state.mapping.kf.overflow):
                print(f"[grow] WARNING: kf overflow="
                      f"{int(sg.state.mapping.kf.overflow)}", file=sys.stderr)
            caps0 = _captures(sg.rt)
            t0 = time.perf_counter()
    _sync(dev)
    total_proc = time.perf_counter() - t_run0 - stage_time
    launches = _native.counts()
    # Bounded-drift ledger: the fused trajectory against ground truth (the
    # ground truth starts at poses[0]; the estimate at the origin).
    est = torch.stack(fused_t).cpu().numpy()
    gt = poses.t[:n].cpu().numpy() - poses.t[0].cpu().numpy()
    err = np.linalg.norm(est - gt, axis=1)
    dist = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    st = sg.state
    kf, overflow = int(st.mapping.kf.count), int(st.mapping.kf.overflow)
    print(f"[grow] trajectory: {dist:.0f} m, abs err mean {err.mean():.3f}"
          f" max {err.max():.3f} end {err[-1]:.3f} m "
          f"({100.0 * err[-1] / max(dist, 1e-9):.3f}% of distance), "
          f"kf={kf} overflow={overflow}", file=sys.stderr)
    res = _report(f"slam_grow{n}_scans_per_sec ({world_tag}, growing map, "
                  f"{plat})", n / total_proc, launches)
    res.update(fused=est, gt=gt, err_mean=float(err.mean()),
               err_max=float(err.max()), err_end=float(err[-1]), dist=dist,
               kf=kf, overflow=overflow, decimations=decimations,
               windows=windows)
    return res


def cycled(args, cfg, dev, plat: str, graph: bool = True) -> dict:
    """The micro-modes over 12 pre-staged scans of the courtyard world,
    cycled: the SLAM step (``--cycle``, ``--loop``), the SLAM block
    (``--slam-block``) or odometry alone (``--odometry``)."""
    import torch

    from .models import odometry as odom
    from .models import pipeline
    from .models.step_graph import OdometryGraph, StepGraph
    from .ops import _native
    from .ops.se3 import Pose
    from .utils import synthetic

    scene = synthetic.default_scene().to(dev)
    n_pre = 12  # distinct scans, cycled (content doesn't affect timing)
    poses = synthetic.circle_trajectory(n_pre + 1, radius=20.0,
                                        angular_rate=0.0075, device=dev)
    scans = [synthetic.raycast_scan(
        scene, Pose(poses.R[k], poses.t[k]), cfg.sensor,
        next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True)
        for k in range(n_pre)]
    _sync(dev)

    if args.mapping:
        prog = StepGraph(pipeline.init_slam_state(cfg, dev), cfg,
                         graph=graph)
    else:
        prog = OdometryGraph(odom.init_state(cfg.odom, cfg.feat, dev), cfg,
                             graph=graph)
    if args.mapping and not args.slam_block:
        def step(k):
            prog.step(*scans[k % n_pre], float(k) * 0.1,
                      run_mapping=(k % cfg.mapping_every == 0),
                      run_loop=args.loop and k % 10 == 0 and k > 0)

        scans_per_step = 1
    elif args.mapping:
        # B consecutive scans + one mapping step a block
        # (``pipeline.slam_scan_block``'s body); loop closure on every 3rd
        # block.  ``k`` counts blocks.
        B = cfg.mapping_every
        blocks = [tuple(torch.stack([scans[(b * B + i) % n_pre][j]
                                     for i in range(B)]) for j in range(3))
                  for b in range(n_pre)]

        def step(k):
            times = (torch.arange(B, dtype=torch.float32, device=dev)
                     + k * B) * 0.1
            prog.block(*blocks[k % n_pre], times,
                       run_loop=args.loop and k % 3 == 0 and k > 0)

        scans_per_step = B
    else:
        if args.block > 1:
            block = tuple(torch.stack([scans[i % n_pre][j]
                                       for i in range(args.block)])
                          for j in range(3))

            def step(k):
                prog.block(*block)
        else:
            def step(k):
                prog.step(*scans[k % n_pre])
        scans_per_step = max(args.block, 1)

    # Warm-up: capture every step variant and settle the solver.  Captured,
    # a SLAM mode warms up as ``grow`` does, past the submap cache's first
    # skip, so that the timed run captures nothing (but a loop attempt's
    # ICP may stop after a number of chunks it has not stopped after yet).
    warmup = args.warmup
    if prog.captured and args.mapping:
        warmup = max(warmup, -(-_warm_scans(cfg) // scans_per_step))
    for k in range(warmup):
        step(k)
    _sync(dev)
    rt = prog.rt   # the runner whose graphs the timed run replays

    n_steps = max(1, args.scans // scans_per_step)
    caps0, replays0 = _captures(rt), getattr(rt, "replays", 0)
    _native.reset_counts()
    t0 = time.perf_counter()
    for k in range(n_steps):
        step(k + warmup)
    _sync(dev)
    dt = time.perf_counter() - t0
    launches = _native.counts()
    print(f"[bench] timed run: {n_steps} steps of {scans_per_step} scans "
          f"after {warmup} warm-up steps ({caps0} graph captures), graph "
          f"captures {_captures(rt) - caps0}, replays "
          f"{getattr(rt, 'replays', 0) - replays0}", file=sys.stderr)

    name = ("slam_loop_scans_per_sec" if args.loop else
            "slam_scans_per_sec" if args.mapping else
            "odometry_scans_per_sec")
    return _report(f"{name} (VLP-16 synthetic, {plat})",
                   n_steps * scans_per_step / dt, launches)


def main(argv=None, window: int = WINDOW, graph: bool = True) -> dict:
    """Run the bench of ``argv`` (the flags above); ``window``: the scans
    of a ``--grow`` timing window (and of its saturation-guard cadence);
    ``graph=False``: the eager bodies on the card.  Returns the summary
    line's fields (``--grow``: also the fused positions, the rebased
    ground truth, the ledger and the windows)."""
    args = parse(argv)
    from .device import resolve_device
    dev = resolve_device(args.backend)
    plat = "gpu" if dev.type == "cuda" else dev.type
    cfg = config(args)
    if args.grow:
        return grow(args, cfg, dev, plat, window, graph)
    return cycled(args, cfg, dev, plat, graph)


if __name__ == "__main__":
    main()
