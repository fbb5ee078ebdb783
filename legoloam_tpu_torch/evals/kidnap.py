"""Kidnapped-robot / multi-session evaluation (port of
``tools/eval_kidnap.py``): the scenario where the explicit ICP
relocalization earns its keep.

Session 1 maps a lap of the ring world and is checkpointed (a round trip
through ``utils/checkpoint``).  Session 2 restarts the robot somewhere else
on the mapped territory with the belief still at the session-1 end, and runs
twice through the ordinary step driver (``step_graph.StepGraph``):

  A. no relocalization: the pipeline continues from the stale belief;
  B. ``relocalize_slam_state`` on the first scan, then the same driver.

Reports the absolute map-frame error, the Umeyama-aligned ATE and the end
drift of both runs; the acceptance bar is B beating A by >= 2x.

    python -m legoloam_tpu_torch.evals.kidnap             # 800 + 200 scans
    python -m legoloam_tpu_torch.evals.kidnap --s1 400 --s2 120 \
        --kidnap-frac 0.45
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time


def _clone(tree):
    """A deep copy of a NamedTuple tree of tensors (the mapping step
    updates its store in place)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_clone(v) for v in tree))


def small_reloc(reloc):
    """CPU-sized relocalization (``--preset small``): the capacities of
    tests/test_torch_relocalize.py."""
    return dataclasses.replace(
        reloc, yaw_hypotheses=4, window=6, cur_cap=2048, hist_cap=8192,
        coarse_iters=8, icp_max_iters=40)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="legoloam_tpu_torch.evals.kidnap",
                                 description=__doc__)
    ap.add_argument("--backend", default=None, choices=["cpu", "cuda"],
                    help="cpu to run on the CPU; default: the CUDA device")
    ap.add_argument("--s1", type=int, default=800,
                    help="session-1 scans (800 = one full ring lap)")
    ap.add_argument("--s2", type=int, default=200)
    ap.add_argument("--kidnap-frac", type=float, default=0.5,
                    help="session-2 start as a fraction of the session-1 "
                         "course (0.5 = opposite side of the ring, ~60 m "
                         "from the stale belief)")
    ap.add_argument("--radius", type=float, default=30.0)
    ap.add_argument("--angular-rate", type=float, default=0.009)
    ap.add_argument("--ckpt", default=None,
                    help="cache session 1 to this npz (reused when present)")
    ap.add_argument("--candidates", type=int, default=128,
                    help="relocalization candidate cells; the ring lap "
                         "occupies ~70 cells at the 5 m cell size, so 128 "
                         "makes the search global")
    ap.add_argument("--preset", default="default",
                    choices=["default", "small"],
                    help="'small' shrinks map and relocalization capacities "
                         "(CPU runs)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..cli import small_preset
    from ..config import DEFAULT
    from ..device import resolve_device
    from ..models import pipeline, relocalize, step_graph
    from ..ops.se3 import Pose
    from ..utils import checkpoint, metrics, synthetic

    dev = resolve_device(args.backend)
    cfg = DEFAULT.replace(
        loop=dataclasses.replace(DEFAULT.loop, enabled=True),
        reloc=dataclasses.replace(DEFAULT.reloc,
                                  n_candidates=args.candidates))
    if args.preset == "small":
        cfg = small_preset(cfg)
        cfg = cfg.replace(reloc=small_reloc(cfg.reloc))

    scene = synthetic.loop_scene().to(dev)
    k0 = int(args.s1 * args.kidnap_frac)
    # Session 2 may run past the stored lap: one trajectory covers both.
    n_poses = max(args.s1, k0 + args.s2) + 1
    poses = synthetic.circle_trajectory(n_poses, radius=args.radius,
                                        angular_rate=args.angular_rate,
                                        device=dev)

    def scan(k, rigid=False):
        if rigid:
            return synthetic.raycast_scan(
                scene, Pose(poses.R[k], poses.t[k]), cfg.sensor)
        return synthetic.raycast_scan(
            scene, Pose(poses.R[k], poses.t[k]), cfg.sensor,
            next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True)

    def template():
        return pipeline.init_slam_state(cfg, dev)

    t_start = time.perf_counter()
    kf1 = None
    with tempfile.TemporaryDirectory() as tmp:
        path = args.ckpt or os.path.join(tmp, "session1.npz")
        if args.ckpt and os.path.exists(args.ckpt):
            print(f"[session 1] loading cached checkpoint {args.ckpt}",
                  flush=True)
        else:
            print(f"[session 1] {args.s1} scans...", flush=True)
            sg = step_graph.StepGraph(template(), cfg)
            sched = pipeline.LoopScheduler(cfg)
            t0 = time.perf_counter()
            for k in range(args.s1):
                out = sg.step(
                    *scan(k), 0.1 * k,
                    run_mapping=(k % cfg.mapping_every == 0),
                    run_loop=sched.due(0.1 * k), bootstrap=(k == 1))
                if (k + 1) % 200 == 0:
                    float(out.fused_pose.t[0])
                    print(f"  scan {k + 1}/{args.s1} "
                          f"({(k + 1) / (time.perf_counter() - t0):.1f} "
                          f"scans/s)", flush=True)
            state = sg.state
            print(f"[session 1] done: {int(state.mapping.kf.count)} "
                  f"keyframes, {int(state.loops.count)} closures",
                  flush=True)
            # The resume path carries the map: a checkpoint round trip.
            checkpoint.save_state(path, state)
            kf1 = int(state.mapping.kf.count)
            del state, sg
        restored = checkpoint.load_state(path, template())
    if kf1 is not None and int(restored.mapping.kf.count) != kf1:
        raise RuntimeError("the checkpoint round trip lost keyframes")
    s1_seconds = time.perf_counter() - t_start

    R0, t0w = poses.R[0].cpu().numpy(), poses.t[0].cpu().numpy()
    gt2 = (poses.t[k0:k0 + args.s2].cpu().numpy() - t0w) @ R0
    belief = restored.mapping.t_aft.t.cpu().numpy()
    offset = float(np.linalg.norm(belief - gt2[0]))
    print(f"[kidnap] restart at scan {k0}; belief-to-truth offset "
          f"{offset:.1f} m (submap radius {cfg.mapping.search_radius} m)",
          flush=True)

    reloc_diag = {}

    def session2(use_reloc: bool):
        sg = step_graph.StepGraph(template()._replace(
            mapping=_clone(restored.mapping), loops=_clone(restored.loops)),
            cfg)
        sched2 = pipeline.LoopScheduler(cfg)
        fused = []
        t_off = args.s1 * 0.1 + 600.0      # resume later in data time
        for j in range(args.s2):
            # Boot at rest: the first scan is rigid (no twist estimate
            # exists yet to de-skew a moving one).
            out = sg.step(
                *scan(k0 + j, rigid=(j == 0)), t_off + 0.1 * j,
                run_mapping=(j % cfg.mapping_every == 0) and j > 0,
                run_loop=sched2.due(t_off + 0.1 * j), bootstrap=(j == 1))
            if j == 0 and use_reloc:
                t_rel = time.perf_counter()
                st, diag = relocalize.relocalize_slam_state(sg.state, cfg)
                sg.load(st)
                reloc_diag.update(accepted=bool(diag.accepted),
                                  candidate=int(diag.candidate),
                                  fitness=float(diag.fitness),
                                  seconds=time.perf_counter() - t_rel)
                print(f"  reloc: accepted={reloc_diag['accepted']} "
                      f"candidate={reloc_diag['candidate']} "
                      f"fitness={reloc_diag['fitness']:.4f} "
                      f"({reloc_diag['seconds']:.3f} s)", flush=True)
                out = out._replace(fused_pose=Pose(
                    st.mapping.t_aft.R.clone(), st.mapping.t_aft.t.clone()))
            fused.append(out.fused_pose.t)
        fused = torch.stack(fused).cpu().numpy()
        # Scan 0 is the pre-relocalization output in run A: both runs are
        # scored from scan 1.  ate_rmse's alignment would hide a constant
        # kidnap offset, so the absolute map-frame error is the headline.
        ate_abs = float(np.sqrt(np.mean(
            np.sum((fused[1:] - gt2[1:]) ** 2, axis=1))))
        ate_umy = float(metrics.ate_rmse(torch.from_numpy(fused[1:]),
                                         torch.from_numpy(gt2[1:])))
        drift = float(np.linalg.norm(fused[-1] - gt2[-1]))
        return ate_abs, ate_umy, drift, \
            int(sg.state.loops.count) - int(restored.loops.count)

    t0 = time.perf_counter()
    print("[session 2/A] no relocalization...", flush=True)
    ate_a, umy_a, drift_a, loops_a = session2(False)
    print(f"  abs ATE {ate_a:.3f} m  (umeyama {umy_a:.3f})  "
          f"end drift {drift_a:.3f} m  new closures {loops_a}", flush=True)
    print("[session 2/B] with relocalization...", flush=True)
    ate_b, umy_b, drift_b, loops_b = session2(True)
    print(f"  abs ATE {ate_b:.3f} m  (umeyama {umy_b:.3f})  "
          f"end drift {drift_b:.3f} m  new closures {loops_b}", flush=True)
    s2_seconds = time.perf_counter() - t0

    print("\n| run | abs ATE (map frame) | Umeyama ATE | end drift "
          "| new closures |")
    print("|---|---|---|---|---|")
    print(f"| A: stale belief, no reloc | {ate_a:.3f} m | {umy_a:.3f} m "
          f"| {drift_a:.3f} m | {loops_a} |")
    print(f"| B: ICP relocalization | {ate_b:.3f} m | {umy_b:.3f} m "
          f"| {drift_b:.3f} m | {loops_b} |")
    print(f"\nreloc advantage: {ate_a / max(ate_b, 1e-9):.1f}x abs ATE, "
          f"{umy_a / max(umy_b, 1e-9):.1f}x Umeyama "
          f"(acceptance bar: >= 2x)", flush=True)
    return {"offset": offset, "A": {"abs": ate_a, "umeyama": umy_a,
                                    "drift": drift_a, "closures": loops_a},
            "B": {"abs": ate_b, "umeyama": umy_b, "drift": drift_b,
                  "closures": loops_b},
            "reloc": reloc_diag, "session1_s": s1_seconds,
            "session2_s": s2_seconds}


if __name__ == "__main__":
    main()
