"""Loop-closure recovery on the 766 m circuit (port of
``tools/eval_loop_recovery.py``).

In the reference's closure-enabled mode the submap is the recency deque
(mapOptmization.cpp:961-1000), with no implicit re-localization, so explicit
ICP closure (802-945) is the only drift-recovery mechanism.  A known rigid
drift is injected into the live state at the end of lap 1 (the step-function
form of accumulated error), and recovery through the revisit is measured:

  * OFF arm: recent-mode scan-to-map follows the drifted recent map; the
    error persists.
  * ON arm: detection finds the lap-1 keyframes within the 7 m radius, ICP
    measures the offset, the pose graph bends the chain back.

    python -m legoloam_tpu_torch.evals.loop_recovery [--pre 1100] [--post 600]
        [--drift-xy 3.0 1.8] [--drift-yaw 4.0] [--noise 0.03]

Range noise comes from one seeded ``torch.Generator`` a scan (both arms see
the same scans), not from the JAX package's PRNG keys, so the scans are not
bit-equal to the JAX tool's.
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser(prog="legoloam_tpu_torch.evals.loop_recovery",
                                 description=__doc__)
    ap.add_argument("--pre", type=int, default=1100,
                    help="scans before injection (957 a lap at half=100)")
    ap.add_argument("--post", type=int, default=600)
    ap.add_argument("--half", type=float, default=100.0)
    ap.add_argument("--drift-xy", type=float, nargs=2, default=[3.0, 1.8])
    ap.add_argument("--drift-yaw", type=float, default=4.0, help="degrees")
    ap.add_argument("--noise", type=float, default=0.03)
    ap.add_argument("--recent", type=int, default=60,
                    help="newest keyframes drifted (must cover the active "
                         "recency window, search_num=50)")
    ap.add_argument("--backend", default=None, choices=["cpu", "cuda"],
                    help="cpu to run on the CPU; default: the CUDA device")
    ap.add_argument("--preset", default="default",
                    choices=["default", "small"],
                    help="'small' shrinks map capacities (CPU runs)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..cli import small_preset
    from ..config import DEFAULT
    from ..device import resolve_device
    from ..models import pipeline, step_graph
    from ..ops import se3
    from ..ops.se3 import Pose
    from ..utils import synthetic
    from .kidnap import _clone

    dev = resolve_device(args.backend)
    base = small_preset(DEFAULT) if args.preset == "small" else DEFAULT

    def cfg_for(loop_on):
        return base.replace(
            mapping=dataclasses.replace(base.mapping, submap_mode="recent"),
            loop=dataclasses.replace(base.loop, enabled=loop_on))

    n = args.pre + args.post
    scene = synthetic.circuit_scene(args.half).to(dev)
    poses = synthetic.circuit_trajectory(n + 1, half=args.half, device=dev)
    R0 = poses.R[0].cpu().numpy()
    t0 = poses.t[0].cpu().numpy()
    gt = (poses.t[:n].cpu().numpy() - t0) @ R0

    def scan(k):
        gen = torch.Generator(device=dev).manual_seed(k)
        return synthetic.raycast_scan(
            scene, Pose(poses.R[k], poses.t[k]), DEFAULT.sensor,
            noise_sigma=args.noise, generator=gen,
            next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True)

    def run(cfg, state, sched, k_range):
        sg = step_graph.StepGraph(state, cfg)
        fused = []
        for k in k_range:
            out = sg.step(*scan(k), 0.1 * k,
                          run_mapping=(k % cfg.mapping_every == 0),
                          run_loop=sched.due(0.1 * k))
            fused.append(out.fused_pose.t)
        fused = torch.stack(fused).cpu().numpy()
        return sg.state, np.linalg.norm(fused - gt[list(k_range)], axis=1)

    cfg_off = cfg_for(False)
    state0, pre_errs = run(cfg_off, pipeline.init_slam_state(cfg_off, dev),
                           pipeline.LoopScheduler(cfg_off), range(args.pre))
    print(f"[pre] {args.pre} scans, err at injection {pre_errs[-1]:.3f} m, "
          f"kf {int(state0.mapping.kf.count)}", flush=True)

    # Inject the drift (the state surgery of
    # tests/test_loop_loadbearing.py:_inject_drift).  The yaw turns about
    # the CURRENT vehicle position (D = T_c Rz T_c^-1 + t): about the world
    # origin it would add a |yaw| x |p| lever arm (~10 m at 150 m out)
    # that swamps the intended drift and the 7 m detection radius.
    ang = np.radians(args.drift_yaw)
    Rz = torch.tensor([[np.cos(ang), -np.sin(ang), 0.0],
                       [np.sin(ang), np.cos(ang), 0.0], [0.0, 0.0, 1.0]],
                      dtype=torch.float32, device=dev)
    c = state0.mapping.t_aft.t
    drift = torch.tensor([*args.drift_xy, 0.0], dtype=torch.float32,
                         device=dev)
    D = Pose(Rz, drift + c - Rz @ c)
    kf = state0.mapping.kf
    m = kf.t.shape[0]
    count = int(kf.count)
    k0 = count - args.recent
    if k0 < 1:
        raise ValueError(f"--recent {args.recent} needs more than that many "
                         f"keyframes; the store holds {count}")
    idx = torch.arange(m, device=dev)
    hit = (idx >= k0) & (idx < count)
    R_new = torch.where(hit[:, None, None], D.R @ kf.R, kf.R)
    t_new = torch.where(hit[:, None], se3.rotate_vec(D.R, kf.t) + D.t, kf.t)
    rel = se3.relative(Pose(R_new[k0 - 1], t_new[k0 - 1]),
                       Pose(R_new[k0], t_new[k0]))
    chain_R, chain_t = kf.chain_R.clone(), kf.chain_t.clone()
    chain_R[k0], chain_t[k0] = rel.R, rel.t
    kf = kf._replace(R=R_new, t=t_new, chain_R=chain_R, chain_t=chain_t)
    mp = state0.mapping
    drifted = state0._replace(mapping=mp._replace(
        kf=kf, t_aft=se3.compose(D, mp.t_aft),
        cache=mp.cache._replace(stale=torch.ones_like(mp.cache.stale))))
    drift_mag = float(np.linalg.norm(args.drift_xy))
    print(f"[inject] |D| = {drift_mag:.2f} m + {args.drift_yaw:g} deg yaw "
          f"(vehicle-centered) into newest {args.recent} of {count} "
          f"keyframes", flush=True)

    # The mapping step updates its state in place: each arm gets a copy.
    post = range(args.pre, n)
    arm_off, arm_on = _clone(drifted), _clone(drifted)
    del state0, drifted
    s_off, e_off = run(cfg_off, arm_off, pipeline.LoopScheduler(cfg_off),
                       post)
    cfg_on = cfg_for(True)
    s_on, e_on = run(cfg_on, arm_on, pipeline.LoopScheduler(cfg_on), post)

    w = max(args.post // 6, 1)
    rows = []
    print(f"\n{'post-injection scans':>22} | {'closure OFF':>11} | "
          f"{'closure ON':>10}")
    for i in range(6):
        seg = slice(i * w, (i + 1) * w)
        if seg.start >= len(e_off):
            break
        rows.append((args.pre + i * w, args.pre + (i + 1) * w,
                     float(e_off[seg].mean()), float(e_on[seg].mean())))
        print(f"{rows[-1][0]:>10}-{rows[-1][1]:<11} | "
              f"{rows[-1][2]:>9.2f} m | {rows[-1][3]:>8.2f} m")
    final_off, final_on = float(e_off[-w:].mean()), float(e_on[-w:].mean())
    pre_level = float(pre_errs[-50:].mean())
    print(f"\nfinal-{w}-scan error:  OFF {final_off:.2f} m   "
          f"ON {final_on:.2f} m   (injected {drift_mag:.2f} m, "
          f"pre-injection level {pre_level:.2f} m)")
    print(f"closures accepted: {int(s_on.loops.count)}", flush=True)
    return {"rows": rows, "final_off": final_off, "final_on": final_on,
            "window": w, "pre_level": pre_level,
            "closures": int(s_on.loops.count), "injected": drift_mag}


if __name__ == "__main__":
    main()
