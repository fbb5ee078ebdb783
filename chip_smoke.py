#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's SLAM main path on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

  1. build the CUDA kernels from legoloam_tpu_torch/csrc (nvcc, sm_90a) and
     print ptxas's report (registers, shared memory, spills) per kernel;
  2. print the card's name and power limit;
  3. hold every kernel against its plain PyTorch version on the card, at the
     main path's shapes: K1 (CCL) exactly, on real synthetic scans and seeded
     random masks, also at the HDL-32E (32 x 1800) and VLS-128 (128 x 1800)
     shapes; K2 (picks) label for label on the main path's VLP-16 scans as
     they are and with ranges quantised to 1/256 m (ties at curvature 0),
     on ray-cast HDL-32E, VLS-128, OS1-16 and OS1-64 scans, at the
     REFERENCE pick counts, at sections 1 and 12, and on seeded stress rings
     (``picks_cases``); K3 (k-NN) at 8192 x 49152 and
     2048 x 12288 (k=5, gated), k=1 ungated, and two ragged shapes off the
     tile grid, against the plain version, plus duplicate-point ties across
     chunk and warp boundaries and every k = 1..8 at one ragged shape; in
     every K3 check (distance, index) must equal the exact search's
     (``knn_cuda.knn_exact``);
  4. run the full main path (frontend -> odometry -> scan-to-map every 3rd
     scan -> fusion) at the DEFAULT configuration (VLP-16 16x1800, submap
     caps 12288/49152, scan caps 2048/8192, 4096-keyframe store) over 96
     ring-world scans, with every kernel's launch count read around the run;
     fused ATE against ground truth < 0.2 m;
  5. run the first 6 scans on the card and on the CPU (plain versions):
     fused trajectories agree to 1e-3 m;
  6. time each kernel (wrapper call and bare launch), its plain version and,
     where one exists, a single PyTorch call computing the same function;
     K3 also at the main-path corner shape and a synthetic 1-NN shape
     (8192 x 49152, ungated), K1 also at the HDL-32E and VLS-128 shapes, K2
     also at the HDL-32E, VLS-128 and OS1-64 shapes and with 0, 28 and 56
     greedy trips (the prologue and the cost of a trip); K3's bound from
     the (query, reference) pairs within the gate; each kernel launch's
     device time from torch.profiler;
  7. loop closure at DEFAULT (loop enabled, an attempt a second, the time
     gate cut to 8 s) through run_slam_sequence over the revisit lap of
     tests/test_loop_e2e.py (260 scans at 1.05 m a scan): at least one
     accepted closure, fused ATE < 0.5 m, every stored rotation with
     |det - 1| < 1e-3, all finite; attempts, ICP iterations and ms per
     attempt; K3 bitwise against the exact search at the two ICP shapes
     (the accepted attempt's 10240 x 32768 clouds and relocalization's
     4096 x 16384), timed there as in 6, and the ICP's 3x3 rotation
     timed; the first accepted attempt again on the card and on the CPU
     from a copy of its store and factors, at DEFAULT: equal closure
     flags, fitness and corrected positions within the stated bounds;
  8. decimate_keyframes(keep_recent=32) on the loop run's final store on
     the card and on the CPU (counts, kept times, validity and factors
     equal, poses within 1e-5), and a 96-scan run_slam_sequence whose
     36-keyframe store maybe_decimate decimates mid-run;
  9. the IMU path (synthetic.make_imu along the main-path world) over the
     96 scans: fused ATE < 0.2 m, card vs CPU over 6 scans < 1e-3 m, the
     median ms of each stage of process_scan_with_imu;
 10. a resumed session on the loop run's map: fresh odometry, a rigid scan
     where the run's last sweep ended, the belief moved 20 m and 90 degrees
     from the last mapped pose; relocalize_slam_state accepts, < 0.3 m
     from ground truth (the map frame aligned as for the ATE);
 11. [io] 300 + 40 DEFAULT scans of the main-path world written as .lpk
     files and an IMU1 sidecar, read back by the prefetching ScanLoader
     (csrc/legoio.cpp, built with g++) bitwise equal;
 12. [cli] ``python -m legoloam_tpu_torch`` in a subprocess over the 300
     files with --imu --loop-closure, checkpoints and maps every 100 and
     debug dumps every 50: the five outputs, fused ATE < 0.2 m, a map,
     the checkpoint's keyframes = the mapped poses, the dumps' record names
     and pick labels equal to K2's on the same scans; its profile.txt;
 13. [cli resume] a second session from the checkpoint with --relocalize
     over 40 files from pose 150 (mid-course, the first scan rigid):
     accepted, map-frame error < 0.3 m RMS over scans 1..39;
 14. [export] assemble_global_map of the DEFAULT store, timed with its peak
     memory, against the CPU's map of the same keyframes (bounds stated at
     EXPORT_*);
 15. [memory] slam_state_bytes(DEFAULT) = 547,055,832 B, and the
     allocation around init_slam_state(DEFAULT) within 57 x 512 B of it;
 16. [kidnap] evals.kidnap at its defaults: B's abs ATE < 0.3 m and at
     least 2x better than A's;
 17. [recovery] evals.loop_recovery at its defaults: the ON arm's error
     over the last 100 scans under half the OFF arm's.
  Each path's kernel launches are counted around its run (the CLI runs
  report theirs in profile.txt); the kernels line sums them.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Needs no JAX and no network.
"""

import dataclasses
import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from legoloam_tpu_torch import DEFAULT
from legoloam_tpu_torch.config import REFERENCE, for_sensor
from legoloam_tpu_torch.models import (fusion, loopclosure, mapping,
                                       odometry, pipeline, posegraph,
                                       relocalize)
from legoloam_tpu_torch.ops import (_native, ccl_cuda, deskew, features,
                                    features_cuda, icp, knn_cuda, projection,
                                    se3, segmentation, voxel)
from legoloam_tpu_torch.ops.se3 import Pose, transform_points
from legoloam_tpu_torch.evals import kidnap as kidnap_eval
from legoloam_tpu_torch.evals import loop_recovery
from legoloam_tpu_torch.utils import (checkpoint, export, io, memory,
                                      metrics, synthetic)

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

N_SCANS = 96
N_PARITY_SCANS = 6
# The loop-closure run: tests/test_loop_e2e.py's revisit lap (1.05 m a
# scan, 1.4 laps) with the reference's 30 s time gate cut to 8 s.
LOOP_SCANS = 260
LOOP_TIME_GAP = 8.0
# Card vs CPU on one accepted attempt: the bounds on the two runs (the CPU's
# plain 1-NN may pick another of two equidistant references; sound runs
# agree to under 2e-4 m, and in fitness to the 5th digit or better).
ATTEMPT_FIT_REL = 5e-4
ATTEMPT_POS_TOL = 1e-3
# Decimation run: a 36-keyframe store fills to its 16-keyframe margin by
# scan 63 of the main-path world and is decimated mid-run.
DECIMATE_CAP = 36
DECIMATE_RECENT = 16
# Relocalization: the prior is moved by this much from the mapped pose.
RELOC_SHIFT_M = 20.0
RELOC_YAW_DEG = 90.0
KNN_REL_TOL = 1e-5
# The CLI sessions: the main-path world written as scan files.  Session 1
# covers 156 degrees of the ring; session 2 restarts mid-course at pose 150
# with a rigid scan, from session 1's checkpoint.
CLI_SCANS = 300
RESUME_SCANS = 40
RESUME_START = 150
CLI_TIMEOUT_S = 600
# The JAX package's debug-dump record names (legoloam_tpu/utils/
# debugdump.py): the frontend capture, the mapping-state scalars, and one
# record per odometry diagnostic.
DUMP_RECORDS = {
    "range", "xyz", "img_valid", "ground", "labels", "segmented", "outlier",
    "curvature", "pick_label", "sharp_xyz", "sharp_valid", "flat_xyz",
    "flat_valid", "feat_overflow", "kf_t", "kf_count", "kf_overflow",
    "submap_corner_occ", "submap_surf_occ", "submap_origin", "loop_count",
    "loop_dropped"} | {f"diag_{f}" for f in odometry.OdometryDiag._fields}
# Global map, card vs CPU: the two round the keyframe transforms
# differently, so a point within float32 rounding of a voxel face can land
# in the neighbouring voxel.  Bounds: at most 0.1% of the voxel cells in
# one map only, and 99.9% of the common cells' centroids within 1e-4 m
# (float atomics on the card sum in no fixed order).
EXPORT_CELLS_ONLY_ONE = 1e-3
EXPORT_CENTROID_TOL = 1e-4
EXPORT_CLOSE_SHARE = 0.999
# The state's 57 tensors: the allocator rounds each up to 512 bytes.
STATE_BYTES = 547055832
STATE_TENSORS = 57
# Rows where the plain k-NN's neighbour set differs from the kernel's, and
# gated rows compared, over the main path's two searches (see check_knn).
MAIN_PATH_DIFF = {"rows": 0, "of": 0}
K1_TALL = ("hdl32e", "vls128")              # K1 checked and timed there
K2_TALL = ("hdl32e", "vls128", "os1_64")    # K2 timed there


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call, from CUDA events around ``iters`` calls
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def make_scans(cfg, dev):
    """Distinct ring-world scans with motion distortion (the JAX package's
    bench.py --grow world) and the ground-truth trajectory."""
    scene = synthetic.loop_scene()
    poses = synthetic.circle_trajectory(N_SCANS + 1, radius=30.0,
                                        angular_rate=0.009, device=dev)
    scans = [synthetic.raycast_scan(
        scene, Pose(poses.R[k], poses.t[k]), cfg.sensor,
        next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True)
        for k in range(N_SCANS)]
    return scans, poses


def ccl_inputs(img, cfg):
    """K1 inputs (seeds, conn_h, conn_v) of one range image, as the main
    path forms them."""
    ground = segmentation.ground_removal(img, cfg.sensor, cfg.seg)
    conn_h, conn_v = segmentation._connectivity(img, cfg.sensor, cfg.seg)
    return img.valid & ~ground, conn_h, conn_v


def frontend_inputs(scan, cfg):
    """K1 inputs and K2 inputs (compacted ranges, columns, ground flags,
    counts) of one scan, as the main path forms them."""
    img = projection.project_scan(*scan[:2], cfg.sensor, ring=scan[2])
    k1 = ccl_inputs(img, cfg)
    seg = segmentation.segment(img, cfg.sensor, cfg.seg)
    c, count = features._compact_rings(img, seg)
    in_ring = torch.arange(img.rng.shape[1], device=count.device)[None] \
        < count[:, None]
    rng = torch.where(in_ring, c["rng"], torch.zeros_like(c["rng"]))
    k2 = (rng, c["col"], c["ground"], count)
    return k1, k2


def knn_sets(q_n, r_n, offset, gen, dev):
    """Morton-sorted references and queries ``offset`` m from the origin
    (the JAX package's tools/check_tpu_kernels.py inputs, scaled to the
    mapping caps)."""
    center = torch.tensor([offset, offset * 0.5, 0.0])
    spread = torch.tensor([12.0, 12.0, 1.0])
    raw = torch.randn(2 * r_n, 3, generator=gen) * spread + center
    ref, rv = voxel.voxel_downsample(
        raw.to(dev), torch.ones(2 * r_n, dtype=torch.bool, device=dev), 0.4,
        r_n, origin=center.to(dev))
    q = (torch.randn(q_n, 3, generator=gen) * torch.tensor([10.0, 10.0, 1.0])
         + center).to(dev)
    qv = torch.rand(q_n, generator=gen).to(dev) > 0.02
    return q, qv, ref, rv


def library_knn(q, qv, ref, rv, k):
    """Difference-form distances (torch.cdist without the matrix-product
    shortcut) and topk: the library yardstick for K3 (the port never calls
    it)."""
    q, ref = voxel.recentre(q, ref, rv)
    d = torch.cdist(q, ref, compute_mode="donot_use_mm_for_euclid_dist")
    d = torch.where(rv[None, :], d * d, torch.full_like(d, float("inf")))
    return torch.topk(d, k, dim=1, largest=False)


def tie_set(gen, dev, r_n=3000, q_n=900):
    """References with duplicated points (equal coordinates, different
    indices) within a chunk, across neighbouring chunks (which go to
    different warps), across chunks of one warp (WARPS chunks apart) and
    into the ragged last chunk; queries drawn next to them and on them."""
    ref = torch.randn(r_n, 3, generator=gen) * 3.0
    rc, w = knn_cuda.RC, knn_cuda.WARPS
    ref[rc:2 * rc] = ref[:rc]                       # neighbouring chunks
    ref[w * rc + 7:w * rc + 40] = ref[7:40]         # same warp, next round
    ref[1000:1010] = ref[1010:1020]                 # within one chunk
    ref[r_n - 3:] = ref[rc - 3:rc]                  # into the ragged chunk
    rv = torch.rand(r_n, generator=gen) > 0.05
    q = ref[torch.randint(0, r_n, (q_n,), generator=gen)]
    q = q + 0.01 * torch.randn(q_n, 3, generator=gen)
    q[::7] = ref[torch.randint(0, r_n, (len(q[::7]),), generator=gen)]
    qv = torch.rand(q_n, generator=gen) > 0.02
    return q.to(dev), qv.to(dev), ref.to(dev), rv.to(dev)


# ---------------------------------------------------------------------------
# Kernel parity
# ---------------------------------------------------------------------------

def check_ccl(name, k1_sets, cfg, gen):
    """K1 against its plain version, bit for bit, on the given scans' inputs
    and two seeded random masks of their shape."""
    cases = list(k1_sets)
    n, h = cases[0][0].shape
    dev = cases[0][0].device
    for _ in range(2):
        m = [torch.rand(s, generator=gen).to(dev) > 0.4
             for s in ((n, h), (n, h), (n - 1, h))]
        cases.append(tuple(m))
    for seeds, ch, cv in cases:
        got = ccl_cuda.label_propagation(seeds, ch, cv, cfg.seg.ccl_max_iters)
        *want, sweeps = ccl_cuda.label_propagation_plain(
            seeds, ch, cv, cfg.seg.ccl_max_iters)
        torch.cuda.synchronize()
        if sweeps >= cfg.seg.ccl_max_iters:
            fail(f"ccl {name}: the plain sweeps hit the cap; inputs not "
                 "comparable")
        for field, a, b in zip(("labels", "ring_min", "ring_max"), got, want):
            if not torch.equal(a, b):
                fail(f"ccl {name} {field}: {(a != b).sum().item()} cells "
                     "differ")
    log(f"[parity] ccl {name} {n}x{h}: {len(cases)} cases exactly equal")
    return 0.0


def quantised(k2):
    """K2 inputs with ranges on a 1/256 m grid: every curvature sum is
    exact, so flat ground ties at curvature exactly 0."""
    rng, col, ground, count = k2
    return torch.round(rng * 256.0) / 256.0, col, ground, count


def picks_cases(fe_vlp, tall, dev):
    """Every K2 check: (name, inputs, FeatureConfig, is a real scan).  The
    main path's three VLP-16 scans as they are and quantised; ray-cast
    scans at HDL-32E, VLS-128, OS1-16 and OS1-64; REFERENCE pick counts and
    sections 1 and 12 on VLP-16 scan 0; the seeded stress rings of
    ``synthetic.pick_stress_rings`` (counts 0..H, column gaps every few
    cells, ties at curvature 0, spikes on section boundaries) at sections
    1, 6, 12 and 32, H = 1800 and 1022 (rows off the 16-byte grid), and
    H = 4096 (shared-memory slabs, more than 48 KB of shared memory)."""
    ref = REFERENCE.feat
    feat = DEFAULT.feat
    cases = []
    for k, k2 in fe_vlp.items():
        cases.append((f"vlp16 scan {k}", k2, feat, True))
        cases.append((f"vlp16 scan {k} quantised", quantised(k2), feat, True))
    for name, (_, k2) in tall.items():
        cases.append((f"{name} scan", k2, for_sensor(name).feat, True))
    k2 = fe_vlp[min(fe_vlp)]
    cases.append(("vlp16 REFERENCE counts", k2, ref, True))
    cases.append(("vlp16 quantised REFERENCE counts", quantised(k2), ref,
                  True))
    for sections in (1, 12):
        cases.append((f"vlp16 sections={sections}", k2,
                      dataclasses.replace(feat, sections=sections), True))
    for sections, h in ((1, 1800), (6, 1800), (12, 1800), (32, 1800),
                        (6, 1022), (1, 4096), (12, 4096)):
        rings = synthetic.pick_stress_rings(sections + h, h, sections,
                                            device=dev)
        for counts, f in (("DEFAULT", feat), ("REFERENCE", ref)):
            cases.append((f"stress rings {len(rings[3])} x {h} sections="
                          f"{sections} {counts} counts", rings,
                          dataclasses.replace(f, sections=sections), False))
    return cases


def check_picks(cases):
    """K2 against its plain version on the card, label for label
    (``torch.equal``), on every case of ``picks_cases``."""
    for name, (rng, col, ground, count), f, real in cases:
        a = features_cuda.pick_labels(rng, col, ground, count, f)
        b = features_cuda.pick_labels_plain(rng, col, ground, count, f)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            fail(f"picks {name}: {(a != b).sum().item()} labels differ")
        if real and int((a != 0).sum()) < 100:
            fail(f"picks {name}: too few picks to be a real scan")
    log(f"[parity] picks: {len(cases)} cases exactly equal ("
        + "; ".join(name for name, *_ in cases) + ")")
    return 0.0


def check_knn(name, q, qv, ref, rv, k, gate, plain=True, main_path=False):
    """Kernel vs the exact search and, with ``plain``, vs the plain version,
    on the gated rows (every valid query whose exact k-th neighbour lies
    within the gate).

    Exact: the (distance, index) pairs equal the exact search's (ties to the
    lower index), so distances agree within KNN_REL_TOL relative.  Plain:
    where the neighbour sets agree the distances agree within KNN_REL_TOL;
    the plain version selects by the matrix-form distance, whose float32
    quantisation at submap scale can drop a co-quantised neighbour, so where
    the sets differ the kernel's neighbours are never farther than the plain
    version's, and such rows stay under 1% of the check's rows.  The two
    ``main_path`` checks (283 gated rows in the corner search, where 1-2%
    can occur by chance) take that 1% over both together
    (``check_main_path_rate``)."""
    d_k, i_k = knn_cuda.knn(q, qv, ref, rv, k, gate=gate)
    d_e, i_e = knn_cuda.knn_exact(q, qv, ref, rv, k)
    torch.cuda.synchronize()
    gsq = gate ** 2 if gate is not None else float("inf")
    rows = qv & (d_e[:, k - 1] < gsq)
    n_rows = int(rows.sum())
    if n_rows < 100:
        fail(f"knn {name}: only {n_rows} gated rows")
    if not (i_k[rows] < ref.shape[0]).all() or not rv[i_k[rows]].all():
        fail(f"knn {name}: an invalid reference was returned")
    if not (d_k[~qv] >= 1e29).all() or (i_k[~qv] != 0).any():
        fail(f"knn {name}: invalid queries must get (1e30, 0) rows")
    rel_e = ((d_k - d_e).abs() / d_e.clamp(min=1e-12))[rows]
    if float(rel_e.max()) > KNN_REL_TOL:
        fail(f"knn {name}: max rel err vs exact {float(rel_e.max()):.3g}")
    same_e = ((d_k == d_e) & (i_k == i_e)).all(1) & rows
    if int(same_e.sum()) != n_rows:
        fail(f"knn {name}: {n_rows - int(same_e.sum())} rows differ from "
             "the exact search's (distance, index) pairs")
    msg = (f"[parity] knn {name}: {n_rows} gated rows, max rel err vs exact "
           f"{float(rel_e.max()):.3g}, (distance, index) equal to the exact "
           f"search's in every row")
    if not plain:
        log(msg)
        return 0.0
    d_p, i_p = voxel.knn(q, qv, ref, rv, k)
    same = (torch.sort(i_k, 1)[0] == torch.sort(i_p, 1)[0]).all(1) & rows
    diff_rows = rows & ~same
    err = (d_k - d_p).abs()[same]
    rel_p = (err / d_p[same].clamp(min=1e-12)).max() if err.numel() else 0.0
    if float(rel_p) > KNN_REL_TOL:
        fail(f"knn {name}: max rel err vs plain {float(rel_p):.3g}")
    if (d_k[diff_rows] > d_p[diff_rows] * (1 + KNN_REL_TOL)).any():
        fail(f"knn {name}: kernel neighbour farther than the plain one")
    n_diff = int(diff_rows.sum())
    if main_path:
        MAIN_PATH_DIFF["rows"] += n_diff
        MAIN_PATH_DIFF["of"] += n_rows
    elif n_diff > 0.01 * n_rows:
        fail(f"knn {name}: {n_diff} of {n_rows} rows differ from the plain "
             "version")
    log(f"{msg}; vs plain {float(rel_p):.3g}, {n_diff} rows where the plain "
        f"version missed a co-quantised neighbour")
    return float(err.max()) if err.numel() else 0.0


def check_main_path_rate():
    n, of = MAIN_PATH_DIFF["rows"], MAIN_PATH_DIFF["of"]
    log(f"[parity] knn main path: the plain version's neighbour set differs "
        f"from the kernel's in {n} of {of} gated rows")
    if n > 0.01 * of:
        fail(f"knn main path: {n} of {of} rows differ from the plain version")


def stage_times(scans, cfg, dev):
    """Host-clock milliseconds per call of each pipeline stage, with the
    card synchronised around every call (the steps of slam_scan_step, minus
    the scan-1 bootstrap re-solves)."""
    state = pipeline.init_slam_state(cfg, dev)
    acc = {"frontend": [], "odometry": [], "mapping": [], "fusion": []}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        acc[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for k, (pts, valid, ring) in enumerate(scans):
        feats = timed("frontend", lambda: pipeline.process_scan(
            pts, valid, ring, cfg))
        odom, pose, _ = timed("odometry", lambda: odometry.odometry_step(
            state.odom, feats, cfg.odom))
        mstate = state.mapping
        if k % cfg.mapping_every == 0:
            mstate, _, _ = timed("mapping", lambda: mapping.mapping_step(
                mstate, odom.last_corner, odom.last_surf, odom.last_outlier,
                pose, k * cfg.sensor.scan_period, cfg.mapping,
                ground_cloud=odom.last_flat))
        timed("fusion", lambda: fusion.fuse(pose, mstate.t_bef,
                                            mstate.t_aft))
        state = state._replace(odom=odom, mapping=mstate)
    return {name: sorted(v)[len(v) // 2] for name, v in acc.items()}


def bare_ccl(seeds, ch, cv):
    """The K1 entry point on prepared device buffers (no wrapper checks)."""
    lib = _native.library()
    n, h = seeds.shape
    bufs = [torch.empty(n * h, dtype=torch.int32, device=seeds.device)
            for _ in range(5)]
    st = _native.stream_handle(seeds)
    return lambda: lib.ccl_launch(seeds.data_ptr(), ch.data_ptr(),
                                  cv.data_ptr(), *(b.data_ptr() for b in bufs),
                                  n, h, st)


def bare_picks(rng, col, grd, cnt, f):
    lib = _native.library()
    n, h = rng.shape
    out = torch.empty((n, h), dtype=torch.int32, device=rng.device)
    st = _native.stream_handle(rng)
    return lambda: lib.picks_launch(
        rng.data_ptr(), col.data_ptr(), grd.data_ptr(), cnt.data_ptr(),
        out.data_ptr(), n, h, f.sections, f.curvature_halfwin,
        f.edge_less_per_section, f.edge_per_section, f.surf_per_section,
        f.edge_threshold, f.surf_threshold, f.occlusion_col_gap,
        f.occlusion_range_jump, f.parallel_beam_frac, st)


def bare_knn(q, qv, ref, rv, k, gate):
    lib = _native.library()
    if ref.data_ptr() % 16 or rv.data_ptr() % 16:
        fail("bare knn: references must be 16-byte aligned")
    q_n, r_n = q.shape[0], ref.shape[0]
    n_chunks = (r_n + knn_cuda.RC - 1) // knn_cuda.RC
    boxes = torch.empty(2 * n_chunks * 3, device=q.device)
    d = torch.empty((q_n, k), device=q.device)
    i = torch.empty((q_n, k), dtype=torch.int64, device=q.device)
    st = _native.stream_handle(q)
    return lambda: lib.knn_launch(
        q.data_ptr(), qv.data_ptr(), ref.data_ptr(), rv.data_ptr(),
        boxes.data_ptr(), boxes.data_ptr() + 12 * n_chunks, d.data_ptr(),
        i.data_ptr(), None, q_n, r_n, k,
        gate ** 2 if gate is not None else 0.0, int(gate is not None), st)


def bare_ms(fn, iters: int = 200) -> float:
    """Milliseconds per bare launch (the C entry point on prepared device
    buffers, without the wrapper's checks and input preparation)."""
    _native.check(fn(), "bare launch")
    return time_ms(fn, iters)


def device_us_per_launch(fn, calls: int = 20, sessions: int = 3):
    """Device microseconds per launch of each CUDA kernel that ``fn`` runs,
    from torch.profiler over ``calls`` calls.  A session that records no
    kernel, or a kernel fewer times than it was called (the profiler drops
    some records now and then), is run again, up to ``sessions`` times.  If
    none records every launch, the last session's mean over the launches
    it recorded is returned and the record counts are logged; empty if no
    session recorded a kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = {}
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rec = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", 0.0)
            if us > 0:
                m = re.search(r"(\w+)(?:<[^>]*>)?\(", e.key)
                rec[m.group(1) if m else e.key] = (us, e.count)
        seen = rec or seen
        if rec and all(n >= calls for _, n in rec.values()):
            break
    else:
        log(f"[profile] no session of {sessions} recorded every launch of "
            f"{calls} calls; the mean over the launches recorded: "
            + (", ".join(f"{k} {n}" for k, (_, n) in seen.items())
               or "none"))
    return {k: us / n for k, (us, n) in seen.items()}


def knn_bytes(q_n, r_n, k):
    """Each input read once (points and masks), each output written once
    (float32 distance and int64 index per slot)."""
    return 13 * (q_n + r_n) + 12 * k * q_n


def ccl_bytes(n, h):
    return (2 * n * h + (n - 1) * h) + 3 * 4 * n * h


def picks_bytes(n, h):
    """Ranges, columns and ground flags read, labels written, counts."""
    return (4 + 4 + 1 + 4) * n * h + 4 * n


def picks_ops(n, h):
    """Curvature (12 flops a cell) and the occlusion and parallel tests
    (~8)."""
    return 20.0 * n * h


# ---------------------------------------------------------------------------
# The loop-closure, IMU, decimation and relocalization paths
# ---------------------------------------------------------------------------

def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def to_device(tree, dev):
    """Every tensor of a tree of tuples on ``dev``."""
    if isinstance(tree, tuple):
        parts = (to_device(a, dev) for a in tree)
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    return tree.to(dev)


def counted(fn):
    """Run ``fn`` with the launch counts set to 0 just before it; returns
    (its result, the launches of each kernel in it)."""
    _native.reset_counts()
    out = fn()
    return out, {name: k.launches for name, k in _native.KERNELS.items()}


class AttemptLog:
    """Stands in for ``loopclosure.close_and_correct`` during the loop run.
    Per attempt: host milliseconds with the card synchronised around it,
    K3 launches inside it (ICP iterations + 1 when a candidate exists), the
    candidate, the fitness and the acceptance.  At the first accepted
    attempt: a copy of the store and factors it was given, and its ICP
    clouds (the latest keyframe in world, the candidate's history cloud)."""

    def __init__(self):
        self.fn = loopclosure.close_and_correct
        self.rows = []
        self.first = None

    def __call__(self, kf, loops, cfg, pg_cfg):
        knn_k = _native.KERNELS["knn"]
        sync(kf.t.device)
        n0, t0 = knn_k.launches, time.perf_counter()
        out = self.fn(kf, loops, cfg, pg_cfg)
        sync(kf.t.device)
        ms = (time.perf_counter() - t0) * 1e3
        diag = out[3]
        closed, cand = bool(diag.closed), int(diag.candidate)
        self.rows.append({"ms": ms, "knn": knn_k.launches - n0,
                          "candidate": cand, "closed": closed,
                          "fitness": float(diag.fitness)})
        if closed and self.first is None:
            cur = int(kf.count) - 1
            self.first = {
                "kf": type(kf)(*(a.clone() for a in kf)), "loops": loops,
                "cur": loopclosure._world_cloud(kf, cur),
                "hist": loopclosure._history_cloud(
                    kf, torch.tensor(cand, device=kf.t.device), cfg)}
        return out


class CallTimer:
    """Stands in for ``fn`` while installed: host milliseconds of each
    call, the card synchronised around it."""

    def __init__(self, fn):
        self.fn = fn
        self.ms = []

    def __call__(self, *args, **kwargs):
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        sync(dev)
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        sync(dev)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def loop_run(cfg, dev, n_scans=LOOP_SCANS):
    """``run_slam_sequence`` with loop closure on the revisit lap, with
    every attempt logged and each attempt's ICP and pose-graph solve timed
    (``log.icp``, ``log.solve``).  Returns (fused, state, poses, log,
    seconds)."""
    scene = synthetic.loop_scene()
    poses = synthetic.circle_trajectory(n_scans + 1, radius=30.0,
                                        angular_rate=0.035, device=dev)
    scans = [synthetic.raycast_scan(
        scene, Pose(poses.R[k], poses.t[k]), cfg.sensor,
        next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True)
        for k in range(n_scans)]
    log = AttemptLog()
    log.icp = CallTimer(icp.icp)
    log.solve = CallTimer(posegraph.optimize)
    loopclosure.close_and_correct = log
    icp.icp, posegraph.optimize = log.icp, log.solve
    try:
        sync(dev)
        t0 = time.perf_counter()
        fused, state = pipeline.run_slam_sequence(
            scans, cfg, times=[0.1 * k for k in range(n_scans)], device=dev)
        sync(dev)
        seconds = time.perf_counter() - t0
    finally:
        loopclosure.close_and_correct = log.fn
        icp.icp, posegraph.optimize = log.icp.fn, log.solve.fn
    return fused, state, poses, log, seconds


def attempt_card_vs_cpu(first, cfg, dev):
    """The first accepted attempt's store and factors, through
    ``close_and_correct`` on the card and on the CPU: (closed on each,
    fitness on each, the largest corrected keyframe position difference,
    CPU seconds)."""
    kf = first["kf"]
    out = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        k2, _, _, diag = loopclosure.close_and_correct(
            to_device(kf, where), to_device(first["loops"], where), cfg.loop,
            cfg.posegraph)
        sync(where)
        out[str(where)] = (bool(diag.closed), float(diag.fitness),
                           k2.t.cpu(), time.perf_counter() - t0)
    (cg, fg, tg, _), (cc, fc, tc, sec) = out[str(dev)], out["cpu"]
    n = int(kf.count)
    gap = float((tg[:n] - tc[:n]).abs().max())
    return (cg, cc), (fg, fc), gap, sec


def decimate_card_vs_cpu(kf, loops, dev, keep_recent=32):
    """``decimate_keyframes`` on the card and on the CPU from the same
    store: (count, loop count, dropped, whether counts, kept times, loop
    endpoints and validity are equal, the largest pose difference)."""
    g = mapping.decimate_keyframes(kf, loops, keep_recent=keep_recent)
    c = mapping.decimate_keyframes(to_device(kf, "cpu"),
                                   to_device(loops, "cpu"),
                                   keep_recent=keep_recent)
    (gk, gl), (ck, cl) = to_device(g, "cpu"), c
    exact = (torch.equal(gk.count, ck.count)
             and torch.equal(gk.time, ck.time)
             and torch.equal(gk.corner_valid, ck.corner_valid)
             and torch.equal(gk.surf_valid, ck.surf_valid)
             and all(torch.equal(getattr(gl, f), getattr(cl, f))
                     for f in ("i", "j", "valid", "count", "dropped")))
    pairs = [(getattr(gk, f), getattr(ck, f))
             for f in ("R", "t", "chain_R", "chain_t")]
    pairs += [(gl.R, cl.R), (gl.t, cl.t)]
    pose_gap = max(float((a - b).abs().max()) for a, b in pairs)
    return int(gk.count), int(gl.count), int(gl.dropped), exact, pose_gap


def imu_integral(poses):
    ts, rpy, acc, gyro = synthetic.make_imu(poses)
    return deskew.integrate_imu(deskew.ImuWindow(
        ts, rpy, acc, gyro, torch.ones(ts.shape[0], dtype=torch.bool,
                                       device=ts.device)))


def imu_run(scans, integ, cfg, dev):
    """``slam_scan_step`` with the IMU integral over ``scans`` (the
    run_slam_sequence cadence); returns the fused positions."""
    state = pipeline.init_slam_state(cfg, dev)
    integ = to_device(integ, dev)
    fused = []
    for k, s in enumerate(scans):
        state, out = pipeline.slam_scan_step(
            state, *(a.to(dev) for a in s), cfg, k * cfg.sensor.scan_period,
            run_mapping=(k % cfg.mapping_every == 0), imu_integral=integ,
            bootstrap=(k == 1))
        fused.append(out.fused_pose.t)
    return torch.stack(fused)


def imu_stage_times(scans, integ, cfg, dev, n=12):
    """Median host-clock ms of each stage of ``process_scan_with_imu`` over
    ``n`` scans, the card synchronised around every stage."""
    acc = {"projection": [], "segmentation": [], "deskew": [],
           "features": []}

    def timed(name, fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        acc[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for k, (pts, valid, ring) in enumerate(scans[:n]):
        img = timed("projection", lambda: projection.project_scan(
            pts, valid, cfg.sensor, ring=ring))
        seg = timed("segmentation", lambda: segmentation.segment(
            img, cfg.sensor, cfg.seg))
        dsk = timed("deskew", lambda: deskew.deskew_image(
            img.xyz, img.rel_time, img.valid, k * cfg.sensor.scan_period,
            integ, scan_period=cfg.sensor.scan_period))
        timed("features", lambda: features.extract_features(
            img, seg, cfg.sensor, cfg.feat, xyz_deskewed=dsk.xyz))
    return {name: sorted(v)[len(v) // 2] for name, v in acc.items()}


def kidnap(state, shift_m=RELOC_SHIFT_M, yaw_deg=RELOC_YAW_DEG):
    """The state with its belief (``t_aft``) moved by ``shift_m`` along
    map x and turned by ``yaw_deg`` about z."""
    mp = state.mapping
    dev = mp.t_aft.t.device
    Rz = se3.rot_z(torch.tensor(math.radians(yaw_deg), device=dev))
    moved = Pose(Rz @ mp.t_aft.R,
                 mp.t_aft.t + torch.tensor([shift_m, 0.0, 0.0], device=dev))
    return state._replace(mapping=mp._replace(t_aft=moved))


def reloc_clouds(state, cfg, placement: Pose):
    """Kernel K3's inputs at the relocalization shape: the current scan's
    cloud bounded to ``cur_cap`` and placed at ``placement``, and the
    latest keyframe's ±``window`` submap."""
    od, mp = state.odom, state.mapping
    pts, val = voxel.voxel_representative(
        torch.cat([od.last_corner.xyz, od.last_surf.xyz]),
        torch.cat([od.last_corner.valid, od.last_surf.valid]),
        cfg.reloc.scan_leaf, cfg.reloc.cur_cap)
    hist = loopclosure.window_cloud(
        mp.kf, mp.kf.count.long() - 1, cfg.reloc.window,
        cfg.reloc.submap_leaf, cfg.reloc.hist_cap)
    return (transform_points(placement, pts), val) + hist


def ground_truth(poses, n):
    """Ground-truth positions of scans 0..n-1.  A scan is ray-cast while
    the sensor moves from trajectory pose k to pose k + 1 and the pipeline
    places it where its sweep ended, so scan k's ground truth is pose
    k + 1."""
    return poses.t[1:n + 1]


# ---------------------------------------------------------------------------
# The command-line entry point, the utilities and the evaluations
# ---------------------------------------------------------------------------

def write_session(d, scene, poses, first, n, sensor, rigid_first=False):
    """Ray-cast scans ``first .. first + n - 1`` of ``poses`` (scan k sweeps
    from pose k to k + 1; with ``rigid_first`` the first is taken at rest)
    and write each as ``d/scan_NNNN.lpk``.  Returns the paths and, per scan,
    the (xyz, ring) numpy arrays of the points written."""
    os.makedirs(d, exist_ok=True)
    paths, written = [], []
    for j in range(n):
        k = first + j
        if rigid_first and j == 0:
            pts, valid, ring = synthetic.raycast_scan(
                scene, Pose(poses.R[k], poses.t[k]), sensor)
        else:
            pts, valid, ring = synthetic.raycast_scan(
                scene, Pose(poses.R[k], poses.t[k]), sensor,
                next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True)
        path = os.path.join(d, f"scan_{j:04d}.lpk")
        io.write_lpk(path, pts, ring, valid)
        v = valid.cpu().numpy()
        written.append((pts.cpu().numpy()[v], ring.cpu().numpy()[v]))
        paths.append(path)
    return paths, written


def check_read_back(paths, written, sensor):
    """Read the files back with the prefetching ``ScanLoader``: every scan
    bitwise equal to the points written, padded with invalid zeros.
    Returns the read rate in scans/s."""
    t0 = time.perf_counter()
    n = 0
    with io.ScanLoader(paths, point_cap=sensor.n_points,
                       n_scan=sensor.n_scan,
                       ang_bottom_deg=sensor.ang_bottom_deg,
                       ang_res_y_deg=sensor.ang_res_y_deg) as loader:
        for (xyz, valid, ring), (w_xyz, w_ring) in zip(loader, written):
            m = w_xyz.shape[0]
            if not (np.array_equal(xyz[:m], w_xyz)
                    and np.array_equal(ring[:m], w_ring.astype(np.int32))
                    and valid[:m].all() and not valid[m:].any()
                    and not xyz[m:].any() and not ring[m:].any()):
                fail(f"io: scan {n} read back differs from what was "
                     "written")
            n += 1
    seconds = time.perf_counter() - t0
    if n != len(paths):
        fail(f"io: {n} of {len(paths)} scans read back")
    return n / seconds


def run_cli(args, what):
    """``python -m legoloam_tpu_torch`` in a subprocess on the card; returns
    its standard output.  Fails with the end of its output if it fails."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "legoloam_tpu_torch", *args],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=CLI_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"{what}: exit {res.returncode}\n{res.stdout[-3000:]}\n"
             f"{res.stderr[-3000:]}")
    return res.stdout, res.stderr, seconds


def cli_launches(out_dir):
    """The run's kernel launches, from the CLI's profile.txt."""
    text = open(os.path.join(out_dir, "profile.txt")).read()
    m = re.search(r"^kernel launches: (.*)$", text, re.M)
    if not m:
        fail(f"cli: no kernel launches in {out_dir}/profile.txt")
    counts = dict(part.rsplit(" ", 1) for part in m.group(1).split(", "))
    return {name: int(counts.get(name, 0)) for name in _native.KERNELS}


def check_dumps(dump_dir, paths, cfg, dev):
    """Every debug record holds the JAX package's record names, and its
    pick labels equal kernel K2's on the same scan read from its file.
    Returns the scan indices checked."""
    files = sorted(glob.glob(os.path.join(dump_dir, "scan_*.npz")))
    if not files:
        fail("cli: no debug dumps written")
    checked = []
    for f in files:
        k = int(os.path.basename(f)[5:11])
        rec = np.load(f)
        if set(rec.files) != DUMP_RECORDS:
            fail(f"cli: dump {k} records differ from the JAX package's: "
                 f"{sorted(set(rec.files) ^ DUMP_RECORDS)}")
        scan = tuple(torch.from_numpy(a).to(dev) for a in io.read_scan(
            paths[k], cfg.sensor.n_points, cfg.sensor.n_scan,
            cfg.sensor.ang_bottom_deg, cfg.sensor.ang_res_y_deg))
        _, k2 = frontend_inputs(scan, cfg)
        labels = features_cuda.pick_labels(*k2, cfg.feat)
        if not np.array_equal(rec["pick_label"],
                              labels.to(torch.int8).cpu().numpy()):
            fail(f"cli: dump {k} pick labels differ from K2's")
        checked.append(k)
    return checked


def tum_positions(path):
    return torch.from_numpy(np.loadtxt(path, ndmin=2)[:, 1:4]).float()


def export_card_vs_cpu(kf, n_kf, dev):
    """``assemble_global_map`` of the whole DEFAULT store on the card, timed
    with its peak memory; and the same map from the store's first
    ``n_kf`` slots on the CPU (the slots beyond the count add nothing).
    Returns (card voxels, card ms, peak bytes above the allocation before,
    CPU voxels, voxel cells in one set only, the share of the cells in both
    whose centroids agree within EXPORT_CENTROID_TOL, the largest centroid
    difference)."""
    leaf = 0.4
    export.assemble_global_map(kf)              # warm: allocator, kernels
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pts, val = export.assemble_global_map(kf, leaf=leaf)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    cpu_kf = type(kf)(*(a[:n_kf].cpu() if a.dim() and a.shape[0] ==
                        kf.t.shape[0] else a.cpu() for a in kf))
    c_pts, c_val = export.assemble_global_map(cpu_kf, leaf=leaf)
    g = {tuple(c): p for c, p in zip(
        torch.floor(pts[val] / leaf).long().cpu().tolist(),
        pts[val].cpu())}
    c = {tuple(c): p for c, p in zip(
        torch.floor(c_pts[c_val] / leaf).long().tolist(), c_pts[c_val])}
    common = sorted(g.keys() & c.keys())
    diff = (torch.stack([g[k] for k in common])
            - torch.stack([c[k] for k in common])).abs().amax(dim=1)
    close = float((diff <= EXPORT_CENTROID_TOL).float().mean())
    return (int(val.sum()), ms, peak, int(c_val.sum()),
            len(g.keys() ^ c.keys()), close, float(diff.max()))


def cli_phases(work, cfg, dev, card, paths):
    """[io], [cli], [cli resume], [export], [memory]: the main-path world
    written as scan files and replayed by ``python -m legoloam_tpu_torch``
    in two sessions; each CLI run's kernel launches go into ``paths``."""
    # 11. Scan files and the IMU sidecar, read back by the loader.
    scene = synthetic.loop_scene().to(dev)
    poses = synthetic.circle_trajectory(CLI_SCANS + 1, radius=30.0,
                                        angular_rate=0.009, device=dev)
    t0 = time.perf_counter()
    s1, w1 = write_session(os.path.join(work, "s1"), scene, poses, 0,
                           CLI_SCANS, cfg.sensor)
    s2, w2 = write_session(os.path.join(work, "s2"), scene, poses,
                           RESUME_START, RESUME_SCANS, cfg.sensor,
                           rigid_first=True)
    imu_path = os.path.join(work, "session1.imu")
    ts, rpy, acc, gyro = synthetic.make_imu(poses)
    io.write_imu(imu_path, ts, rpy, acc, gyro)
    t_write = time.perf_counter() - t0
    mb = sum(os.path.getsize(p) for p in s1 + s2) / 2**20
    rate = check_read_back(s1 + s2, w1 + w2, cfg.sensor)
    log(f"[io] {len(s1) + len(s2)} DEFAULT scans ray-cast and written as "
        f".lpk ({mb:.1f} MiB) and an IMU1 sidecar of {ts.shape[0]} samples "
        f"in {t_write:.2f} s; read back by ScanLoader bitwise equal at "
        f"{rate:.1f} scans/s (library {io.library_path().parent.name})")

    # 12. The CLI over session 1 on the card.
    out1 = os.path.join(work, "cli")
    dump = os.path.join(work, "dump")
    stdout, stderr, sec = run_cli(
        ["--scans", os.path.join(work, "s1", "*.lpk"), "--imu", imu_path,
         "--loop-closure", "--checkpoint-every", "100", "--map-every", "100",
         "--debug-dump", dump, "--debug-every", "50", "--out", out1], "cli")
    names = ["trajectory_fused.txt", "trajectory_mapped.txt",
             "global_map.pcd", "checkpoint.npz", "profile.txt"]
    missing = [n for n in names if not os.path.exists(os.path.join(out1, n))]
    if missing:
        fail(f"cli: outputs missing: {missing}")
    done = [ln for ln in stdout.splitlines()
            if ln.startswith("[legoloam_tpu_torch] done:")]
    fused = tum_positions(os.path.join(out1, "trajectory_fused.txt"))
    if fused.shape != (CLI_SCANS, 3) or not done:
        fail(f"cli: {fused.shape[0]} trajectory lines, done line {done}")
    ate = float(metrics.ate_rmse(fused, ground_truth(poses, CLI_SCANS).cpu()))
    n_pcd = export.read_pcd_xyz(os.path.join(out1, "global_map.pcd")).shape[0]
    ck = checkpoint.load_state(os.path.join(out1, "checkpoint.npz"),
                               pipeline.init_slam_state(cfg, dev))
    n_kf = int(ck.mapping.kf.count)
    n_mapped = np.loadtxt(os.path.join(out1, "trajectory_mapped.txt"),
                          ndmin=2).shape[0]
    checked = check_dumps(dump, s1, cfg, dev)
    paths["cli"] = cli_launches(out1)
    log(f"[cli] python -m legoloam_tpu_torch over {CLI_SCANS} files with "
        f"--imu --loop-closure, checkpoints and maps every 100, dumps every "
        f"50: {sec:.1f} s in the subprocess; {done[0]}; fused ATE "
        f"{ate:.4f} m; global_map.pcd {n_pcd} points; checkpoint {n_kf} "
        f"keyframes, {int(ck.loops.count)} loop factors, "
        f"trajectory_mapped.txt {n_mapped} lines; dumps of scans {checked} "
        f"hold the JAX record names and K2's labels; launches "
        f"{paths['cli']} [{card}]")
    for line in open(os.path.join(out1, "profile.txt")).read().splitlines():
        log(f"[cli profile] {line}")
    for line in stderr.splitlines():
        if "warning" in line:
            log(f"[cli] {line}")
    if not ate < 0.2:
        fail(f"cli: fused ATE {ate:.4f} m >= 0.2 m")
    if n_pcd <= 0 or n_kf != n_mapped or n_kf <= 0:
        fail(f"cli: {n_pcd} map points, {n_kf} keyframes in the checkpoint "
             f"against {n_mapped} mapped poses")

    # 13. Session 2 resumed from the checkpoint, relocalized, mid-course.
    out2 = os.path.join(work, "resume")
    stdout, _, sec = run_cli(
        ["--scans", os.path.join(work, "s2", "*.lpk"), "--resume",
         os.path.join(out1, "checkpoint.npz"), "--relocalize", "--out",
         out2], "cli resume")
    m = re.search(r"^\[reloc\] accepted=(\w+) candidate=(-?\d+) "
                  r"fitness=(\S+)$", stdout, re.M)
    est = tum_positions(os.path.join(out2, "trajectory_fused.txt"))
    # Scan j >= 1 sweeps to pose RESUME_START + j + 1; the map frame is
    # session 1's, where its scan 0 ended (pose 1).
    j = torch.arange(1, RESUME_SCANS)
    gt = ((poses.t[RESUME_START + 1 + j] - poses.t[1]) @ poses.R[1]).cpu()
    err = (est[1:] - gt).norm(dim=1) if est.shape[0] == RESUME_SCANS \
        else torch.full((1,), float("inf"))
    rms = float(err.square().mean().sqrt())
    paths["cli resume"] = cli_launches(out2)
    log(f"[cli resume] --resume --relocalize over {RESUME_SCANS} files from "
        f"pose {RESUME_START} (first scan rigid): {sec:.1f} s; "
        f"{m.group(0) if m else 'no [reloc] line'}; map-frame error over "
        f"scans 1..{RESUME_SCANS - 1} RMS {rms:.4f} m, max "
        f"{float(err.max()):.4f} m; launches {paths['cli resume']} [{card}]")
    if not m or m.group(1) != "True" or not rms < 0.3:
        fail("cli resume: relocalization not accepted or error >= 0.3 m")

    # 14. The global map at DEFAULT, card vs CPU.
    n_vox, ms, peak, n_cpu, only_one, close, gap = export_card_vs_cpu(
        ck.mapping.kf, n_kf, dev)
    slots = ck.mapping.kf.t.shape[0]
    n_pts = slots * (cfg.mapping.scan_corner_cap + cfg.mapping.scan_surf_cap)
    held = torch.cuda.memory_allocated() / 2**30
    log(f"[export] assemble_global_map of the {slots}-slot store ({n_kf} "
        f"keyframes; every slot transformed, {n_pts} points): {n_vox} "
        f"voxels in {ms:.2f} ms, peak allocated {peak / 2**30:.3f} GiB "
        f"above the {held:.3f} GiB held; CPU from the first {n_kf} slots "
        f"{n_cpu} voxels, "
        f"{only_one} cells in one map only, {close:.6f} of the common "
        f"centroids within {EXPORT_CENTROID_TOL} m (largest difference "
        f"{gap:.3g} m) [{card}]")
    if n_vox <= 0 or only_one > EXPORT_CELLS_ONLY_ONE * n_vox \
            or close < EXPORT_CLOSE_SHARE:
        fail("export: card and CPU maps outside the stated bounds")

    # 15. The state's bytes: from shapes alone, and as allocated.
    del ck
    total = memory.slam_state_bytes(cfg)["total"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fresh = pipeline.init_slam_state(cfg, dev)
    torch.cuda.synchronize()
    delta = torch.cuda.memory_allocated() - before
    log(f"[memory] slam_state_bytes(DEFAULT) {total} B; allocated around "
        f"init_slam_state(DEFAULT) {delta} B ({delta - total:+d}); "
        f"allocator {memory.measured(dev)}")
    for line in memory.summary(cfg, 16).splitlines():
        log(f"[memory] {line}")
    del fresh
    if total != STATE_BYTES or abs(delta - total) > STATE_TENSORS * 512:
        fail(f"memory: {total} B from shapes, {delta} B allocated")


def eval_phases(dev, card, paths):
    """[kidnap] and [recovery]: the two end-to-end evaluations at their
    defaults, with their kernel launches counted into ``paths``."""
    t0 = time.perf_counter()
    res, paths["kidnap"] = counted(lambda: kidnap_eval.main([]))
    a, b = res["A"]["abs"], res["B"]["abs"]
    log(f"[kidnap] evals.kidnap at its defaults (800 + 200 scans, 128 "
        f"candidates): {time.perf_counter() - t0:.1f} s; A {a:.3f} m, B "
        f"{b:.3f} m abs ATE ({a / max(b, 1e-9):.1f}x), relocalization "
        f"{res['reloc']}; session 1 {res['session1_s']:.1f} s, session 2 "
        f"{res['session2_s']:.1f} s; launches {paths['kidnap']} [{card}]")
    if not (a >= 2 * b and b < 0.3):
        fail(f"kidnap: A {a:.3f} m, B {b:.3f} m")

    t0 = time.perf_counter()
    res, paths["recovery"] = counted(lambda: loop_recovery.main([]))
    log(f"[recovery] evals.loop_recovery at its defaults (1100 + 600 scans, "
        f"half 100, sigma 0.03): {time.perf_counter() - t0:.1f} s; last "
        f"{res['window']} scans OFF {res['final_off']:.3f} m, ON "
        f"{res['final_on']:.3f} m, {res['closures']} closures; launches "
        f"{paths['recovery']} [{card}]")
    if not res["final_on"] < 0.5 * res["final_off"]:
        fail("recovery: the ON arm is not under half the OFF arm's error")


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    cfg = DEFAULT
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 1. Build.
    t0 = time.perf_counter()
    lib_path = _native.build()
    _native.library()
    log(f"[build] {time.perf_counter() - t0:.2f} s -> "
        f"{lib_path.relative_to(lib_path.parents[2])}")
    ptxas = lib_path.parent / _native.PTXAS_LOG
    if ptxas.exists():          # written by the build that made the library
        for line in ptxas.read_text().splitlines():
            if line.endswith(".cu:") or "Compiling entry" in line \
                    or "Used" in line or "spill" in line:
                log(f"[ptxas] {line.strip()}")

    # 2. Device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"{torch.cuda.get_device_name(0)}, power limit not read"
    log(f"[device] {card}")

    # 3. Per-kernel parity at the main path's shapes.
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    scans, poses = make_scans(cfg, dev)
    torch.cuda.synchronize()
    log(f"[scans] {N_SCANS} scans ray-cast in "
        f"{time.perf_counter() - t0:.2f} s")
    fe = {k: frontend_inputs(scans[k], cfg) for k in (0, 40, 80)}
    err = {"ccl": check_ccl("vlp16", [a for a, _ in fe.values()], cfg, gen)}
    tall = {}       # K1 and K2 inputs at the other sensors' shapes
    for name in ("hdl32e", "vls128", "os1_16", "os1_64"):
        cs = for_sensor(name)
        tall[name] = frontend_inputs(synthetic.raycast_scan(
            synthetic.loop_scene(), Pose(poses.R[0], poses.t[0]), cs.sensor),
            cs)
        if name in K1_TALL:
            check_ccl(name, [tall[name][0]], cs, gen)
    err["picks"] = check_picks(picks_cases(
        {k: k2 for k, (_, k2) in fe.items()}, tall, dev))
    gate = float(cfg.mapping.nn_max_dist) ** 0.5
    mc = cfg.mapping
    sets = {
        "surf": knn_sets(mc.scan_surf_cap, mc.submap_surf_cap, 90.0, gen,
                         dev),
        "corner": knn_sets(mc.scan_corner_cap, mc.submap_corner_cap, 60.0,
                           gen, dev)}
    err["knn"] = max(check_knn("surf k=5", *sets["surf"], 5, gate),
                     check_knn("corner k=5", *sets["corner"], 5, gate))
    check_knn("corner k=1 ungated", *sets["corner"], 1, None)
    ragged = torch.Generator().manual_seed(1)     # shapes off the tile grid
    check_knn("ragged 1000 x 3001 k=5", *knn_sets(1000, 3001, 30.0, ragged,
                                                  dev), 5, gate)
    check_knn("ragged 777 x 1501 k=3 ungated", *knn_sets(777, 1501, 30.0,
                                                         ragged, dev), 3, None)
    check_knn("synthetic 8192 x 49152 k=1 ungated", *sets["surf"], 1, None)
    ragged_set = knn_sets(1000, 3001, 30.0, ragged, dev)
    for k in range(1, knn_cuda.MAX_K + 1):
        check_knn(f"ragged 1000 x 3001 k={k} ungated", *ragged_set, k, None,
                  plain=False)
    ties = tie_set(torch.Generator().manual_seed(2), dev)
    for k in (1, 2, 5, 8):
        check_knn(f"duplicate-point ties k={k}", *ties, k, None, plain=False)

    # 4. Main path at full width, launches counted around the run only.
    warm = [scans[k] for k in range(4)]
    pipeline.run_slam_sequence(warm, cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _native.reset_counts()
    t0 = time.perf_counter()
    fused, state = pipeline.run_slam_sequence(scans, cfg, device=dev)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = {name: k.launches for name, k in _native.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    if not (torch.isfinite(fused.t).all() and torch.isfinite(fused.R).all()):
        fail("main path: non-finite pose")
    n_kf = int(state.mapping.kf.count)
    if n_kf <= 0:
        fail("main path: no keyframe")
    gt = ground_truth(poses, N_SCANS)
    ate = float(metrics.ate_rmse(fused.t, gt))
    # Unaligned: the map frame is scan 0's, the sensor at pose 1.
    end_err = float((fused.t[-1] - (gt[-1] - gt[0]) @ poses.R[1]).norm())
    for name, n in launches.items():
        if n <= 0:
            fail(f"main path: kernel {name} was never launched")
    log(f"[main] {N_SCANS} scans in {t_run:.3f} s = {N_SCANS / t_run:.2f} "
        f"scans/s; fused ATE {ate:.4f} m, end error {end_err:.4f} m, "
        f"{n_kf} keyframes, peak allocated {peak / 2**30:.3f} GiB, "
        f"launches {launches} [{card}]")
    if ate >= 0.2:
        fail(f"main path: fused ATE {ate:.4f} m >= 0.2 m")
    med = stage_times(scans, cfg, dev)
    log("[stages] median ms per call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in med.items())
        + f" (mapping every {cfg.mapping_every} scans) [{card}]")

    # 5. Card vs CPU over the first scans.
    first = scans[:N_PARITY_SCANS]
    f_gpu, _ = pipeline.run_slam_sequence(first, cfg, device=dev)
    f_cpu, _ = pipeline.run_slam_sequence(
        [tuple(a.cpu() for a in s) for s in first], cfg, device="cpu")
    gap = float((f_gpu.t.cpu() - f_cpu.t).abs().max())
    log(f"[path parity] first {N_PARITY_SCANS} scans, card vs CPU: max "
        f"fused position difference {gap:.3g} m")
    if gap >= 1e-3:
        fail(f"path parity: {gap:.3g} m >= 1e-3 m")

    # 6. Timings at the main path's shapes: K1/K2 on scan 0's inputs, K3 on
    #    the final submap cache with the last keyframe's cloud as queries.
    kf, cache = state.mapping.kf, state.mapping.cache
    last = n_kf - 1
    pose = Pose(kf.R[last], kf.t[last])
    real = {
        "surf": (transform_points(pose, kf.surf[last]), kf.surf_valid[last],
                 cache.s_pts, cache.s_valid),
        "corner": (transform_points(pose, kf.corner[last]),
                   kf.corner_valid[last], cache.c_pts, cache.c_valid)}
    err["knn"] = max(err["knn"], check_knn("main-path surf", *real["surf"],
                                           5, gate, main_path=True),
                     check_knn("main-path corner", *real["corner"], 5, gate,
                               main_path=True))
    check_main_path_rate()
    (seeds, ch, cv), (rng, col, grd, cnt) = fe[0]
    n, h = seeds.shape
    rows = []

    def row(name, ms, plain_ms, lib_ms, n_bytes, n_ops):
        b, by = bound_ms(n_bytes, n_ops)
        k = _native.KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": launches[name],
                     "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b, "bound_by": by, "library_ms": lib_ms})

    it = cfg.seg.ccl_max_iters
    row("ccl",
        time_ms(lambda: ccl_cuda.label_propagation(seeds, ch, cv, it), 200),
        time_ms(lambda: ccl_cuda.label_propagation_plain(seeds, ch, cv, it),
                10),
        None, ccl_bytes(n, h), 0.0)
    row("picks",
        time_ms(lambda: features_cuda.pick_labels(rng, col, grd, cnt,
                                                  cfg.feat), 200),
        time_ms(lambda: features_cuda.pick_labels_plain(rng, col, grd, cnt,
                                                        cfg.feat), 10),
        None, picks_bytes(n, h), picks_ops(n, h))
    q, qv, ref, rv = real["surf"]
    visited = torch.zeros(1, dtype=torch.int64, device=dev)
    knn_cuda.knn(q, qv, ref, rv, 5, gate=gate, visited=visited)
    pairs = knn_cuda.gated_pairs(q, qv, ref, rv, gate)
    n_chunks = (ref.shape[0] + knn_cuda.RC - 1) // knn_cuda.RC
    n_tiles = (q.shape[0] + knn_cuda.TQ - 1) // knn_cuda.TQ
    active = torch.unique(torch.nonzero(qv)[:, 0] // knn_cuda.TQ).numel()
    log(f"[knn] main-path surf 5-NN: {int(visited)} of {n_chunks * n_tiles} "
        f"({knn_cuda.TQ}-query tile, {knn_cuda.RC}-reference chunk) pairs "
        f"visited by the kernel, over {active} tiles with a valid query; "
        f"{pairs} (query, reference) pairs within the gate (the bound's "
        f"count); {knn_cuda.tile_pairs(q, qv, ref, rv, gate)} pairs in "
        f"({knn_cuda.TILE_TQ}-query tile, {knn_cuda.TILE_RC}-reference "
        f"chunk) blocks within the gate (the first kernel's culling); "
        f"{int(qv.sum())} valid queries, {int(rv.sum())} valid references")
    row("knn",
        time_ms(lambda: knn_cuda.knn(q, qv, ref, rv, 5, gate=gate), 50),
        time_ms(lambda: voxel.knn(q, qv, ref, rv, 5), 5),
        time_ms(lambda: library_knn(q, qv, ref, rv, 5), 5),
        knn_bytes(q.shape[0], ref.shape[0], 5), 8.0 * pairs)

    bare = {"ccl": bare_ms(bare_ccl(seeds, ch, cv)),
            "picks": bare_ms(bare_picks(rng, col, grd, cnt, cfg.feat)),
            "knn": bare_ms(bare_knn(*real["surf"], 5, gate))}
    log("[bare launch] ms per kernel launch without the wrapper: " + ", ".join(
        f"{k} {v:.4f}" for k, v in bare.items()) + f" [{card}]")

    # K3 at the main-path corner shape and a synthetic 1-NN shape; K1 at the
    # taller sensors' shapes.
    for name, (kq, kqv, kr, krv), k, g in (
            ("main-path corner 5-NN", real["corner"], 5, gate),
            ("synthetic 1-NN ungated", sets["surf"], 1, None)):
        p = knn_cuda.gated_pairs(kq, kqv, kr, krv, g)
        b, by = bound_ms(knn_bytes(kq.shape[0], kr.shape[0], k), 8.0 * p)
        lib = time_ms(lambda: library_knn(kq, kqv, kr, krv, k), 2, 1)
        plain = time_ms(lambda: voxel.knn(kq, kqv, kr, krv, k), 3, 1)
        ms = time_ms(lambda: knn_cuda.knn(kq, kqv, kr, krv, k, gate=g), 50)
        bare_k = bare_ms(bare_knn(kq, kqv, kr, krv, k, g), 50)
        log(f"[knn] {name} {kq.shape[0]} x {kr.shape[0]}: ms {ms:.4f}, "
            f"bare {bare_k:.4f}, bound {b:.6f} ({by}, {p} pairs), plain "
            f"{plain:.3f}, library {lib:.2f} [{card}]")
    for name in K1_TALL:
        ts, tch, tcv = tall[name][0]
        tn, th = ts.shape
        b, by = bound_ms(ccl_bytes(tn, th), 0.0)
        ms = time_ms(lambda: ccl_cuda.label_propagation(ts, tch, tcv, it),
                     200)
        plain = time_ms(lambda: ccl_cuda.label_propagation_plain(
            ts, tch, tcv, it), 5, 1)
        log(f"[ccl] {name} {tn} x {th}: ms {ms:.4f}, bare "
            f"{bare_ms(bare_ccl(ts, tch, tcv)):.4f}, bound {b:.6f} ({by}), "
            f"plain {plain:.3f} [{card}]")
    for name in K2_TALL:
        k2 = tall[name][1]
        pf = for_sensor(name).feat
        pn, ph = k2[0].shape
        b, by = bound_ms(picks_bytes(pn, ph), picks_ops(pn, ph))
        ms = time_ms(lambda: features_cuda.pick_labels(*k2, pf), 200)
        plain = time_ms(lambda: features_cuda.pick_labels_plain(*k2, pf), 5,
                        1)
        log(f"[picks] {name} {pn} x {ph}: ms {ms:.4f}, bare "
            f"{bare_ms(bare_picks(*k2, pf)):.4f}, bound {b:.6f} ({by}), "
            f"plain {plain:.3f} [{card}]")
    # Device time per launch of each kernel of K1, K2 and K3 (profiler).
    prof = {"ccl vlp16 16 x 1800": lambda: ccl_cuda.label_propagation(
                seeds, ch, cv, it),
            "picks vlp16 16 x 1800": lambda: features_cuda.pick_labels(
                rng, col, grd, cnt, cfg.feat),
            "knn main-path surf 5-NN": lambda: knn_cuda.knn(
                q, qv, ref, rv, 5, gate=gate),
            "knn main-path corner 5-NN": lambda: knn_cuda.knn(
                *real["corner"], 5, gate=gate),
            "knn synthetic 1-NN ungated 8192 x 49152": lambda: knn_cuda.knn(
                *sets["surf"], 1)}
    for name in K1_TALL:
        ts, tch, tcv = tall[name][0]
        prof[f"ccl {name} {ts.shape[0]} x {ts.shape[1]}"] = (
            lambda ts=ts, tch=tch, tcv=tcv: ccl_cuda.label_propagation(
                ts, tch, tcv, it))
    for name in K2_TALL:
        k2 = tall[name][1]
        prof[f"picks {name} {k2[0].shape[0]} x {k2[0].shape[1]}"] = (
            lambda k2=k2, pf=for_sensor(name).feat: features_cuda.pick_labels(
                *k2, pf))
    for name, fn in prof.items():
        per = device_us_per_launch(fn)
        log(f"[profile] {name}: " + (", ".join(
            f"{k} {v:.2f} us" for k, v in per.items()) or "not measured")
            + f" per launch (device time) [{card}]")
    # K2's fixed cost and its cost per greedy trip: device time of the bare
    # launch with no trips, the main path's 20 + 8 and twice that (after
    # the profiles above: a first profiler session can miss launches).
    split = {}
    for trips in (0, 28, 56):
        per = device_us_per_launch(bare_picks(
            rng, col, grd, cnt, dataclasses.replace(
                cfg.feat, edge_less_per_section=trips * 5 // 7,
                surf_per_section=trips * 2 // 7)))
        split[trips] = sum(per.values()) if per else float("nan")
    log("[picks] vlp16 device us per launch by greedy trips (edge + surf): "
        + ", ".join(f"{t} {v:.2f}" for t, v in split.items())
        + f"; {(split[56] - split[28]) / 28:.3f} us a trip [{card}]")

    # 7. Loop closure at DEFAULT on the revisit lap.
    lcfg = cfg.replace(loop=dataclasses.replace(
        cfg.loop, enabled=True, cadence=1.0, min_time_gap=LOOP_TIME_GAP))
    (fused_l, st_l, poses_l, alog, t_loop), path_launches = counted(
        lambda: loop_run(lcfg, dev))
    paths = {"main": launches, "loop": path_launches}
    gt_l = ground_truth(poses_l, LOOP_SCANS)
    ate_l = float(metrics.ate_rmse(fused_l.t, gt_l))
    kf_l = st_l.mapping.kf
    n_l = int(kf_l.count)
    dets = torch.linalg.det(kf_l.R[:n_l].double())
    with_cand = [r for r in alog.rows if r["candidate"] >= 0]
    accepted = [r for r in alog.rows if r["closed"]]
    iters = sorted(r["knn"] - 1 for r in with_cand)

    def median(v):
        return sorted(v)[len(v) // 2] if v else float("nan")

    log(f"[loop] {LOOP_SCANS} scans in {t_loop:.3f} s = "
        f"{LOOP_SCANS / t_loop:.2f} scans/s; {len(alog.rows)} attempts, "
        f"{len(with_cand)} with a candidate, {len(accepted)} accepted "
        f"(loop factors {int(st_l.loops.count)}); ICP iterations per attempt "
        f"with a candidate min/median/max {iters[:1]}/{median(iters)}/"
        f"{iters[-1:]}; ms per close_and_correct median "
        f"{median([r['ms'] for r in with_cand]):.1f} with a candidate, "
        f"{median([r['ms'] for r in accepted]):.1f} accepted (pose-graph "
        f"solve included), {median([r['ms'] for r in alog.rows]):.1f} over "
        f"all; of it ms per ICP median {median(alog.icp.ms):.1f} "
        f"({sum(alog.icp.ms) / max(sum(iters), 1):.2f} per iteration), per "
        f"pose-graph solve median {median(alog.solve.ms):.1f}; K3 launches "
        f"{path_launches['knn']} "
        f"({sum(r['knn'] for r in alog.rows)} in attempts); fused ATE "
        f"{ate_l:.4f} m; {n_l} keyframes; max |det R - 1| "
        f"{float((dets - 1).abs().max()):.2e}; launches {path_launches} "
        f"[{card}]")
    if not accepted:
        fail("loop: no accepted closure")
    if not ate_l < 0.5:
        fail(f"loop: fused ATE {ate_l:.4f} m >= 0.5 m")
    if not (torch.isfinite(fused_l.t).all() and torch.isfinite(kf_l.R).all()
            and torch.isfinite(kf_l.t).all()):
        fail("loop: non-finite pose")
    if float((dets - 1).abs().max()) >= 1e-3:
        fail("loop: a stored rotation has |det - 1| >= 1e-3")
    # The timers stand in for module attributes; a caller that bound the
    # function directly would bypass them and leave the readings empty.
    if (len(alog.icp.ms), len(alog.solve.ms)) != (len(with_cand),
                                                  len(accepted)):
        fail(f"loop: {len(alog.icp.ms)} ICP and {len(alog.solve.ms)} solve "
             f"timings for {len(with_cand)} attempts with a candidate and "
             f"{len(accepted)} accepted")

    # A resumed session on the loop run's map: fresh odometry, the robot
    # boots at rest where the run ended (a rigid scan at the end of the
    # last sweep), and the belief is the run's last mapped pose moved 20 m
    # and turned 90 degrees.
    P_end = Pose(poses_l.R[LOOP_SCANS], poses_l.t[LOOP_SCANS])
    scan_end = synthetic.raycast_scan(synthetic.loop_scene(), P_end,
                                      lcfg.sensor)
    resumed = pipeline.init_slam_state(lcfg, dev)._replace(
        mapping=kidnap(st_l).mapping, loops=st_l.loops)
    (resumed, _), boot_launches = counted(lambda: pipeline.slam_scan_step(
        resumed, *scan_end, lcfg, 0.1 * LOOP_SCANS + 600.0,
        run_mapping=False))

    # K3 at the two ICP shapes: the accepted attempt's clouds, and the
    # resumed scan's cloud at the mapped pose against the latest
    # keyframe's window.
    (cq, cqv), (hr, hrv) = alog.first["cur"], alog.first["hist"]
    icp_sets = {"loop ICP": (cq, cqv, hr, hrv),
                "relocalization ICP": reloc_clouds(resumed, lcfg,
                                                   st_l.mapping.t_aft)}
    for name, (q, qv, r, rv) in icp_sets.items():
        err["knn"] = max(err["knn"], check_knn(
            f"{name} {q.shape[0]} x {r.shape[0]} k=1 ungated", q, qv, r, rv,
            1, None))
    for name, (q, qv, r, rv) in icp_sets.items():
        p = knn_cuda.gated_pairs(q, qv, r, rv, None)
        b, by = bound_ms(knn_bytes(q.shape[0], r.shape[0], 1), 8.0 * p)
        per = device_us_per_launch(lambda: knn_cuda.knn(q, qv, r, rv, 1),
                                   sessions=6)
        ms = time_ms(lambda: knn_cuda.knn(q, qv, r, rv, 1), 50)
        bare_k = bare_ms(bare_knn(q, qv, r, rv, 1, None), 50)
        plain = time_ms(lambda: voxel.knn(q, qv, r, rv, 1), 3, 1)
        lib = time_ms(lambda: library_knn(q, qv, r, rv, 1), 3, 1)
        log(f"[knn] {name} {q.shape[0]} x {r.shape[0]} 1-NN ungated: ms "
            f"{ms:.4f}, bare {bare_k:.4f}, device " + (", ".join(
                f"{k} {v:.2f} us" for k, v in per.items()) or "not measured")
            + f", bound {b:.6f} ({by}, {p} pairs), plain {plain:.3f}, "
            f"library {lib:.2f} [{card}]")
    H = torch.randn(3, 3, generator=torch.Generator().manual_seed(3)).to(dev)
    log(f"[icp] 3x3 rotation (icp.kabsch_rotation, torch.linalg.svd): "
        f"{time_ms(lambda: icp.kabsch_rotation(H), 200):.4f} ms a call "
        f"[{card}]")

    (cg, cc), (fg, fc), pos_gap, cpu_s = attempt_card_vs_cpu(
        alog.first, lcfg, dev)
    fit_rel = abs(fg - fc) / max(abs(fc), 1e-30)
    log(f"[loop parity] first accepted attempt, card vs CPU: closed {cg} / "
        f"{cc}, fitness {fg:.6f} / {fc:.6f} ({fit_rel:.2g} relative), "
        f"largest corrected keyframe position difference {pos_gap:.3g} m "
        f"(bounds: equal flags, fitness {ATTEMPT_FIT_REL} relative, "
        f"positions {ATTEMPT_POS_TOL} m); CPU {cpu_s:.1f} s")
    if cg != cc:
        fail("loop parity: the card and the CPU disagree on the closure")
    if cg and (fit_rel > ATTEMPT_FIT_REL or pos_gap > ATTEMPT_POS_TOL):
        fail("loop parity: card and CPU outside the stated bounds")

    # 8. Decimation: the loop run's final store on the card and the CPU,
    #    then a run whose 36-keyframe store is decimated mid-run.
    d_count, d_loops, d_dropped, d_exact, d_gap = decimate_card_vs_cpu(
        kf_l, st_l.loops, dev)
    log(f"[decimate] loop store {n_l} -> {d_count} keyframes (keep_recent "
        f"32), loop factors {d_loops} ({d_dropped} dropped), card vs CPU: "
        f"counts, times, validity and factors equal {d_exact}, largest pose "
        f"difference {d_gap:.3g}")
    if not d_exact or d_gap > 1e-5:
        fail("decimate: card and CPU differ")
    fires = []
    guard = pipeline.maybe_decimate

    def counting_guard(state, c, margin=16):
        state, fired = guard(state, c, margin)
        fires.append(fired)
        return state, fired

    dcfg = cfg.replace(mapping=dataclasses.replace(
        cfg.mapping, max_keyframes=DECIMATE_CAP,
        decimate_keep_recent=DECIMATE_RECENT))
    pipeline.maybe_decimate = counting_guard
    try:
        (fused_d, st_d), paths["decimation"] = counted(
            lambda: pipeline.run_slam_sequence(scans, dcfg, device=dev))
    finally:
        pipeline.maybe_decimate = guard
    ate_d = float(metrics.ate_rmse(fused_d.t, gt))
    log(f"[decimate] {N_SCANS} scans with a {DECIMATE_CAP}-keyframe store: "
        f"maybe_decimate fired {sum(fires)} of {len(fires)} checks, "
        f"{int(st_d.mapping.kf.count)} keyframes at the end, overflow "
        f"{int(st_d.mapping.kf.overflow)}, fused ATE {ate_d:.4f} m")
    if not any(fires) or int(st_d.mapping.kf.overflow) != 0:
        fail("decimate: the guard never fired or the store overflowed")
    if not (torch.isfinite(fused_d.t).all() and ate_d < 0.2):
        fail(f"decimate: fused ATE {ate_d:.4f} m")

    # 9. The IMU path over the main-path world.
    integ = imu_integral(poses)
    fused_i, paths["imu"] = counted(lambda: imu_run(scans, integ, cfg, dev))
    ate_i = float(metrics.ate_rmse(fused_i, gt))
    f_cpu = imu_run([tuple(a.cpu() for a in s) for s in first], integ, cfg,
                    "cpu")
    gap_i = float((fused_i[:N_PARITY_SCANS].cpu() - f_cpu).abs().max())
    med_i = imu_stage_times(scans, integ, cfg, dev)
    log(f"[imu] {N_SCANS} scans: fused ATE {ate_i:.4f} m; first "
        f"{N_PARITY_SCANS} scans card vs CPU {gap_i:.3g} m; "
        f"process_scan_with_imu median ms per stage: " + ", ".join(
            f"{k} {v:.2f}" for k, v in med_i.items())
        + f"; launches {paths['imu']} [{card}]")
    if not (torch.isfinite(fused_i).all() and ate_i < 0.2):
        fail(f"imu: fused ATE {ate_i:.4f} m >= 0.2 m")
    if gap_i >= 1e-3:
        fail(f"imu: card vs CPU {gap_i:.3g} m >= 1e-3 m")

    # 10. Relocalization of the resumed session's first scan.
    sync(dev)
    t0 = time.perf_counter()
    (st_r, rdiag), reloc_launches = counted(
        lambda: relocalize.relocalize_slam_state(resumed, lcfg))
    sync(dev)
    t_rel = time.perf_counter() - t0
    paths["relocalization"] = {k: boot_launches[k] + reloc_launches[k]
                               for k in reloc_launches}
    # The relocalized position, mapped to the world by the ATE's alignment
    # of the run, is held to the pose where the resumed scan was taken.
    # Also printed: the distance to the run's own fused pose of its last
    # scan, whose sweep ended there.
    T_r = st_r.mapping.t_aft
    R_a, t_a, _ = metrics.umeyama_alignment(fused_l.t, gt_l)
    err_gt = float((R_a @ T_r.t + t_a - P_end.t).norm())
    err_fused = float((T_r.t - fused_l.t[-1]).norm())
    rot_fused = math.degrees(float(se3.so3_log(
        T_r.R.T @ fused_l.R[-1]).norm()))
    prior_err = float((resumed.mapping.t_aft.t - fused_l.t[-1]).norm())
    log(f"[reloc] resumed on the loop run's map, belief moved "
        f"{RELOC_SHIFT_M} m and {RELOC_YAW_DEG} deg from the last mapped "
        f"pose: accepted {bool(rdiag.accepted)}, keyframe "
        f"{int(rdiag.candidate)}, fitness {float(rdiag.fitness):.4f}, "
        f"{int(rdiag.n_candidates)} candidates; position error against "
        f"ground truth {err_gt:.4f} m; {err_fused:.4f} m and "
        f"{rot_fused:.3f} deg from the run's fused pose of that place (the "
        f"belief {prior_err:.2f} m; fused ATE {ate_l:.4f} m); "
        f"{t_rel:.3f} s, K3 launches "
        f"{reloc_launches['knn']} [{card}]")
    if not bool(rdiag.accepted) or not err_gt < 0.3:
        fail(f"reloc: accepted {bool(rdiag.accepted)}, error {err_gt:.4f} m")

    with tempfile.TemporaryDirectory() as work:
        cli_phases(work, cfg, dev, card, paths)
    eval_phases(dev, card, paths)

    # Every kernel of each path ran in it; the kernels line counts every
    # path's launches.
    for name, counts in paths.items():
        for k in counts:
            if counts[k] <= 0:
                fail(f"{name} path: kernel {k} was never launched")
    log("[launches] per path: " + "; ".join(
        f"{name} {counts}" for name, counts in paths.items()))
    for r in rows:
        r["launches"] = sum(c[r["name"]] for c in paths.values())
        r["max_abs_err"] = err[r["name"]]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
