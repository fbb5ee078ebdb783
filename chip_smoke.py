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
     K3 also at the main-path corner shape and the ICP shape (8192 x 49152,
     k=1, ungated), K1 also at the HDL-32E and VLS-128 shapes, K2 also at
     the HDL-32E, VLS-128 and OS1-64 shapes and with 0, 28 and 56 greedy
     trips (the prologue and the cost of a trip); K3's bound from the
     (query, reference) pairs within the gate; each kernel launch's device
     time from torch.profiler.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Needs no JAX and no network.
"""

import dataclasses
import json
import re
import subprocess
import sys
import time

import torch

from legoloam_tpu_torch import DEFAULT
from legoloam_tpu_torch.config import REFERENCE, for_sensor
from legoloam_tpu_torch.models import fusion, mapping, odometry, pipeline
from legoloam_tpu_torch.ops import (_native, ccl_cuda, features,
                                    features_cuda, knn_cuda, projection,
                                    segmentation, voxel)
from legoloam_tpu_torch.ops.se3 import Pose, transform_points
from legoloam_tpu_torch.utils import metrics, synthetic

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

N_SCANS = 96
N_PARITY_SCANS = 6
KNN_REL_TOL = 1e-5
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
    from torch.profiler over ``calls`` calls (empty if the profiler records
    no device activity).  A session that records no kernel, or a kernel
    fewer times than it was called (the profiler drops some records now
    and then), is run again, up to ``sessions`` times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out, short = {}, False
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", 0.0)
            if us <= 0:
                continue
            if e.count < calls:
                short = True
                continue
            m = re.search(r"(\w+)(?:<[^>]*>)?\(", e.key)
            out[m.group(1) if m else e.key] = us / e.count
        if out and not short:
            break
    return out


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
    check_knn("ICP shape 8192 x 49152 k=1 ungated", *sets["surf"], 1, None)
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
    gt = poses.t[:N_SCANS] - poses.t[0]
    ate = float(metrics.ate_rmse(fused.t, gt))
    end_err = float((fused.t[-1] - gt[-1]).norm())
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

    # K3 at the main-path corner shape and the ICP shape; K1 at the taller
    # sensors' shapes.
    for name, (kq, kqv, kr, krv), k, g in (
            ("main-path corner 5-NN", real["corner"], 5, gate),
            ("ICP shape 1-NN ungated", sets["surf"], 1, None)):
        p = knn_cuda.gated_pairs(kq, kqv, kr, krv, g)
        b, by = bound_ms(knn_bytes(kq.shape[0], kr.shape[0], k), 8.0 * p)
        lib = time_ms(lambda: library_knn(kq, kqv, kr, krv, k), 2, 1)
        ms = time_ms(lambda: knn_cuda.knn(kq, kqv, kr, krv, k, gate=g), 50)
        bare_k = bare_ms(bare_knn(kq, kqv, kr, krv, k, g), 50)
        log(f"[knn] {name} {kq.shape[0]} x {kr.shape[0]}: ms {ms:.4f}, "
            f"bare {bare_k:.4f}, bound {b:.6f} ({by}, {p} pairs), library "
            f"{lib:.2f} [{card}]")
    for name in K1_TALL:
        ts, tch, tcv = tall[name][0]
        tn, th = ts.shape
        b, by = bound_ms(ccl_bytes(tn, th), 0.0)
        ms = time_ms(lambda: ccl_cuda.label_propagation(ts, tch, tcv, it),
                     200)
        log(f"[ccl] {name} {tn} x {th}: ms {ms:.4f}, bare "
            f"{bare_ms(bare_ccl(ts, tch, tcv)):.4f}, bound {b:.6f} ({by}) "
            f"[{card}]")
    for name in K2_TALL:
        k2 = tall[name][1]
        pf = for_sensor(name).feat
        pn, ph = k2[0].shape
        b, by = bound_ms(picks_bytes(pn, ph), picks_ops(pn, ph))
        ms = time_ms(lambda: features_cuda.pick_labels(*k2, pf), 200)
        log(f"[picks] {name} {pn} x {ph}: ms {ms:.4f}, bare "
            f"{bare_ms(bare_picks(*k2, pf)):.4f}, bound {b:.6f} ({by}) "
            f"[{card}]")
    # Device time per launch of each kernel of K1, K2 and K3 (profiler).
    prof = {"ccl vlp16 16 x 1800": lambda: ccl_cuda.label_propagation(
                seeds, ch, cv, it),
            "picks vlp16 16 x 1800": lambda: features_cuda.pick_labels(
                rng, col, grd, cnt, cfg.feat),
            "knn main-path surf 5-NN": lambda: knn_cuda.knn(
                q, qv, ref, rv, 5, gate=gate),
            "knn ICP shape 1-NN ungated": lambda: knn_cuda.knn(
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
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
