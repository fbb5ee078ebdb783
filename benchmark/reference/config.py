"""Static configuration for the TPU-native LeGO-LOAM rebuild.

The reference keeps all configuration as compile-time ``extern const`` globals in a
single header (reference: ``LeGO-LOAM/include/utility.h:53-136``).  We mirror that
philosophy with frozen dataclasses whose fields become *static* jit constants:
``N_SCAN``/``Horizon_SCAN`` fix every kernel shape, exactly like the reference's
compile-time constants fix its ``cv::Mat`` dimensions.

Unlike the reference (which requires editing the header and recompiling to switch
sensors, ``utility.h:70-102``), a config here is just a different dataclass instance;
jit caches one executable per distinct config.

Frame convention: the rebuild works in a SINGLE lidar frame throughout — x forward,
y left, z up.  The reference instead rotates everything into the LOAM "camera"
convention (z forward, x left, y up) via a cyclic axis swap
(``src/featureAssociation.cpp:500-502``) and swaps back at the gtsam boundary
(``src/mapOptmization.cpp:947-950``).  See ``legoloam_tpu/ops/se3.py`` for the
mapping used when comparing trajectories against the reference.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Lidar geometry (reference: ``utility.h:61-102``)."""

    name: str = "vlp16"
    n_scan: int = 16                 # number of rings
    horizon_scan: int = 1800         # columns per revolution
    ang_res_x_deg: float = 0.2       # horizontal angular resolution
    ang_res_y_deg: float = 2.0       # vertical angular resolution
    ang_bottom_deg: float = 15.1     # angle of the bottom ring below horizontal
    ground_scan_ind: int = 7         # rings 0..ground_scan_ind-1 may be ground
    use_cloud_ring: bool = True      # trust the sensor's ring channel if present
    scan_period: float = 0.1         # seconds per revolution (utility.h:107)
    min_range: float = 1.0           # sensorMinimumRange (utility.h:111)
    mount_angle_deg: float = 0.0     # sensorMountAngle (utility.h:112)

    @property
    def ang_res_x(self) -> float:
        return math.radians(self.ang_res_x_deg)

    @property
    def ang_res_y(self) -> float:
        return math.radians(self.ang_res_y_deg)

    @property
    def n_points(self) -> int:
        return self.n_scan * self.horizon_scan


# Alternate sensor geometries kept in the reference as commented-out blocks
# (``utility.h:70-102``); here they are first-class configs.
VLP16 = SensorConfig()
HDL32E = SensorConfig(
    name="hdl32e", n_scan=32, horizon_scan=1800,
    ang_res_x_deg=360.0 / 1800, ang_res_y_deg=41.33 / 31,
    ang_bottom_deg=30.67, ground_scan_ind=20,
)
VLS128 = SensorConfig(
    name="vls128", n_scan=128, horizon_scan=1800,
    ang_res_x_deg=0.2, ang_res_y_deg=0.3,
    ang_bottom_deg=25.0, ground_scan_ind=10,
)
OS1_16 = SensorConfig(
    name="os1_16", n_scan=16, horizon_scan=1024,
    ang_res_x_deg=360.0 / 1024, ang_res_y_deg=33.2 / 15,
    ang_bottom_deg=16.7, ground_scan_ind=7,
)
OS1_64 = SensorConfig(
    name="os1_64", n_scan=64, horizon_scan=1024,
    ang_res_x_deg=360.0 / 1024, ang_res_y_deg=33.2 / 63,
    ang_bottom_deg=16.7, ground_scan_ind=15,
)

SENSORS = {c.name: c for c in (VLP16, HDL32E, VLS128, OS1_16, OS1_64)}


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Ground removal + cluster segmentation (reference: ``utility.h:112-118``)."""

    ground_angle_thresh_deg: float = 10.0    # imageProjection.cpp:284
    segment_theta_deg: float = 60.0          # segmentTheta (utility.h:113)
    valid_point_num: int = 5                 # segmentValidPointNum
    valid_line_num: int = 3                  # segmentValidLineNum
    min_cluster_size: int = 30               # imageProjection.cpp:440
    # Upper BOUND on segmented-scan sweeps for the connected-component
    # kernel; both backends sweep until the labels reach a fixpoint (exactly
    # the reference BFS partition, imageProjection.cpp:370-460) and this only
    # caps adversarial snake-shaped components.  Each sweep propagates labels
    # across entire straight runs, so the bound limits the number of BENDS in
    # a component's min-label path, not its diameter; realistic scans
    # converge in <= 6 sweeps.
    ccl_max_iters: int = 32
    # CCL implementation: "auto" = VMEM-resident Pallas kernel on TPU, XLA
    # segmented scans elsewhere; "pallas" / "xla" force one.
    ccl_backend: str = "auto"
    # Thinning of non-feature points (imageProjection.cpp:328-339).
    outlier_downsample: int = 5              # keep 1-in-5 columns of big outliers
    ground_downsample: int = 5               # keep 1-in-5 ground columns


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Curvature features (reference: ``utility.h:120-125`` + featureAssociation.cpp)."""

    sections: int = 6                  # sectionsTotal
    # Picks per ring-section.  The reference hard-codes 2 sharp / 4 flat
    # (featureAssociation.cpp:709,747) — a CPU-budget choice, not a modeling
    # one.  Batched solves make extra residual rows nearly free on TPU; 2x
    # the picks measurably steadies the two-step LM on motion-distorted
    # scans, while the round-3 3x default (6/12) bought nothing further
    # once re-validated under realistic sensor noise (sigma=0.02 fused ATE:
    # 2/4 0.031, 4/8 0.025, 6/12 0.028 — tools/sweep_picks.py --noise) and
    # cost ~3.5% headline throughput.  Set 2/4 to reproduce the reference
    # counts.
    edge_per_section: int = 4          # sharp corner picks  (reference: 2)
    edge_less_per_section: int = 20    # less-sharp picks    (featureAssociation.cpp:711)
    surf_per_section: int = 8          # flat planar picks   (reference: 4)
    edge_threshold: float = 0.1
    surf_threshold: float = 0.1
    curvature_halfwin: int = 5         # +-5 neighbors (featureAssociation.cpp:627)
    occlusion_col_gap: int = 10        # featureAssociation.cpp:655
    occlusion_range_jump: float = 0.3  # featureAssociation.cpp:657
    parallel_beam_frac: float = 0.02   # featureAssociation.cpp:671
    less_flat_leaf: float = 0.2        # VoxelGrid leaf (featureAssociation.cpp:225)
    # Fixed capacities for the dense feature arrays (per scan).
    max_sharp: int = 512               # >= sections*edge_per_section*n_scan caps
    max_less_sharp: int = 2048
    max_flat: int = 1024
    max_less_flat: int = 8192
    max_outlier: int = 2048            # thinned invalid-cluster points
    # Pick-loop implementation: "auto" = VMEM-resident Pallas kernel on TPU,
    # XLA dense one-hot trips elsewhere; "pallas" / "xla" force one.
    picks_backend: str = "auto"
    # Less-flat 0.2 m downsample implementation.  The reference runs a PCL
    # VoxelGrid PER RING (featureAssociation.cpp:771-783); ring points are
    # azimuth-ordered, so one-pass first-of-run adjacent-cell dedup ("run")
    # reproduces per-ring voxel thinning without the 28.8K-row sort the
    # exact global-voxel path ("voxel") pays — measured 1.36 -> ~0.1 ms on
    # the chip, ATE-equivalent (see PERF.md).  The cloud is only the
    # odometry's surf correspondence SOURCE, where density (not centroid
    # exactness) is what matters; "run" keeps real measured points, closer
    # to the reference's per-ring behavior than a global voxel grid.
    less_flat_method: str = "run"


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Two-step LM scan-to-scan odometry (reference: featureAssociation.cpp:1044-1478)."""

    # Iteration schedule.  The reference runs 25 iterations at step scale 0.05
    # with correspondences refreshed every 5 (featureAssociation.cpp:1163,1321,
    # 1674,1686).  Five 0.05-damped iterations against FIXED correspondences
    # geometrically approach the block's LS optimum by 1-0.95^5 = 0.2262, so
    # the default here compresses each 5-iteration block into ONE iteration at
    # step 0.2262 with a refresh every iteration — measured trajectory ATE is
    # identical (0.0548 vs 0.0552 m on the 40-scan courtyard benchmark) at 5x
    # fewer solver iterations.  Set (25, 5, 0.05) to reproduce the reference
    # schedule exactly.
    max_iterations: int = 5
    # Correspondence refresh cadence: the reference re-searches every 5th of
    # its 25 iterations (featureAssociation.cpp:1163); the compressed
    # schedule refreshed every iteration through round 2.  Refreshing at
    # iterations {0, 3} only is measured ATE-equivalent on all three
    # synthetic worlds (loop 0.0317/0.0316, courtyard 0.0291/0.0285,
    # figure8 0.6563/0.6518 fused, r=1 vs r=3, TPU 2026-08-21) and cuts the
    # dominant class_nn cost ~2.5x -> +10 scans/s on the headline bench.
    corr_refresh_every: int = 3
    step_damping: float = 0.2262
    nearest_sq_dist: float = 25.0          # nearestFeatureSearchSqDist (utility.h:125)
    ring_window: float = 2.5               # +-2.5 rings for the 2nd point (1063,1174)
    # Height-consistency gate on the surf correspondence tripod (stabilizer;
    # 0 = off = reference behavior): drop (j,l,m) planes whose points spread
    # more than this vertically, or whose query sits farther than this above
    # the anchor.  Step A's queries are ground picks; mixed ground+structure
    # tripods within the 5 m search radius tilt the plane slightly and leak
    # along-track displacement into the [pitch, roll, height] solve
    # (measured -0.29 deg pitch per 0.8 m scan on the circuit straights ->
    # z corkscrew; the gate cuts it 22x.  See
    # models/odometry.py:_find_surf_corr and PERF.md round 4).
    surf_tripod_max_dz: float = 0.2
    min_corner_last: int = 10              # featureAssociation.cpp:1668
    min_surf_last: int = 100
    degeneracy_eig_thresh: float = 10.0    # featureAssociation.cpp:1339
    robust_weight_scale: float = 1.8       # s = 1 - 1.8*|pd2|/sqrt(sqrt(|p|)) (1251)
    robust_weight_min: float = 0.1
    # Reference: robust weights after iteration 5 of 25 (1251) = after the
    # first refresh block; in the compressed schedule that is iteration 1.
    robust_after_iter: int = 1
    conv_rot_deg: float = 0.1              # featureAssociation.cpp:1367-1376
    conv_trans_cm: float = 0.1
    skip_frame_num: int = 1                # feed mapping every 2nd frame (284)
    # De-skew feedback damping (TPU-side enhancement; reference = 1.0).  The
    # reference warps its "last" reference clouds to scan end with the scan's
    # OWN estimated transform (TransformToEnd, featureAssociation.cpp:885),
    # which couples each scan's estimation error into the next scan's
    # reference geometry — measured on motion-distorted synthetic scans this
    # feedback makes consecutive twist errors anti-correlated (a marginally
    # stable +-e oscillation).  Warping with a blend of the current and
    # previous twist cancels the alternating term: per-scan twist error drops
    # 0.027 -> 0.016 m mean at 0.5 on the courtyard benchmark, identical on
    # undistorted scans.  DEFAULT 1.0 = the reference's own-transform warp
    # (featureAssociation.cpp:885): the round-5 audit (PERF.md) measured the
    # 0.5 blend trajectory-NEUTRAL on both ledger worlds at realistic noise
    # (loop end drift 0.085 vs 0.049 m at 1.0; circuit 1.63 vs 1.61 m) — the
    # per-scan twist smoothing no longer earns a divergence from reference
    # semantics.  Set 0.5 to re-enable the damped warp.
    warp_blend: float = 1.0
    # PluginIMURotation analogue (featureAssociation.cpp:955-1013, called from
    # integrateTransformation 1697-1725).  The reference de-rotates points to
    # scan-start IMU attitude (TransformToStartIMU), so its LM rotation covers
    # only the residual and PluginIMURotation composes the IMU-measured
    # intra-scan rotation back into the accumulated attitude — net effect:
    # attitude increment = IMU increment + matching residual.  Here de-skew
    # keeps the full motion in the data and the gyro SEEDS the solve, so the
    # increment is the estimate alone; this blend pulls the solved per-scan
    # rotation toward the gyro-integrated increment (ang_delta):
    # xi_rot <- (1-b)*xi_rot + b*gyro_delta.  0 disables (pure estimate);
    # 1 reproduces the reference's trust-the-IMU-increment behavior.
    imu_rotation_blend: float = 0.0


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Scan-to-map optimization + keyframes (reference: mapOptmization.cpp)."""

    process_interval: float = 0.3              # mappingProcessInterval (utility.h:105)
    corner_leaf: float = 0.2                   # mapOptmization.cpp:249-257
    surf_leaf: float = 0.4
    outlier_leaf: float = 0.4
    surrounding_leaf: float = 1.0              # keyframe-pose dedup leaf
    search_radius: float = 50.0                # surroundingKeyframeSearchRadius
    search_num: int = 50                       # surroundingKeyframeSearchNum
    max_iterations: int = 10                   # mapOptmization.cpp:1341
    # Correspondence refresh cadence inside the scan-to-map LM.  The reference
    # re-searches 5-NN every iteration (=1); freezing the fitted line/plane
    # geometry between refreshes cuts the dominant kNN cost — the same
    # lagged-correspondence idiom the reference uses in odometry
    # (featureAssociation.cpp:1163, every 5th).  Measured ATE-equivalent at
    # 1/2/3 on the synthetic courtyard runs (0.019 m each); LM wall time
    # 63 -> 31 -> 10 -> 6.6 ms across the kernel + refresh work.
    corr_refresh_every: int = 3
    min_corner_map: int = 10                   # mapOptmization.cpp:1331
    min_surf_map: int = 100
    min_residuals: int = 50                    # mapOptmization.cpp:1238
    line_eig_ratio: float = 3.0                # lambda1 > 3*lambda2 (1128)
    plane_fit_tol: float = 0.2                 # reject plane if pt >0.2m off (1202)
    nn_max_dist: float = 1.0                   # 5th NN < 1m gate (1101,1183)
    robust_weight_scale: float = 0.9           # s = 1-0.9*|d| (1160,1213)
    robust_weight_min: float = 0.1
    degeneracy_eig_thresh: float = 100.0       # mapOptmization.cpp:1287
    conv_rot_deg: float = 0.05                 # mapOptmization.cpp:1323
    conv_trans_cm: float = 0.05
    keyframe_dist: float = 0.3                 # new keyframe iff moved >=0.3m (1360)
    imu_blend: float = 0.002                   # roll/pitch IMU blend weight (488-489)
    # Dense capacities.  Keyframes store the downsampled current scan, so the
    # per-keyframe cloud caps ARE the scan caps.
    max_keyframes: int = 4096
    # When the store comes within the driver's margin of max_keyframes,
    # hosts decimate it (mapping.decimate_keyframes via pipeline.
    # maybe_decimate): keep keyframe 0 + the most recent this-many + every
    # 2nd older one.  Old trajectory coarsens 0.3 -> 0.6 m per decimation —
    # bounded memory where the reference grows RAM without bound
    # (mapOptmization.cpp:84-86); overflow (a keyframe warranted while
    # full) is counted in KeyframeStore.overflow, never silent.
    decimate_keep_recent: int = 512
    # Submap caps: sized to hold a (search_radius + submap_rebuild_dist)-radius
    # voxel cache at the 0.2/0.4 m leaf sizes (measured: a 50 m courtyard
    # submap occupies ~15-20K surf voxels).  Since the scan-to-map kNN culls
    # far chunks by AABB, oversizing the caps costs almost nothing.
    submap_corner_cap: int = 12288             # submap cache sizes fed to LM
    submap_surf_cap: int = 49152
    # Incremental submap cache: full rebuild (gather + re-voxelize all nearby
    # keyframes) only when the pose strays this far from the rebuild origin,
    # the cache is marked stale by a loop correction, or >1 keyframe landed
    # since the last merge; otherwise each mapping step folds in at most one
    # new keyframe (weighted-centroid merge — associative, so exact).
    submap_rebuild_dist: float = 10.0
    # Pending keyframes fold into the cached submap in ONE re-voxelization
    # every this many insertions (update_submap_cache) instead of per step —
    # the per-step ~57K-row sort was the dominant mapping-step cost on the
    # chip.  Between folds the submap lags at most batch-1 keyframes (the
    # most recent = most redundant with the current scan); 1 restores the
    # per-step merge.  Measured (chip, grow-512): 1 -> 127, 4 -> 147, 8 ->
    # 158, 16 -> 160 scans/s; accuracy at 8 is ledger-equal (circuit fused
    # 0.498 m / 0.178% end drift vs 0.512 / 0.177% at 4; ring fused
    # 0.043 vs 0.039 m) while 16 saturates the gain with 2x the lag — 8 is
    # the knee.
    submap_merge_batch: int = 8
    # Submap keyframe selection:
    #   "radius" (default) — the reference's loopClosureEnableFlag=false path
    #     (mapOptmization.cpp:1001-1056): position-deduped radius search, with
    #     the incremental cache above.  Strictly better-behaved after loop
    #     corrections (cache invalidation is explicit) and the only mode that
    #     re-localizes against OLD keyframes on revisit.
    #   "recent" — the reference's loopClosureEnableFlag=true path
    #     (mapOptmization.cpp:961-1000): the submap is the most recent
    #     ``search_num`` keyframes' clouds (its recentCornerCloudKeyFrames
    #     deque), regardless of distance.  Rebuilt every mapping step (the
    #     deque membership changes with each keyframe, exactly as the
    #     reference re-concatenates it); use with loop.enabled=True to
    #     reproduce the reference's loop-closure-mode submap composition.
    submap_mode: str = "radius"
    scan_corner_cap: int = 2048                # downsampled current-scan sizes
    scan_surf_cap: int = 8192
    voxel_table_size: int = 1 << 17            # hash-table slots for voxel filters
    # 5-NN implementation: "auto" = single-distance-pass Pallas kernel on
    # TPU, XLA multi-pass elsewhere; "pallas" / "xla" force one.
    knn_backend: str = "auto"
    # --- map-feedback stabilizers (TPU-side; the reference has neither) ---
    # Scan-to-map LM runs only once the submap holds this many keyframes.
    # Below it the mapped pose = odometry-projected guess and keyframes are
    # stored from odometry, whose short-horizon relative drift is small —
    # matching a 1-2 keyframe single-view map instead injects 0.1-0.2 m
    # biases into the first keyframes (measured on motion-distorted synthetic
    # worlds), and those mutually-inconsistent keyframes smear the submap,
    # whose spurious optima then pull every later scan (runaway feedback).
    # Round 3: with the rotation-precision root cause fixed, a 2-keyframe
    # gate measured best — the scan-to-map alignment of keyframes 2+ halves
    # the cold-start transient's contribution on fast trajectories (766 m
    # circuit end drift 3.38 -> 1.69 m) at no cost on the ring world
    # (0.045 -> 0.047 m).  The round-2 value (4) predates that fix; the
    # round-5 audit (PERF.md) measured 0 (= reference, which has no such
    # gate) NEUTRAL on both ledger worlds (circuit 1.45 vs baseline 1.63 m
    # end drift), so the gate is OFF by default — the round-3 benefit was a
    # symptom of since-fixed cold-start behavior.
    min_lm_keyframes: int = 0
    # Per-step trust region on the LM's correction relative to the guess:
    # the guess already carries the previous correction, so a legitimate
    # NEW correction is bounded by odometry error accrued over one mapping
    # interval (~cm) plus map noise.  Steps beyond the cap are scaled down,
    # keeping the direction (never hard-rejected).  0 disables — the
    # DEFAULT since round 5: the audit (PERF.md) measured the trust region
    # EXACTLY neutral on both ledger worlds (circuit 1.6313 vs 1.6314 m end
    # drift), i.e. pure insurance that never fires outside genuinely
    # degenerate jumps; the reference has no analogue, so default-off keeps
    # the system explainable against it.  Re-enable (0.30 m / 2.0 deg) for
    # environments with expected correspondence aliasing.
    max_step_trans: float = 0.0            # meters
    max_step_rot_deg: float = 0.0
    # Odometry prior anchored at the guess (MAP formulation): the solve
    # minimizes  Σ map residuals² + ‖ξ_from_guess‖²_W  with
    # W = diag(rot_std⁻², trans_std⁻²).  In directions the map constrains
    # weakly (e.g. along a corridor: translation eigenvalue ~1e2 vs ~1e5 for
    # rotation) an unanchored LS leaks rotation error into translation and
    # the keyframes smear the map (runaway feedback, measured); the prior
    # makes those directions defer to odometry while strongly-constrained
    # directions (eigenvalues ≫ W) correct freely.  The reference
    # approximates this with its hard eigenvalue-100 clamp
    # (mapOptmization.cpp:1287) — an infinite prior below the threshold,
    # none above; the clamp is kept too.  std <= 0 disables the prior.
    prior_trans_std: float = 0.10          # m per mapping interval
    prior_rot_std_deg: float = 1.0
    # Ground-plane attitude/height anchor ("ground-optimized", taken to its
    # logical end for ground vehicles): after each scan-to-map solve, fit a
    # plane to the scan's ground picks in world frame and rotate
    # roll/pitch (about the pose position) + shift z so the plane matches
    # the first keyframe's ground (blend factor per step; 0 disables).
    # Rationale: odometry attitude drift (~0.05°/scan measured on synthetic
    # worlds without IMU) rotates each keyframe's cloud rigidly, smearing
    # far-range map geometry by range × spread and destabilizing the
    # scan-to-map feedback loop; the ground gives roll/pitch/z an ABSOLUTE
    # reference the way the reference's IMU blend does
    # (transformUpdate, mapOptmization.cpp:463-496) but without an IMU.
    # Guarded: applied only when enough ground points fit a near-horizontal
    # plane, so slopes/ramps degrade it gracefully to the unanchored solve.
    ground_anchor: float = 0.8
    ground_anchor_min_pts: int = 50
    ground_anchor_max_tilt_deg: float = 10.0


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    """ICP loop closure (reference: mapOptmization.cpp:802-945)."""

    enabled: bool = False                      # loopClosureEnableFlag (utility.h:104)
    # Closure-attempt cadence in SECONDS of data time (the reference runs a
    # 1 Hz wall-clock thread, mapOptmization.cpp:807; a deterministic replay
    # has no wall clock, so drivers schedule attempts by scan timestamp —
    # see pipeline.LoopScheduler).
    cadence: float = 1.0
    search_radius: float = 7.0                 # historyKeyframeSearchRadius
    history_num: int = 25                      # historyKeyframeSearchNum
    min_time_gap: float = 30.0                 # mapOptmization.cpp:832
    fitness_thresh: float = 0.3                # historyKeyframeFitnessScore
    icp_max_iters: int = 100                   # mapOptmization.cpp:894
    icp_max_corr_dist: float = 100.0
    icp_eps: float = 1e-6
    # "auto": Pallas packed-min kNN on TPU, XLA elsewhere; "xla"/"pallas"
    # force one (same contract as FeatureConfig.picks_backend et al.).
    icp_backend: str = "auto"
    submap_leaf: float = 0.4
    cur_cap: int = 8192                        # dense caps for the ICP clouds
    hist_cap: int = 32768


@dataclasses.dataclass(frozen=True)
class RelocalizeConfig:
    """Kidnapped-robot relocalization against a restored keyframe map
    (models/relocalize.py — the loop-closure ICP machinery,
    mapOptmization.cpp:875-945, generalized to multi-session resume; the
    reference itself has no relocalization)."""

    # Candidate keyframe cells: positions deduped at candidate_leaf, ranked
    # by distance to the prior belief.  n_candidates >= the number of
    # occupied cells makes the search global.
    candidate_leaf: float = 5.0
    n_candidates: int = 16
    # Headings tried per candidate (revisits approach from any direction;
    # point-to-point ICP needs a rough initial heading).
    yaw_hypotheses: int = 4
    # ±window keyframes form each candidate's history submap
    # (historyKeyframeSearchNum analogue, utility.h:133).
    window: int = 12
    submap_leaf: float = 0.4
    scan_leaf: float = 0.4
    cur_cap: int = 4096
    hist_cap: int = 16384
    icp_max_corr_dist: float = 100.0
    # Two-stage search: every hypothesis gets ``coarse_iters`` ICP
    # iterations (enough to separate the right place by fitness); the
    # winner alone gets the full ``icp_max_iters`` refine (the reference's
    # 100-iteration ICP setting, mapOptmization.cpp:894).
    coarse_iters: int = 10
    icp_max_iters: int = 60
    # The top-K coarse hypotheses are refined and the best REFINED fitness
    # wins — a single coarse winner can be a false match on self-similar
    # worlds (see models/relocalize.py).
    refine_top_k: int = 4
    icp_eps: float = 1e-6
    icp_backend: str = "auto"
    fitness_thresh: float = 0.3                # getFitnessScore accept bound


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    """Incremental SE(3) pose-graph optimizer replacing gtsam iSAM2
    (reference: mapOptmization.cpp:36-47,1353-1454).

    Instead of reproducing iSAM2's incremental Bayes-tree bookkeeping we re-solve
    the full graph each time a loop factor arrives
    (models/loopclosure.py:close_and_correct) with Gauss-Newton in LINK space —
    chain factors block-diagonal, loop factors rank-6 range terms, CG
    preconditioned by the exact chain inverse (see models/posegraph.py: the
    reference's 1e-8 chain variances are a 10^7 conditioning gap that stalls
    naive pose-space PCG).  Between loop
    factors no solve runs at all: with only prior + chain factors the graph's
    residual is exactly zero at the current estimate (each keyframe pose IS the
    composition of its chain measurements), so the reference's per-keyframe
    ``isam->update`` would return the input unchanged — see
    COMPONENTS.md's deviation list.  At <=20K poses a full re-solve is
    microseconds-scale on TPU and strictly more accurate than incremental
    relinearization.
    """

    # gtsam noiseModel VARIANCES (mapOptmization.cpp:347-350): rot 1e-6,
    # trans 1e-8 for both the prior and the odometry chain; loop factors carry
    # the ICP fitness score as an isotropic variance (mapOptmization.cpp:932-934).
    prior_rot_var: float = 1e-6
    prior_trans_var: float = 1e-8
    odom_rot_var: float = 1e-6
    odom_trans_var: float = 1e-8
    gn_iters: int = 8
    # Link-space CG (posegraph.py): preconditioned by the exact chain-block
    # inverse, the spectrum is 1 + at most 6·n_loop_factors outliers, so CG
    # terminates in ~6L+1 iterations INDEPENDENT of the 10^7 chain/loop
    # stiffness ratio; the cap covers L ~ 80 simultaneous factors and the
    # tolerance exits far earlier on typical graphs.
    pcg_iters: int = 512
    pcg_tol: float = 1e-8        # early exit when ||r||^2 <= pcg_tol * ||b||^2
    # gtsam's graph is unbounded (mapOptmization.cpp:939); this cap is a
    # compile-time shape.  The round-5 6-lap recency-regime run ACCEPTED 256
    # closures (reference 1 Hz cadence, continuous revisits) and measurably
    # degraded once the store saturated — size for multi-hour runs and watch
    # LoopFactors.dropped (no-silent-caps).  Arrays are tiny (~100 B/factor).
    max_loop_factors: int = 1024


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level bundle wired through the whole pipeline."""

    sensor: SensorConfig = VLP16
    seg: SegmentationConfig = SegmentationConfig()
    feat: FeatureConfig = FeatureConfig()
    odom: OdometryConfig = OdometryConfig()
    mapping: MappingConfig = MappingConfig()
    loop: LoopClosureConfig = LoopClosureConfig()
    posegraph: PoseGraphConfig = PoseGraphConfig()
    reloc: RelocalizeConfig = RelocalizeConfig()
    # (No use_imu flag: the IMU path is enabled by PRESENCE — pass an
    # ``imu_integral`` to the step functions / ``--imu`` to the CLI.  A config
    # flag duplicating that would be dead state.)
    # De-skew / intra-scan warp: when False, per-point rel_time is zeroed at
    # the projection boundary, disabling TransformToStart/End warps
    # everywhere (for pre-deskewed input clouds, or for isolating warp-model
    # effects in diagnostics).
    deskew: bool = True
    # Mapping cadence in scans.  The reference feeds features every 2nd frame
    # (featureAssociation.cpp:284) and throttles mapping to >=0.3 s
    # (mapOptmization.cpp:1499) => effectively every 3rd scan at 10 Hz.
    mapping_every: int = 3

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def for_sensor(name: str) -> "PipelineConfig":
    """DEFAULT scaled to a sensor geometry.

    The VLP-16 cap defaults undersize denser sensors: sectioned picks scale
    with the ring count (sections x picks x n_scan — e.g. VLS-128's
    6x4x128 = 3072 sharp candidates vs the 512 cap) and the per-scan
    downsampled clouds grow with point density.  Feature caps scale by the
    ring ratio (rounded up to 256 for kernel tiling); mapping scan caps
    scale too but stay within the Pallas kNN's 16-bit index budget.  The
    overflow counters (ScanFeatures.overflow, no-silent-caps) verify the
    scaled caps never truncate."""
    sensor = SENSORS[name]
    s = sensor.n_scan / 16.0
    if s <= 1.0:
        return DEFAULT.replace(sensor=sensor)

    def r(v, cap=1 << 16):
        return min(int(math.ceil(v * s / 256.0) * 256), cap)

    feat = dataclasses.replace(
        DEFAULT.feat, max_sharp=r(512), max_less_sharp=r(2048),
        max_flat=r(1024), max_less_flat=r(8192), max_outlier=r(2048))
    mapping = dataclasses.replace(
        DEFAULT.mapping,
        scan_corner_cap=r(2048, cap=8192),
        scan_surf_cap=r(8192, cap=32768))
    return DEFAULT.replace(sensor=sensor, feat=feat, mapping=mapping)


def apply_overrides(sub, kvs):
    """Apply ``["key=value", ...]`` CLI overrides to a frozen config
    dataclass, casting each value to the field's current type.  Shared by
    ``bench.py --set-map/--set-odo``, ``tools/eval_long.py`` and
    ``tools/diag_map.py --set``.  Booleans accept true/false/1/0 (any case);
    anything else raises instead of silently becoming False."""
    for kv in kvs:
        key, val = kv.split("=", 1)
        cur = getattr(sub, key)          # unknown keys raise AttributeError
        if isinstance(cur, bool):
            low = val.lower()
            if low in ("true", "1"):
                cast = True
            elif low in ("false", "0"):
                cast = False
            else:
                raise ValueError(
                    f"{key}: boolean override must be true/false/1/0, "
                    f"got {val!r}")
        elif isinstance(cur, str):
            cast = val
        else:
            cast = type(cur)(float(val))
        sub = dataclasses.replace(sub, **{key: cast})
    return sub


DEFAULT = PipelineConfig()

# Reference-exact preset: every TPU-side enhancement off, every schedule and
# count at the reference's hard-coded value.  This is the executable form of
# the "set X to reproduce the reference" notes scattered through the field
# docstrings above; tests/test_reference_preset.py runs it end-to-end and
# tests/test_oracle_parity.py checks its front-end against the NumPy oracle.
#   * picks 2/20/4          (featureAssociation.cpp:709,711,747)
#   * LM 25 iters, refresh every 5, step damping 0.05, robust after iter 5
#                            (featureAssociation.cpp:1163,1251,1321,1674)
#   * warp_blend 1.0         (TransformToEnd uses the scan's own transform,
#                            featureAssociation.cpp:885)
#   * scan-to-map refresh every iteration (mapOptmization.cpp:1093-1227)
#   * stabilizers (min_lm_keyframes / trust region / odometry prior / ground
#     anchor) OFF — the reference has none of them.
REFERENCE = PipelineConfig(
    feat=dataclasses.replace(
        FeatureConfig(), edge_per_section=2, edge_less_per_section=20,
        surf_per_section=4),
    odom=dataclasses.replace(
        OdometryConfig(), max_iterations=25, corr_refresh_every=5,
        step_damping=0.05, robust_after_iter=5, warp_blend=1.0,
        surf_tripod_max_dz=0.0),
    mapping=dataclasses.replace(
        MappingConfig(), corr_refresh_every=1, min_lm_keyframes=0,
        max_step_trans=0.0, max_step_rot_deg=0.0,
        prior_trans_std=0.0, prior_rot_std_deg=0.0,
        ground_anchor=0.0, submap_merge_batch=1),
)
