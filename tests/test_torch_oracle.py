"""The port's frontend and two-step LM against the NumPy oracles of the
reference's per-scan rules (``legoloam_tpu/oracle``): the contracts of
tests/test_oracle_parity.py and tests/test_odometry_oracle.py, with the
port (``device="cpu"``, each kernel's plain version) in place of the JAX
package.

Inputs are the JAX package's ray-cast scans under the REFERENCE preset,
with range noise from its PRNG keys as in the JAX tests, handed to both
sides as numpy arrays.  Tolerances are the JAX tests':

  * projection (valid cells, winning points exact; ranges 1e-6 relative),
    ground mask, cluster partition, segmented/outlier membership and ground
    flags, per-ring compaction order: exact;
  * curvature on ring interiors: 1e-2 relative + 1e-5 absolute (summation
    order); occlusion marks exact away from ring ends;
  * picked sets: Jaccard >= 0.80 (sharp, less-sharp, flat) and >= 0.90
    (less-flat, with <= 2% of the oracle's set missing) — the three
    documented deviations (numpy_frontend.py);
  * the two-step LM: rotation within 0.1 deg and translation within 0.03 m
    of the oracle's solve from the same clouds and seed, both within
    0.3 deg / 0.05 m of ground truth.
"""

import jax
import numpy as np
import pytest
import torch

from legoloam_tpu.config import REFERENCE as JREF
from legoloam_tpu.oracle import OracleFrontend
from legoloam_tpu.oracle import numpy_odometry as orc
from legoloam_tpu.ops.se3 import Pose as JPose
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch.models import odometry as todom
from legoloam_tpu_torch.ops import features as tfeat
from legoloam_tpu_torch.ops import projection as tproj
from legoloam_tpu_torch.ops import se3 as tse3
from legoloam_tpu_torch.ops import segmentation as tseg

from _torch_parity import npy, port_cfg, rot_angle_deg

CFG = port_cfg(JREF)
SENSOR = CFG.sensor
N_SCANS = 3
NOISE = 0.01  # separates ground curvatures so pick ordering is not tie-driven


def _scan(scene, poses, k, n, noise):
    """Scan k of an n-pose arc from the JAX ray caster (noise from
    PRNGKey(k)), as CPU tensors."""
    nxt = min(k + 1, n - 1)
    out = jsyn.raycast_scan(
        scene, JPose(poses.R[k], poses.t[k]), JREF.sensor,
        noise_key=jax.random.PRNGKey(k), noise_sigma=noise,
        next_pose=JPose(poses.R[nxt], poses.t[nxt]), motion=k + 1 < n)
    return tuple(torch.from_numpy(np.array(a)) for a in out)


def _frontend(pts, valid, ring, return_debug=False):
    img = tproj.project_scan(pts, valid, SENSOR, ring=ring)
    seg = tseg.segment(img, SENSOR, CFG.seg)
    return img, seg, tfeat.extract_features(img, seg, SENSOR, CFG.feat,
                                            return_debug=return_debug)


@pytest.fixture(scope="module")
def cases():
    scene = jsyn.default_scene()
    poses = jsyn.circle_trajectory(N_SCANS, radius=20.0, angular_rate=0.0075)
    oracle = OracleFrontend(JREF.sensor, JREF.seg, JREF.feat)
    out = []
    for k in range(N_SCANS):
        pts, valid, ring = _scan(scene, poses, k, N_SCANS, NOISE)
        img, seg, (clouds, dbg) = _frontend(pts, valid, ring, True)
        orc_out = oracle.process(npy(pts), npy(valid), npy(ring))
        out.append((npy(pts), img, seg, clouds, dbg, orc_out))
    return out


def test_projection_parity(cases):
    """projectPointCloud (imageProjection.cpp:211-257): same valid cells,
    same winning points, same ranges."""
    for pts, img, _, _, _, o in cases:
        repo_valid = npy(img.valid)
        orc_valid = o.full_idx >= 0
        np.testing.assert_array_equal(repo_valid, orc_valid)
        np.testing.assert_array_equal(npy(img.xyz)[repo_valid],
                                      pts[o.full_idx[orc_valid]])
        np.testing.assert_allclose(npy(img.rng)[repo_valid],
                                   o.range_mat[orc_valid], rtol=1e-6)


def test_ground_parity(cases):
    """groundRemoval (imageProjection.cpp:260-310): exact ground mask."""
    for _, _, seg, _, _, o in cases:
        np.testing.assert_array_equal(npy(seg.ground), o.ground_mat == 1)


def test_segmentation_parity(cases):
    """labelComponents + validity rule (imageProjection.cpp:370-460): the
    same cell partition up to relabelling, the same valid/invalid
    decisions, segmented/outlier membership and ground flags (319-355)."""
    for _, _, seg, _, _, o in cases:
        label = npy(seg.label)
        orc_cat = np.where(o.label_mat == -1, 0,
                           np.where(o.label_mat == 999999, 2, 1))
        cat = np.where(label == -1, 0,
                       np.where(label == tseg.OUTLIER_LABEL, 2, 1))
        np.testing.assert_array_equal(cat, orc_cat)
        m = orc_cat == 1
        uniq = np.unique(np.stack([o.label_mat[m], label[m]], axis=1),
                         axis=0)
        assert len(np.unique(uniq[:, 0])) == len(uniq)
        assert len(np.unique(uniq[:, 1])) == len(uniq)
        for got, cells in ((seg.segmented, o.seg_cell),
                           (seg.seg_ground_flag, o.seg_cell[o.seg_ground]),
                           (seg.outlier, o.outlier_cells)):
            want = np.zeros(SENSOR.n_points, bool)
            want[cells] = True
            np.testing.assert_array_equal(npy(got).reshape(-1), want)


def _compacted_cells(dbg):
    """Compacted layout -> flat cell ids, (N, H) with -1 padding."""
    n, hh = dbg.col.shape
    cells = np.arange(n)[:, None] * hh + npy(dbg.col)
    in_ring = np.arange(hh)[None, :] < npy(dbg.count)[:, None]
    return np.where(in_ring, cells, -1)


def test_compaction_and_curvature_parity(cases):
    """Per-ring compaction equals the reference's push order; curvature and
    occlusion equal the oracle's on ring interiors
    (featureAssociation.cpp:621-678)."""
    hw = CFG.feat.curvature_halfwin
    for _, _, _, _, dbg, o in cases:
        cells = _compacted_cells(dbg)
        count = npy(dbg.count)
        for r in range(SENSOR.n_scan):
            orc_cells = o.seg_cell[o.seg_row == r]
            assert count[r] == orc_cells.shape[0]
            np.testing.assert_array_equal(cells[r, :count[r]], orc_cells)
        curv, occl = npy(dbg.curvature), npy(dbg.occl_picked)
        offsets = np.concatenate([[0], np.cumsum(count)])
        for r in range(SENSOR.n_scan):
            c0, c1 = offsets[r], offsets[r + 1]
            cnt = c1 - c0
            if cnt < 2 * hw + 2:
                continue
            interior = slice(hw, cnt - hw)
            np.testing.assert_allclose(
                curv[r, interior], o.curvature[c0:c1][interior],
                rtol=1e-2, atol=1e-5)
            safe0 = max(2 * hw + 2, 5 - c0 + 2 * hw + 2)
            safe1 = cnt - (2 * hw + 2)
            if safe1 > safe0:
                np.testing.assert_array_equal(
                    occl[r, safe0:safe1],
                    o.neighbor_picked[c0:c1][safe0:safe1] > 0)


def _jacc(a, b):
    return len(a & b) / max(len(a | b), 1)


def test_feature_pick_parity(cases):
    """extractFeatures (featureAssociation.cpp:680-784): pick sets overlap
    the oracle's as the JAX package's do."""
    for _, _, _, _, dbg, o in cases:
        cells = _compacted_cells(dbg)
        lab = npy(dbg.label)
        for mask, want in ((lab == 2, o.sharp_cells),
                           (lab >= 1, o.less_sharp_cells),
                           (lab == -1, o.flat_cells)):
            got = set(cells[mask].tolist())
            assert _jacc(got, set(want.tolist())) >= 0.80, (
                len(got), len(want))
        lf = set(cells[npy(dbg.lf_mask)].tolist())
        o_lf = set(o.less_flat_cells.tolist())
        assert _jacc(lf, o_lf) >= 0.90
        assert len(o_lf - lf) / max(len(o_lf), 1) <= 0.02


def test_feature_clouds_match_labels(cases):
    """The exported feature clouds carry exactly the labelled cells."""
    for _, img, _, clouds, dbg, _ in cases:
        cells = _compacted_cells(dbg)
        lab = npy(dbg.label)
        xyz = npy(img.xyz).reshape(-1, 3)
        for cloud, m in ((clouds.sharp, lab == 2), (clouds.flat, lab == -1)):
            want = xyz[cells[m]]
            got = npy(cloud.xyz)[npy(cloud.valid)]
            assert want.shape == got.shape
            np.testing.assert_array_equal(
                np.sort(want.view([("", want.dtype)] * 3), axis=0),
                np.sort(got.view([("", got.dtype)] * 3), axis=0))


# ---------------------------------------------------------------------------
# The two-step LM against numpy_odometry.two_step_lm
# ---------------------------------------------------------------------------

def _compact(cloud):
    v = npy(cloud.valid)
    return npy(cloud.xyz)[v], npy(cloud.ring)[v], npy(cloud.rel_time)[v]


def test_seed_roundtrip():
    """The oracle's seed conversion inverts the port's SE(3) exponential:
    exp(xi) -> transformCur -> (R, t) to 1e-6 (float32 exponential)."""
    rng = np.random.RandomState(3)
    for _ in range(10):
        xi = np.concatenate([0.2 * rng.randn(3), 0.5 * rng.randn(3)])
        p = tse3.se3_exp(torch.tensor(xi, dtype=torch.float32))
        R, t = npy(p.R).astype(np.float64), npy(p.t).astype(np.float64)
        tc = orc._seed_to_transform(R, t)
        R_c = orc._rot_y(-tc[1]) @ orc._rot_x(-tc[0]) @ orc._rot_z(-tc[2])
        np.testing.assert_allclose(orc._P.T @ R_c @ orc._P, R, atol=1e-6)
        np.testing.assert_allclose(orc._P.T @ (-R_c @ tc[3:6]), t,
                                   atol=1e-6)


@pytest.mark.parametrize("k", [3, 4])
def test_two_step_lm_parity(k):
    """Warm-started scan pair (k, k+1) on the courtyard arc: the port's
    twist solve and the oracle's reference-rules solve, fed the same
    feature clouds, last clouds and constant-velocity seed, agree in SE(3)
    and both land near the ground-truth motion."""
    scene = jsyn.default_scene()
    n = 6
    poses = jsyn.circle_trajectory(n, radius=20.0, angular_rate=0.0075)
    feats = [_frontend(*_scan(scene, poses, i, n + 1, 0.005))[2]
             for i in range(k + 1)]
    # Every scan of the arc is motion-distorted towards the next pose, as
    # in the JAX test (its n - 1 scans all have a successor).
    state = todom.init_state(CFG.odom, CFG.feat, "cpu")
    for i in range(k):
        state, _, _ = todom.odometry_step(state, feats[i], CFG.odom)
    state2, _, _ = todom.odometry_step(state, feats[k], CFG.odom)
    M = tse3.se3_exp(state2.xi)
    R_t, t_t = npy(M.R).astype(np.float64), npy(M.t).astype(np.float64)

    lc_xyz, lc_ring, _ = _compact(state.last_corner)
    ls_xyz, ls_ring, _ = _compact(state.last_surf)
    q_flat, _, q_flat_s = _compact(feats[k].flat)
    q_sharp, _, q_sharp_s = _compact(feats[k].sharp)
    Ms = tse3.se3_exp(state.xi)
    seed = (npy(Ms.R).astype(np.float64), npy(Ms.t).astype(np.float64))
    R_np, t_np, info = orc.two_step_lm(
        q_flat, q_flat_s, ls_xyz, ls_ring, q_sharp, q_sharp_s, lc_xyz,
        lc_ring, nearest_sq_dist=CFG.odom.nearest_sq_dist,
        max_iterations=CFG.odom.max_iterations, seed=seed)
    assert info["n_surf"] >= 30 and info["n_corner"] >= 10

    gt = tse3.relative(
        tse3.Pose(torch.tensor(np.asarray(poses.R[k])),
                  torch.tensor(np.asarray(poses.t[k]))),
        tse3.Pose(torch.tensor(np.asarray(poses.R[k + 1])),
                  torch.tensor(np.asarray(poses.t[k + 1]))))
    R_gt, t_gt = npy(gt.R).astype(np.float64), npy(gt.t).astype(np.float64)
    assert rot_angle_deg(R_t, R_np) < 0.1, rot_angle_deg(R_t, R_np)
    assert np.linalg.norm(t_t - t_np) < 0.03, (t_t, t_np)
    for R_e, t_e, who in ((R_t, t_t, "port"), (R_np, t_np, "oracle")):
        assert rot_angle_deg(R_e, R_gt) < 0.3, who
        assert np.linalg.norm(t_e - t_gt) < 0.05, (who, t_e, t_gt)


def test_oracle_gates():
    """updateTransformation's entry gate (featureAssociation.cpp:1668-1669):
    a last surf cloud under 100 points leaves the seed motion unchanged, in
    the oracle and in the port's odometry step."""
    R, t, info = orc.two_step_lm(
        np.zeros((5, 3)), np.zeros(5), np.zeros((50, 3)), np.zeros(50),
        np.zeros((5, 3)), np.zeros(5), np.zeros((20, 3)), np.zeros(20))
    np.testing.assert_allclose(R, np.eye(3), atol=1e-15)
    np.testing.assert_allclose(t, np.zeros(3), atol=1e-15)
    assert info["n_surf"] == 0

    scene = jsyn.default_scene()
    poses = jsyn.circle_trajectory(2, radius=20.0, angular_rate=0.0075)
    feats = _frontend(*_scan(scene, poses, 0, 2, 0.0))[2]
    state = todom.init_state(CFG.odom, CFG.feat, "cpu")
    state, _, _ = todom.odometry_step(state, feats, CFG.odom)
    few = state.last_surf.valid & (torch.cumsum(
        state.last_surf.valid.to(torch.int64), 0) <= 50)
    state = state._replace(last_surf=state.last_surf._replace(valid=few))
    seed = torch.tensor([0.01, 0.0, 0.02, 0.1, 0.0, 0.0])
    nxt, pose, _ = todom.odometry_step(state, feats, CFG.odom, xi_seed=seed)
    assert torch.equal(nxt.xi, seed)
    want = tse3.compose(state.pose, tse3.se3_exp(seed))
    np.testing.assert_allclose(npy(pose.t), npy(want.t), atol=1e-6)
