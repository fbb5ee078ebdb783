"""The distributed paths of the port (``legoloam_tpu_torch/parallel/``) on
gloo ranks on the CPU, each rank a spawned process (``tests/_torch_dist.py``)
with every host decision checked equal across the ranks: the contracts of
tests/test_sharding.py, tests/test_pipeline_dist.py and
tests/test_scale_mesh.py on the port, the port at world size W against the
port's single device, and at W = 2 against the JAX package on a 2-device
mesh.  W = 3 runs stores and graphs whose size 3 does not divide (the
port's padding); W = 8 runs under ``slow``.

Tolerances.  Against the single device, the JAX tests' bounds (the submap's
voxel partition differs by rank, and float sums differ in order): pose
graph 1e-3, scan-to-map 1e-2 m / 1e-3, trajectories 0.05 m, loop closure
1e-3 m.  Against the JAX package at the same mesh size the per-rank voxel
partition is the same, so: equal submap voxel sets with centroids within
1e-5 m, pose-graph and scan-to-map poses within 1e-4, corrected loop poses
within 1e-3 m (the ICP tolerance of tests/test_torch_loopclosure.py), the
SLAM loop's fused trajectory and keyframe poses within 1e-3 m with equal
keyframe counts (the pipeline parity tolerance of
tests/test_torch_pipeline.py).  Round trips and window gathers are exact.
"""

import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu import config as jc
from legoloam_tpu.models import mapping as jmap
from legoloam_tpu.models import posegraph as jpg
from legoloam_tpu.ops import deskew as jdsk
from legoloam_tpu.ops import se3 as jse3
from legoloam_tpu.ops.se3 import Pose as JPose
from legoloam_tpu.parallel import costs as jcosts
from legoloam_tpu.parallel import mapping_dist as jmd
from legoloam_tpu.parallel import mesh as jmesh
from legoloam_tpu.parallel import pipeline_dist as jpd
from legoloam_tpu.parallel import posegraph_dist as jpgd
from legoloam_tpu.utils import io as jio
from legoloam_tpu.utils import synthetic as jsyn
from legoloam_tpu_torch.models import loopclosure as tloop
from legoloam_tpu_torch.models import mapping as tmap
from legoloam_tpu_torch.models import pipeline as tpipe
from legoloam_tpu_torch.models import posegraph as tpg
from legoloam_tpu_torch.ops.se3 import Pose as TPose
from legoloam_tpu_torch.parallel import costs as tcosts
from legoloam_tpu_torch.parallel import dryrun
from legoloam_tpu_torch.parallel import pipeline_dist as tpd
from legoloam_tpu_torch.parallel.mesh import Mesh
from legoloam_tpu_torch.utils import memory as tmem
from legoloam_tpu_torch.utils.interop import (dist_state_from_numpy,
                                              slam_state_from_numpy)

import _torch_dist
from _torch_parity import SMALL_MAP, npy, port_cfg, ring_scans, to_numpy_tree
from test_torch_loopclosure import LOOP_CFG, SOFT_PG, drifted_store

# tests/test_pipeline_dist.py's configuration: the mesh rebuilds its submap
# every step, so the single device merges every keyframe (batch 1).
DIST_MAP = dataclasses.replace(SMALL_MAP, submap_merge_batch=1)
JCFG = jc.DEFAULT.replace(mapping=DIST_MAP)
TCFG = port_cfg(JCFG)
PG = jc.PoseGraphConfig()
M_GRAPH = 64
N_SLAM = 9
N_IMU = 7


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32 if np.asarray(
        a).dtype == np.float64 else None, copy=True))


def _scans(n):
    return [tuple(_t(a) for a in s) for s in ring_scans(n)[0]]


# ---------------------------------------------------------------------------
# Inputs, from numpy seeds (each built once)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def graph():
    """tests/test_sharding.py's 40-node chain in a 64-node graph with one
    loop factor back to the start, the measurements from a numpy seed:
    (R, t, n, chain_R, chain_t, loop (i, j, R, t, var))."""
    rs = np.random.RandomState(0)
    n = 40
    eye = np.eye(3, dtype=np.float32)
    meas_R = [eye] + [np.asarray(jse3.so3_exp(jnp.asarray(
        0.05 * rs.randn(3), jnp.float32))) for _ in range(1, n)]
    meas_t = [np.zeros(3, np.float32)] + [
        np.array([1.0, 0.05, 0.0], np.float32)] * (n - 1)
    R0, t0 = [eye], [np.zeros(3, np.float32)]
    for i in range(1, n):
        R0.append(R0[-1] @ meas_R[i])
        t0.append(R0[-2] @ meas_t[i] + t0[-1])
    R = np.broadcast_to(eye, (M_GRAPH, 3, 3)).copy()
    cR = R.copy()
    t = np.zeros((M_GRAPH, 3), np.float32)
    ct = t.copy()
    R[:n], cR[:n], ct[:n] = np.stack(R0), np.stack(meas_R), np.stack(meas_t)
    t[:n] = np.stack(t0) + 0.2 * rs.randn(n, 3).astype(np.float32)
    loop = (0, n - 1, eye, np.stack(t0)[n - 1], 1e-6)
    return R, t, n, cR, ct, loop


def _graph_jax():
    R, t, n, cR, ct, (i, j, lR, lt, var) = graph()
    loops = jpg.add_loop_factor(jpg.init_loop_factors(16), i, j,
                                JPose(jnp.asarray(lR), jnp.asarray(lt)),
                                jnp.float32(var))
    prior = JPose(jnp.eye(3), jnp.zeros(3))
    return (jnp.asarray(R), jnp.asarray(t), jnp.int32(n), jnp.asarray(cR),
            jnp.asarray(ct), loops, prior, PG)


def _graph_port():
    R, t, n, cR, ct, (i, j, lR, lt, var) = graph()
    loops = tpg.add_loop_factor(tpg.init_loop_factors(16, "cpu"), i, j,
                                TPose(_t(lR), _t(lt)), var)
    return (_t(R), _t(t), torch.tensor(n, dtype=torch.int32), _t(cR), _t(ct),
            loops, TPose.identity(), port_cfg(PG))


S2M_CFG = dataclasses.replace(
    jc.DEFAULT.mapping, scan_corner_cap=512, scan_surf_cap=2048,
    submap_corner_cap=4096, submap_surf_cap=8192, knn_backend="xla")


@functools.lru_cache(maxsize=None)
def s2m_inputs():
    """tests/test_sharding.py's scan-to-map scene (a curved floor, a wall,
    a line of poles) with the poles drawn from a numpy seed, and the scan
    moved by a known small pose: numpy arrays in the argument order of
    ``scan_to_map`` (the guess first)."""
    rs = np.random.RandomState(7)
    gx, gy = np.meshgrid(np.linspace(0.0, 30.0, 64),
                         np.linspace(0.0, 30.0, 64))
    gz = -1.3 + 0.4 * np.sin(0.25 * gx.ravel()) * np.cos(0.2 * gy.ravel())
    floor = np.stack([gx.ravel(), gy.ravel(), gz], axis=1)
    wx, wz = np.meshgrid(np.linspace(0.0, 30.0, 64),
                         np.linspace(0.0, 4.0, 32))
    wy = -8.0 + 0.3 * np.sin(0.3 * wx.ravel())
    wall = np.stack([wx.ravel(), wy, wz.ravel()], axis=1)
    sub_s = np.concatenate([floor, wall, np.zeros((2048, 3))]).astype(
        np.float32)
    sub_sv = np.arange(8192) < 6144
    poles = np.concatenate([
        np.floor(rs.rand(2048, 1) * 8) * 4.0 + 1.0,
        np.full((2048, 1), 5.0), rs.rand(2048, 1) * 4.0], axis=1)
    sub_c = np.concatenate([poles, np.zeros((2048, 3))]).astype(np.float32)
    sub_cv = np.arange(4096) < 2048
    T_true = jse3.se3_exp(jnp.array([0.004, -0.006, 0.005, 0.04, -0.05,
                                     0.02]))
    inv = jse3.inverse(T_true)
    corner = np.asarray(jse3.transform_points(inv, jnp.asarray(sub_c[:512])))
    surf = np.asarray(jse3.transform_points(inv, jnp.asarray(sub_s[:2048])))
    return (corner, sub_cv[:512], surf, sub_sv[:2048], sub_c, sub_cv, sub_s,
            sub_sv), np.asarray(T_true.t)


def _s2m_port():
    arrays, _ = s2m_inputs()
    return (TPose.identity(), *(_t(a) for a in arrays), port_cfg(S2M_CFG))


SUBMAP_CFG = dataclasses.replace(
    jc.DEFAULT.mapping, max_keyframes=32, scan_corner_cap=64,
    scan_surf_cap=256, submap_corner_cap=4096, submap_surf_cap=16384)


@functools.lru_cache(maxsize=None)
def small_store():
    """tests/test_sharding.py's 10-keyframe store of random clouds (numpy
    seed) 2 m apart, in a 32-slot store."""
    rs = np.random.RandomState(0)
    kf = to_numpy_tree(jmap.init_state(SUBMAP_CFG).kf)
    kf = kf._replace(**{f: np.array(getattr(kf, f)) for f in kf._fields})
    for k in range(10):
        pts = (rs.rand(SUBMAP_CFG.scan_surf_cap, 3) * 10).astype(np.float32)
        kf.t[k] = [2.0 * k, 0.0, 0.0]
        kf.surf[k], kf.surf_valid[k] = pts, True
        kf.corner[k] = pts[:SUBMAP_CFG.scan_corner_cap]
        kf.corner_valid[k] = True
    return kf._replace(count=np.int32(10))


@functools.lru_cache(maxsize=None)
def single_run(n):
    """The port's single device over the first ``n`` ring scans (the mesh
    comparisons' reference): fused positions and the final store."""
    st = tpipe.init_slam_state(TCFG, "cpu")
    fused = []
    for k, s in enumerate(_scans(n)):
        st, out = tpipe.slam_scan_step(st, *s, TCFG, k * 0.1,
                                       run_mapping=(k % TCFG.mapping_every
                                                    == 0))
        fused.append(npy(out.fused_pose.t))
    return np.stack(fused), st.mapping.kf


@functools.lru_cache(maxsize=None)
def imu_world():
    """tests/test_pipeline_dist.py's IMU world: 7 scans and each scan's
    integral of the JAX package's synthetic IMU, as JAX arrays."""
    scene = jsyn.default_scene()
    poses = jsyn.circle_trajectory(N_IMU + 1, radius=20.0,
                                   angular_rate=0.0075)
    ts, rpy, acc, gyro = jsyn.make_imu(poses, scan_period=0.1)
    seq = jio.ImuSequence(np.asarray(ts), np.asarray(rpy), np.asarray(acc),
                          np.asarray(gyro), window=64)
    scans = [jsyn.raycast_scan(
        scene, JPose(poses.R[k], poses.t[k]), JCFG.sensor,
        next_pose=JPose(poses.R[k + 1], poses.t[k + 1]), motion=True)
        for k in range(N_IMU)]
    integs = [jdsk.integrate_imu(seq.window_for(k * 0.1, 0.1))
              for k in range(N_IMU)]
    return scans, integs


@functools.lru_cache(maxsize=None)
def imu_inputs():
    """``imu_world`` as the port's tensors."""
    scans, integs = imu_world()
    return ([tuple(_t(a) for a in s) for s in scans],
            [slam_state_from_numpy(to_numpy_tree(g), "cpu") for g in integs])


@functools.lru_cache(maxsize=None)
def imu_single():
    """The port's single device over the IMU world with the bootstrap:
    fused positions and the keyframe count."""
    scans, integs = imu_inputs()
    st = tpipe.init_slam_state(TCFG, "cpu")
    fused = []
    for k, s in enumerate(scans):
        st, out = tpipe.slam_scan_step(
            st, *s, TCFG, k * 0.1, run_mapping=(k % TCFG.mapping_every == 0),
            imu_integral=integs[k], bootstrap=(k == 1))
        fused.append(npy(out.fused_pose.t))
    return np.stack(fused), int(st.mapping.kf.count)


def _store_port(kf_np):
    return slam_state_from_numpy(kf_np, "cpu")


def cases(w):
    """Every case a world-size-w spawn runs, with its inputs."""
    kf9 = single_run(N_SLAM)[1]
    center = kf9.t[int(kf9.count) - 1]
    n_fe = 2 * w
    batch = tuple(torch.stack(x) for x in zip(*_scans(n_fe)))
    imu_scans, integs = imu_inputs()
    return [
        ("posegraph", _graph_port()),
        ("scan_to_map", _s2m_port()),
        ("submap_sharded", (_store_port(small_store()),
                            torch.tensor([6.0, 0.0, 0.0]),
                            port_cfg(SUBMAP_CFG))),
        ("submap_dist", (kf9, center, TCFG.mapping)),
        ("roundtrip", (kf9, torch.tensor([0, 2, 3, 1]))),
        ("loop", (_store_port(drifted_store()),
                  tpg.init_loop_factors(8, "cpu"), port_cfg(LOOP_CFG),
                  port_cfg(SOFT_PG))),
        ("slam", (_scans(N_SLAM), TCFG)),
        ("slam_imu", (imu_scans, integs, TCFG)),
        ("frontend", (batch, TCFG)),
    ]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Rank 0's results of every case at W = 2 and at W = 3, by W.  The two
    spawns run while this process computes the references."""
    single_run(N_SLAM)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        runs = {w: ex.submit(_torch_dist.spawn, cases(w), w,
                             tmp_path_factory.mktemp(f"w{w}"))
                for w in (2, 3)}
        imu_single()
        jax_mesh2()
        return {w: f.result() for w, f in runs.items()}


@pytest.fixture(params=[2, 3], ids=["W2", "W3"])
def world(request, worlds):
    """(W, rank 0's results at world size W)."""
    return request.param, worlds[request.param]


@functools.lru_cache(maxsize=None)
def jax_mesh2():
    """The JAX package's distributed functions on a 2-device mesh, on the
    same inputs (the tight comparisons)."""
    mesh = jmesh.make_mesh(2)
    out = {}
    out["posegraph"] = tuple(np.asarray(a) for a in jpgd.optimize_sharded(
        *_graph_jax(), mesh))
    arrays, _ = s2m_inputs()
    T, it, nc, ns = jmd.scan_to_map_sharded(
        JPose(jnp.eye(3), jnp.zeros(3)), *map(jnp.asarray, arrays),
        S2M_CFG, mesh)
    out["scan_to_map"] = (np.asarray(T.R), np.asarray(T.t), int(it),
                          int(nc), int(ns))
    skf = jmd.shard_keyframes(jax.tree.map(jnp.asarray, small_store()), mesh)
    out["submap_sharded"] = jax.tree.map(
        np.asarray, jmd.extract_submap_sharded(
            skf, jnp.array([6.0, 0.0, 0.0]), SUBMAP_CFG, mesh))
    kf9 = tmap_to_jax(single_run(N_SLAM)[1])
    dkf = jpd.from_keyframe_store(kf9, mesh)
    center = kf9.t[int(kf9.count) - 1]
    out["submap_dist"] = jax.tree.map(np.asarray, jpd.extract_submap_dist(
        dkf, center, JCFG.mapping, mesh))
    dkf = jpd.from_keyframe_store(jax.tree.map(jnp.asarray, drifted_store()),
                                  mesh)
    kf2, _, cor, diag = jpd.close_and_correct_dist(
        dkf, jpg.init_loop_factors(8), LOOP_CFG, SOFT_PG, mesh)
    out["loop"] = (np.asarray(kf2.R), np.asarray(kf2.t), np.asarray(cor.t),
                   bool(diag.closed), int(diag.candidate),
                   float(diag.fitness))
    # The SLAM loop: the streaming step as the port's "slam" case drives
    # it, and the driver with IMU integrals and the bootstrap.
    st = jpd.init_dist_state(JCFG, mesh)
    fused = []
    for k, s in enumerate(ring_scans(N_SLAM)[0]):
        st, o = jpd.slam_scan_step_dist(
            st, *map(jnp.asarray, s), JCFG, mesh, k * 0.1,
            run_mapping=(k % JCFG.mapping_every == 0))
        fused.append(np.asarray(o.fused_pose.t))
    out["slam"] = (np.stack(fused), int(st.mapping.kf.count),
                   np.asarray(st.mapping.kf.t))
    scans, integs = imu_world()
    traj, st = jpd.run_slam_sequence_dist(scans, JCFG, mesh,
                                          imu_integrals=integs)
    out["slam_imu"] = (np.asarray(traj.t), int(st.mapping.kf.count),
                       np.asarray(st.mapping.kf.t))
    return out


def _slam_matches_jax(ours, theirs):
    """The port's SLAM loop at W = 2 against the JAX package's at mesh 2:
    equal keyframe counts, fused trajectory and keyframe poses within
    1e-3 m."""
    fused, count, kf_t, _ = ours
    jfused, jcount, jkf_t = theirs
    assert int(count) == jcount
    np.testing.assert_allclose(fused, jfused, atol=1e-3)
    np.testing.assert_allclose(kf_t[:jcount], jkf_t[:jcount], atol=1e-3)


def tmap_to_jax(kf):
    """The port's store as the JAX package's."""
    return jmap.KeyframeStore(*(jnp.asarray(npy(a)) for a in kf))


def _cells(pts, ok, leaf):
    q = np.floor(np.asarray(pts)[np.asarray(ok)] / leaf).astype(np.int64)
    return set(map(tuple, q))


def _voxels_equal(ours, theirs, tol=1e-5):
    """Equal voxel sets (valid rows) and centroids within ``tol``."""
    (c, cv), (s, sv) = ours
    (jc_, jcv), (js, jsv) = theirs
    for p, v, q, w in ((c, cv, jc_, jcv), (s, sv, js, jsv)):
        p, q = np.asarray(p)[np.asarray(v)], np.asarray(q)[np.asarray(w)]
        assert p.shape == q.shape
        order_p = np.lexsort(p.T[::-1])
        order_q = np.lexsort(q.T[::-1])
        np.testing.assert_allclose(p[order_p], q[order_q], atol=tol)


# ---------------------------------------------------------------------------
# tests/test_sharding.py on the port
# ---------------------------------------------------------------------------

def test_ranks_run_and_a_diverging_rank_fails(tmp_path):
    """(test_eight_devices_available's counterpart) ``launch`` starts W
    ranks that see their rank and the world size; a decision that differs
    between ranks fails the run instead of hanging it."""
    from legoloam_tpu_torch.parallel.mesh import launch
    out = tmp_path / "ranks.txt"
    launch(_torch_dist.world_report, 3, args=(str(out),), device="cpu",
           timeout_s=60)
    assert out.read_text() == "0 1 2 of 3"
    with pytest.raises(Exception, match="differs between ranks"):
        launch(_torch_dist.diverge, 2, device="cpu", timeout_s=30, strict=True)


def test_make_mesh_defaults_to_the_card(tmp_path):
    """Over a gloo group, ``make_mesh`` without a device puts the rank on
    the card, and raises when there is none; the CPU only when asked."""
    import torch.distributed as tdist
    from legoloam_tpu_torch.parallel.mesh import make_mesh
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                             world_size=1, rank=0)
    try:
        if torch.cuda.is_available():
            assert make_mesh().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make_mesh()
        assert make_mesh(1, device="cpu").device == torch.device("cpu")
    finally:
        tdist.destroy_process_group()


def test_distributed_posegraph_matches_single_device(world):
    w, res = world
    R1, t1 = tpg.optimize(*_graph_port())
    Rw, tw = res["posegraph"]
    n = graph()[2]
    assert Rw.shape == (M_GRAPH, 3, 3) and tw.shape == (M_GRAPH, 3)
    np.testing.assert_allclose(tw[:n], npy(t1)[:n], atol=1e-3)
    np.testing.assert_allclose(Rw[:n], npy(R1)[:n], atol=1e-3)
    np.testing.assert_array_equal(tw[n:], npy(t1)[n:])
    if w == 2:
        jR, jt = jax_mesh2()["posegraph"]
        np.testing.assert_allclose(tw, jt, atol=1e-4)
        np.testing.assert_allclose(Rw, jR, atol=1e-4)


def test_dp_frontend_matches_single_scan(world):
    w, res = world
    sharp, less_flat, idx = res["frontend"]
    assert idx.tolist() == list(range(2 * w))
    for k, s in enumerate(_scans(2 * w)):
        single = tpipe.process_scan(*s, TCFG)
        np.testing.assert_allclose(sharp[k], npy(single.sharp.xyz), atol=1e-5)
        np.testing.assert_array_equal(less_flat[k],
                                      npy(single.less_flat.valid))


def test_sharded_submap_matches_single_device(world):
    w, res = world
    kf = _store_port(small_store())
    (c1, cv1), (s1, sv1) = tmap.extract_submap(
        kf, torch.tensor([6.0, 0.0, 0.0]), port_cfg(SUBMAP_CFG))
    (cw, cvw), (sw, svw) = res["submap_sharded"]
    k1, kw = _cells(npy(s1), npy(sv1), 0.2), _cells(sw, svw, 0.2)
    assert len(k1 & kw) / max(len(k1 | kw), 1) > 0.95
    if w == 2:
        _voxels_equal(res["submap_sharded"], jax_mesh2()["submap_sharded"])


def test_sharded_scan_to_map_matches_single_device(world):
    w, res = world
    T1, it1, nc1, ns1 = tmap.scan_to_map(*_s2m_port())
    (R, t), it, nc, ns = res["scan_to_map"]
    assert abs(int(it1) - int(it)) <= 1
    assert abs(int(nc1) - int(nc)) <= 5
    assert abs(int(ns1) - int(ns)) <= 30
    np.testing.assert_allclose(t, npy(T1.t), atol=1e-2)
    np.testing.assert_allclose(R, npy(T1.R), atol=1e-3)
    assert abs(float(t[2]) - float(s2m_inputs()[1][2])) < 0.05
    if w == 2:
        jR, jt, jit, jnc, jns = jax_mesh2()["scan_to_map"]
        assert (int(it), int(nc), int(ns)) == (jit, jnc, jns)
        np.testing.assert_allclose(t, jt, atol=1e-4)
        np.testing.assert_allclose(R, jR, atol=1e-4)


def test_costs_match_jax():
    """``costs.py`` is a verbatim copy: its dicts equal the JAX package's
    for 1, 2, 3 and 8 devices."""
    jm, tm = jc.DEFAULT.mapping, port_cfg(jc.DEFAULT.mapping)
    for n in (1, 2, 3, 8):
        assert tcosts.dist_mapping_step_cost(tm, n) == \
            jcosts.dist_mapping_step_cost(jm, n)
        assert tcosts.loop_closure_gather_cost(
            port_cfg(jc.DEFAULT.loop), tm, n) == \
            jcosts.loop_closure_gather_cost(jc.DEFAULT.loop, jm, n)
    assert tcosts.single_mapping_step_cost(tm) == \
        jcosts.single_mapping_step_cost(jm)


# ---------------------------------------------------------------------------
# tests/test_pipeline_dist.py on the port
# ---------------------------------------------------------------------------

def test_dist_slam_matches_single_device(world):
    """9 scans over the ranks against the single device: the trajectories
    agree to centimetres (the submap's per-rank voxel partition is the
    only difference), the keyframe counts and poses too, and the store
    gathered back holds the single device's keyframe clouds' slots."""
    w, res = world
    single, kf1 = single_run(N_SLAM)
    fused, count, kf_t, back = res["slam"]
    assert np.all(np.isfinite(fused))
    assert int(count) == int(kf1.count)
    np.testing.assert_allclose(fused, single, atol=0.05)
    n_kf = int(kf1.count)
    np.testing.assert_allclose(kf_t[:n_kf], npy(kf1.t)[:n_kf], atol=0.05)
    assert back.corner.shape == tuple(kf1.corner.shape)
    np.testing.assert_array_equal(back.corner_valid[n_kf:], False)
    if w == 2:
        _slam_matches_jax(res["slam"], jax_mesh2()["slam"])


def test_store_roundtrip_and_window_gather(world):
    w, res = world
    kf = single_run(N_SLAM)[1]
    back, (c, cv, s, sv), m_loc = res["roundtrip"]
    assert m_loc == -(-TCFG.mapping.max_keyframes // w)
    for name in kf._fields:
        np.testing.assert_array_equal(getattr(back, name),
                                      npy(getattr(kf, name)), err_msg=name)
    idxs = [0, 2, 3, 1]
    np.testing.assert_array_equal(c, npy(kf.corner[idxs]))
    np.testing.assert_array_equal(cv, npy(kf.corner_valid[idxs]))
    np.testing.assert_array_equal(s, npy(kf.surf[idxs]))
    np.testing.assert_array_equal(sv, npy(kf.surf_valid[idxs]))


def test_dist_submap_covers_single_device(world):
    w, res = world
    kf = single_run(N_SLAM)[1]
    center = kf.t[int(kf.count) - 1]
    (c1, cv1), (s1, sv1) = tmap.extract_submap(kf, center, TCFG.mapping)
    (c2, cv2), (s2, sv2) = res["submap_dist"]
    mc = TCFG.mapping
    missing_c = _cells(npy(c1), npy(cv1), mc.corner_leaf) \
        - _cells(c2, cv2, mc.corner_leaf)
    missing_s = _cells(npy(s1), npy(sv1), mc.surf_leaf) \
        - _cells(s2, sv2, mc.surf_leaf)
    assert len(missing_c) <= max(2, 0.005 * int(cv1.sum())), missing_c
    assert len(missing_s) <= max(2, 0.005 * int(sv1.sum())), missing_s
    if w == 2:
        _voxels_equal(res["submap_dist"], jax_mesh2()["submap_dist"])


def test_dist_loop_closure_matches_single_device(world):
    w, res = world
    kf = _store_port(drifted_store())
    kf1, loops1, cor1, diag1 = tloop.close_and_correct(
        kf, tpg.init_loop_factors(8, "cpu"), port_cfg(LOOP_CFG),
        port_cfg(SOFT_PG))
    R2, t2, cor2, diag2, n_loops = res["loop"]
    assert bool(diag1.closed) and bool(diag2.closed)
    assert int(diag2.candidate) == int(diag1.candidate)
    assert int(n_loops) == int(loops1.count) == 1
    np.testing.assert_allclose(float(diag2.fitness), float(diag1.fitness),
                               atol=1e-4)
    n = int(kf.count)
    np.testing.assert_allclose(t2[:n], npy(kf1.t)[:n], atol=1e-3)
    np.testing.assert_allclose(R2[:n], npy(kf1.R)[:n], atol=1e-3)
    np.testing.assert_allclose(cor2.t, npy(cor1.t), atol=1e-3)
    if w == 2:
        jR, jt, jcor, jclosed, jcand, jfit = jax_mesh2()["loop"]
        assert jclosed and jcand == int(diag2.candidate)
        np.testing.assert_allclose(t2[:n], jt[:n], atol=1e-3)
        np.testing.assert_allclose(R2[:n], jR[:n], atol=1e-3)
        np.testing.assert_allclose(float(diag2.fitness), jfit, rtol=1e-3)


def test_dist_slam_imu_bootstrap_matches_single_device(world):
    """``run_slam_sequence_dist`` with IMU integrals and the bootstrap
    against the single device's streaming step, and at W = 2 against the
    JAX package's ``run_slam_sequence_dist``."""
    w, res = world
    single, count1 = imu_single()
    fused, count, _, _ = res["slam_imu"]
    assert np.all(np.isfinite(fused))
    assert int(count) == count1
    np.testing.assert_allclose(fused, single, atol=0.05)
    if w == 2:
        _slam_matches_jax(res["slam_imu"], jax_mesh2()["slam_imu"])


@pytest.mark.slow
def test_dist_slam_hdl32e(tmp_path):
    """The distributed loop end to end on the 32-ring geometry, 8 ranks."""
    cfg = TCFG.replace(sensor=port_cfg(jc.SENSORS["hdl32e"]))
    scene = jsyn.default_scene()
    poses = jsyn.circle_trajectory(7, radius=20.0, angular_rate=0.0075)
    scans = [tuple(_t(a) for a in jsyn.raycast_scan(
        scene, JPose(poses.R[k], poses.t[k]), jc.SENSORS["hdl32e"],
        next_pose=JPose(poses.R[k + 1], poses.t[k + 1]), motion=True))
        for k in range(6)]
    res = _torch_dist.spawn([("slam", (scans, cfg))], 8, tmp_path)
    fused, count, _, _ = res["slam"]
    assert np.all(np.isfinite(fused)) and int(count) >= 1
    gt = np.asarray(poses.t)[:6]
    from legoloam_tpu_torch.utils import metrics
    ate = float(metrics.ate_rmse(torch.from_numpy(fused),
                                 torch.from_numpy(gt - gt[0]).float()))
    assert ate < 0.5, ate


@pytest.mark.slow
def test_dist_block_matches_dist_streaming(tmp_path):
    """slam_scan_block_dist equals B streaming slam_scan_step_dist calls
    (both are loops over the same step here)."""
    res = _torch_dist.spawn([("block", (_scans(2 * TCFG.mapping_every),
                                        TCFG))], 2, tmp_path)
    stream, block, n1, n2 = res["block"]
    assert int(n1) == int(n2)
    np.testing.assert_array_equal(block, stream)


# ---------------------------------------------------------------------------
# W = 8 and tests/test_scale_mesh.py on the port (slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_eight_ranks_match_jax_mesh8(tmp_path):
    """The pose graph, scan-to-map and per-rank submap at W = 8 against the
    JAX package on its 8-device mesh."""
    res = _torch_dist.spawn([c for c in cases(8) if c[0] in (
        "posegraph", "scan_to_map", "submap_sharded")], 8, tmp_path)
    mesh = jmesh.make_mesh(8)
    jR, jt = jpgd.optimize_sharded(*_graph_jax(), mesh)
    np.testing.assert_allclose(res["posegraph"][1], np.asarray(jt), atol=1e-4)
    arrays, _ = s2m_inputs()
    T, _, _, _ = jmd.scan_to_map_sharded(
        JPose(jnp.eye(3), jnp.zeros(3)), *map(jnp.asarray, arrays),
        S2M_CFG, mesh)
    np.testing.assert_allclose(res["scan_to_map"][0][1], np.asarray(T.t),
                               atol=1e-4)
    skf = jmd.shard_keyframes(jax.tree.map(jnp.asarray, small_store()), mesh)
    _voxels_equal(res["submap_sharded"], jax.tree.map(
        np.asarray, jmd.extract_submap_sharded(
            skf, jnp.array([6.0, 0.0, 0.0]), SUBMAP_CFG, mesh)))


@pytest.mark.slow
def test_16k_keyframes_shard_and_match_single_device(tmp_path):
    """tests/test_scale_mesh.py's 16,000 keyframes in a 16,384-slot store
    over 8 ranks: each rank holds M/8 cloud slots, and the distributed
    submap covers the single device's voxel set."""
    from test_scale_mesh import CFG_M, N_KF, _big_store
    kf = slam_state_from_numpy(to_numpy_tree(_big_store()), "cpu")
    center = kf.t[N_KF - 100]
    res = _torch_dist.spawn([("roundtrip", (kf, torch.tensor([0, 1]))),
                             ("submap_dist", (kf, center, port_cfg(CFG_M)))],
                            8, tmp_path)
    assert res["roundtrip"][2] == CFG_M.max_keyframes // 8
    (c1, cv1), (s1, sv1) = tmap.extract_submap(kf, center, port_cfg(CFG_M))
    (c2, cv2), (s2, sv2) = res["submap_dist"]
    ref_c = _cells(npy(c1), npy(cv1), CFG_M.corner_leaf)
    ref_s = _cells(npy(s1), npy(sv1), CFG_M.surf_leaf)
    assert len(ref_c - _cells(c2, cv2, CFG_M.corner_leaf)) \
        <= max(4, 0.01 * len(ref_c))
    assert len(ref_s - _cells(s2, sv2, CFG_M.surf_leaf)) \
        <= max(4, 0.01 * len(ref_s))


# ---------------------------------------------------------------------------
# Interchange, memory, the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [0, 1])
def test_jax_dist_state_to_a_rank(rank):
    """A JAX ``DistSlamState`` on a 2-device mesh, read back as numpy,
    becomes rank r's part of the port's distributed state: the store's
    slots those of the port's own ``from_keyframe_store``, the replicated
    parts whole."""
    kf_np = drifted_store()
    jmesh2 = jmesh.make_mesh(2)
    jcfg = jc.DEFAULT.replace(mapping=dataclasses.replace(
        jc.DEFAULT.mapping, max_keyframes=kf_np.t.shape[0]))
    jst = jpd.init_dist_state(jcfg, jmesh2)
    jst = jst._replace(mapping=jst.mapping._replace(
        kf=jpd.from_keyframe_store(jax.tree.map(jnp.asarray, kf_np),
                                   jmesh2)))
    mesh = Mesh(size=2, rank=rank, axis="data", device=torch.device("cpu"))
    ours = dist_state_from_numpy(to_numpy_tree(jst), mesh)
    assert type(ours) is tpd.DistSlamState
    ref = tpd.from_keyframe_store(_store_port(kf_np), mesh)
    for name in ref._fields:
        assert torch.equal(getattr(ours.mapping.kf, name),
                           getattr(ref, name)), name
    empty = tpd.init_dist_state(port_cfg(jcfg), mesh)
    for a, b in zip(tmem._leaves(ours.odom), tmem._leaves(empty.odom)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("w", [1, 2, 3])
def test_dist_state_bytes_match_the_allocation(w):
    """``memory.dist_state_bytes`` against ``init_dist_state`` built for
    rank 0 on the meta device (W = 3: the padded slots of a 128-slot
    store)."""
    mesh = Mesh(size=w, rank=0, axis="data", device=torch.device("meta"))
    st = tpd.init_dist_state(TCFG, mesh)
    b = tmem.dist_state_bytes(TCFG, w)
    kf = st.mapping.kf
    assert b["kf_clouds_per_shard"] == tmem.tree_bytes(
        (kf.corner, kf.corner_valid, kf.surf, kf.surf_valid))
    assert b["kf_poses_replicated"] == tmem.tree_bytes(
        (kf.R, kf.t, kf.time, kf.chain_R, kf.chain_t, kf.count, kf.overflow))
    assert b["odom_replicated"] == tmem.tree_bytes(st.odom)
    assert b["loops_replicated"] == tmem.tree_bytes(st.loops)
    assert kf.corner.shape[0] == -(-TCFG.mapping.max_keyframes // w)


def test_dryrun_multichip_on_two_cpu_ranks():
    dryrun.dryrun_multichip(2, device="cpu")
