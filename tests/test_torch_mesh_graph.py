"""The mesh step and the block driver through the static-buffer path of
``models/step_graph.py`` (``StaticRunner``: the CUDA graph runner's
dataflow, each chain of segments between two host reads run again as plain
calls) on the CPU.

Two gloo ranks (``tests/_torch_dist.py``, every read checked equal across
the ranks) drive the mesh step through ``StaticRunner`` and eagerly over
the ring scans, with a plain scan, the bootstrap, mapping scans and a loop
attempt: bitwise equal, and the host reads 0 on a plain scan, at most 1 on
a mapping scan (the mesh rebuilds its submap and reads none) and on the
loop attempt the single device's count (its ICP's chunks, the acceptance,
the CG's chunks).  The W = 2 SLAM stream through ``StaticRunner`` against
the JAX package's 2-device mesh within 1e-3 m with equal keyframe counts
(tests/test_torch_parallel.py's tolerance).  On gloo the step is not
captured.

``slam_scan_block`` through ``StaticRunner`` against B streaming steps,
bitwise, with one read a block (the submap branch) and two graphs a
block (each replayed, or captured the first time its chain is seen).
"""

import concurrent.futures
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legoloam_tpu.parallel import mesh as jmesh
from legoloam_tpu.parallel import pipeline_dist as jpd
from legoloam_tpu_torch.models import pipeline as tpipe
from legoloam_tpu_torch.models import step_graph
from legoloam_tpu_torch.ops.segments import leaves, map_tree

import _torch_dist
from _torch_parity import ring_scans
from test_torch_parallel import JCFG, N_SLAM, TCFG, _scans
from test_torch_step_graph import _integral

# Loop closure on, with a time gap and radius that let the ring's own
# recent keyframes be candidates (tests/test_torch_step_graph.py's), and
# an attempt at scan 6.
LOOP_CFG = TCFG.replace(loop=dataclasses.replace(
    TCFG.loop, enabled=True, min_time_gap=0.3, search_radius=20.0))
LOOP_AT = 6


@functools.lru_cache(maxsize=None)
def jax_slam2():
    """The JAX package's SLAM stream on a 2-device mesh over the ring
    scans (tests/test_torch_parallel.py's "slam" reference)."""
    mesh = jmesh.make_mesh(2)
    st = jpd.init_dist_state(JCFG, mesh)
    fused = []
    for k, s in enumerate(ring_scans(N_SLAM)[0]):
        st, o = jpd.slam_scan_step_dist(
            st, *map(jnp.asarray, s), JCFG, mesh, k * 0.1,
            run_mapping=(k % JCFG.mapping_every == 0))
        fused.append(np.asarray(o.fused_pose.t))
    return (np.stack(fused), int(st.mapping.kf.count),
            np.asarray(st.mapping.kf.t))


def single_loop_reads():
    """The single device's reads by name on each scan of the same run."""
    sg = step_graph.StepGraph(tpipe.init_slam_state(LOOP_CFG, "cpu"),
                              LOOP_CFG, runner=step_graph.StaticRunner())
    names = []
    read = sg.rt.read_fn
    sg.rt.read_fn = lambda x, what: (names.append(what), read(x, what))[1]
    reads = []
    for k, s in enumerate(_scans(N_SLAM)):
        n0 = len(names)
        sg.step(*s, k * 0.1, run_mapping=(k % LOOP_CFG.mapping_every == 0),
                run_loop=(k == LOOP_AT), bootstrap=(k == 1))
        reads.append(names[n0:])
    return reads


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's results of the mesh-graph case at W = 2, with the JAX
    reference and the single device's reads computed meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        run = ex.submit(_torch_dist.spawn, [(
            "mesh_graph", (_scans(N_SLAM), LOOP_CFG, LOOP_AT, TCFG))], 2,
            tmp_path_factory.mktemp("mesh_graph"))
        ref = jax_slam2()
        single = single_loop_reads()
        return run.result()["mesh_graph"], ref, single


def test_mesh_step_through_static_runner_matches_eager(ranks):
    (e_fused, e_reads, s_fused, s_reads, same, loops, captured, capturable,
     *_), _, _ = ranks
    np.testing.assert_array_equal(s_fused, e_fused)
    assert same
    assert s_reads == e_reads
    assert int(loops) == 1
    # gloo's collectives are not captured: the step runs eagerly.
    assert not captured and not capturable


def test_mesh_step_reads(ranks):
    (_, _, _, s_reads, *_), _, single = ranks
    for k, names in enumerate(s_reads):
        if k == LOOP_AT:
            continue
        assert len(names) <= (1 if k % TCFG.mapping_every == 0 else 0), \
            (k, names)
    loop = s_reads[LOOP_AT]
    assert set(loop) == {"ICP stop", "loop accepted", "CG stop"}
    assert loop.count("loop accepted") == 1
    assert loop.count("CG stop") >= LOOP_CFG.posegraph.gn_iters
    # The single device's count: its submap branch and the same attempt.
    assert len(single[LOOP_AT]) == len(loop) + 1
    assert single[LOOP_AT][0] == "submap branch"


def test_mesh_slam_through_static_runner_matches_jax_mesh(ranks):
    (*_, fused, count, kf_t), (jfused, jcount, jkf_t), _ = ranks
    assert int(count) == jcount
    np.testing.assert_allclose(fused, jfused, atol=1e-3)
    np.testing.assert_allclose(kf_t[:jcount], jkf_t[:jcount], atol=1e-3)


@pytest.mark.parametrize("imu", [False, True], ids=["plain", "imu"])
def test_block_through_static_runner_matches_streaming_steps(imu):
    cfg = TCFG
    B = cfg.mapping_every
    scans = _scans(N_SLAM)
    integ = _integral() if imu else None
    times = torch.tensor([k * 0.1 for k in range(N_SLAM)])
    st = tpipe.init_slam_state(cfg, "cpu")
    stream = []
    for k, s in enumerate(scans):
        st, out = tpipe.slam_scan_step(
            st, *s, cfg, times[k], run_mapping=(k % B == 0),
            imu_integral=integ, bootstrap=(k == 1))
        stream.append(map_tree(lambda t: t.clone(), out))
    rt = step_graph.StaticRunner()
    sg = step_graph.StepGraph(tpipe.init_slam_state(cfg, "cpu"), cfg,
                              runner=rt)
    for b in range(N_SLAM // B):
        blk = tuple(torch.stack([scans[b * B + i][j] for i in range(B)])
                    for j in range(3))
        integs = None if integ is None else type(integ)(
            *(a.expand(B, *a.shape) for a in integ))
        r0, p0, c0 = rt.reads, rt.replays, len(rt.chains)
        outs = sg.block(*blk, times[b * B:(b + 1) * B],
                        imu_integrals=integs, bootstrap=(b == 0))
        assert rt.reads - r0 == 1
        # Two graphs a block, each replayed or captured: scan 0's front,
        # the read, then the rest of the block.
        assert (rt.replays - p0) + (len(rt.chains) - c0) == 2
        for i in range(B):
            want = stream[b * B + i]
            got = map_tree(lambda t: t[i], outs)
            assert all(torch.equal(a, c) for a, c in zip(leaves(got),
                                                          leaves(want)))
    assert all(torch.equal(a, c) for a, c in zip(leaves(sg.state),
                                                  leaves(st)))
