"""Rank workers for the PyTorch port's multi-rank tests
(tests/test_torch_parallel.py).

Imports only torch and the port: the ranks are spawned processes, and a
spawned child imports this module, never the JAX package.  ``spawn`` starts
``n`` gloo ranks on the CPU with every host decision checked across the
ranks (``Mesh.strict``), runs the named cases on each and returns rank 0's
results, which it writes to a file.  Inputs are the port's NamedTuples of
CPU tensors; results are numpy.
"""

import os
import pickle

import torch

from legoloam_tpu_torch.parallel import (frontend_dp, mapping_dist,
                                         pipeline_dist, posegraph_dist)
from legoloam_tpu_torch.parallel.mesh import launch

# A rank that waits longer than this in a collective fails the test.
TIMEOUT_S = 120.0


def _np(tree):
    """Tensors of a (nested) tuple/dict as numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_np(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def _replicated(mesh, tree, what):
    """Every tensor of ``tree`` bitwise equal on every rank."""
    if isinstance(tree, torch.Tensor):
        mesh.assert_replicated(tree, what)
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            _replicated(mesh, v, f"{what}[{i}]")


def case_posegraph(mesh, inp):
    out = posegraph_dist.optimize_sharded(*inp, mesh)
    _replicated(mesh, out, "optimize_sharded output")
    return out


def case_scan_to_map(mesh, inp):
    T, iters, n_c, n_s = mapping_dist.scan_to_map_sharded(*inp, mesh)
    _replicated(mesh, (T, torch.tensor(iters), n_c, n_s), "scan_to_map")
    return T, iters, n_c, n_s


def case_submap_sharded(mesh, inp):
    kf, center, cfg = inp
    out = mapping_dist.extract_submap_sharded(
        mapping_dist.shard_keyframes(kf, mesh), center, cfg, mesh)
    _replicated(mesh, out, "extract_submap_sharded output")
    return out


def case_submap_dist(mesh, inp):
    kf, center, cfg = inp
    dkf = pipeline_dist.from_keyframe_store(kf, mesh)
    out = pipeline_dist.extract_submap_dist(dkf, center, cfg, mesh)
    _replicated(mesh, out, "extract_submap_dist output")
    return out


def case_roundtrip(mesh, inp):
    """The store back from its shards (on rank 0, and on every rank), and a
    window of clouds gathered by the masked all-reduce."""
    kf, idxs = inp
    dkf = pipeline_dist.from_keyframe_store(kf, mesh)
    back0 = pipeline_dist.to_keyframe_store(dkf, mesh)
    everywhere = pipeline_dist.to_keyframe_store(dkf, mesh, everywhere=True)
    for name in kf._fields:
        assert torch.equal(getattr(everywhere, name), getattr(kf, name)), name
    assert (back0 is None) == (mesh.rank != 0)
    win = pipeline_dist.gather_keyframe_clouds(dkf, idxs, mesh)
    _replicated(mesh, win, "window clouds")
    return back0, win, dkf.corner.shape[0]


def case_loop(mesh, inp):
    kf, loops, loop_cfg, pg_cfg = inp
    dkf = pipeline_dist.from_keyframe_store(kf, mesh)
    kf2, loops2, corrected, diag = pipeline_dist.close_and_correct_dist(
        dkf, loops, loop_cfg, pg_cfg, mesh)
    _replicated(mesh, (kf2.R, kf2.t, corrected, diag), "loop closure")
    return kf2.R, kf2.t, corrected, diag, loops2.count


def _slam(mesh, scans, cfg, integs=None, bootstrap=True):
    st = pipeline_dist.init_dist_state(cfg, mesh)
    fused = []
    for k, s in enumerate(scans):
        st, out = pipeline_dist.slam_scan_step_dist(
            st, *s, cfg, mesh, k * cfg.sensor.scan_period,
            run_mapping=(k % cfg.mapping_every == 0),
            imu_integral=None if integs is None else integs[k],
            bootstrap=bootstrap and k == 1)
        _replicated(mesh, out.fused_pose, f"fused pose {k}")
        fused.append(out.fused_pose.t)
    kf = pipeline_dist.to_keyframe_store(st.mapping.kf, mesh)
    return torch.stack(fused), st.mapping.kf.count, st.mapping.kf.t, kf


def case_slam(mesh, inp):
    scans, cfg = inp
    return _slam(mesh, scans, cfg, bootstrap=False)


def case_slam_imu(mesh, inp):
    """The public driver ``run_slam_sequence_dist`` with per-scan IMU
    integrals (and its scan-1 bootstrap)."""
    scans, integs, cfg = inp
    traj, st = pipeline_dist.run_slam_sequence_dist(scans, cfg, mesh,
                                                    imu_integrals=integs)
    _replicated(mesh, traj, "fused trajectory")
    kf = pipeline_dist.to_keyframe_store(st.mapping.kf, mesh)
    return traj.t, st.mapping.kf.count, st.mapping.kf.t, kf


def case_frontend(mesh, inp):
    batch, cfg = inp
    feats, idx = frontend_dp.make_batched_frontend(cfg, mesh)(*batch)
    return (mesh.all_gather(feats.sharp.xyz).flatten(0, 1),
            mesh.all_gather(feats.less_flat.valid).flatten(0, 1),
            mesh.all_gather(idx).flatten())


def case_block(mesh, inp):
    """slam_scan_block_dist against the streaming driver, both over the
    ranks: fused positions (K, 3) of each and their keyframe counts."""
    scans, cfg = inp
    B = cfg.mapping_every
    st = pipeline_dist.init_dist_state(cfg, mesh)
    stream = []
    for k, s in enumerate(scans):
        st, out = pipeline_dist.slam_scan_step_dist(
            st, *s, cfg, mesh, k * 0.1, run_mapping=(k % B == 0),
            bootstrap=(k == 1))
        stream.append(out.fused_pose.t)
    st2 = pipeline_dist.init_dist_state(cfg, mesh)
    block = []
    for b in range(len(scans) // B):
        blk = tuple(torch.stack([scans[b * B + i][j] for i in range(B)])
                    for j in range(3))
        times = torch.arange(b * B, (b + 1) * B, dtype=torch.float32) * 0.1
        st2, outs = pipeline_dist.slam_scan_block_dist(
            st2, *blk, cfg, mesh, times, bootstrap=(b == 0))
        block.append(outs.fused_pose.t)
    return (torch.stack(stream), torch.cat(block), st.mapping.kf.count,
            st2.mapping.kf.count)


def world_report(mesh, path):
    """Rank 0 writes every rank's number and the world size."""
    ranks = mesh.all_gather(torch.tensor([mesh.rank])).flatten().tolist()
    if mesh.rank == 0:
        with open(path, "w") as f:
            f.write(" ".join(map(str, ranks)) + f" of {mesh.size}")


def diverge(mesh):
    """A host decision that differs between ranks (fails under strict)."""
    mesh.read(torch.tensor(mesh.rank), "rank")


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def run_cases(mesh, cases, out_path):
    """Rank body: every (name, inputs) of ``cases``; rank 0 pickles the
    results to ``out_path``."""
    torch.set_num_threads(1)
    results = {name: _np(CASES[name](mesh, inp)) for name, inp in cases}
    if mesh.rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)


def spawn(cases, n, tmp_dir):
    """Run ``cases`` (a list of (name, inputs)) on ``n`` gloo ranks; rank
    0's results by name."""
    out = os.path.join(str(tmp_dir), f"rank0_of_{n}.pkl")
    launch(run_cases, n, args=(list(cases), out), device="cpu",
           timeout_s=TIMEOUT_S, strict=True)
    with open(out, "rb") as f:
        return pickle.load(f)

