"""Checkpoints interchange with the JAX package (``legoloam_tpu/utils/
checkpoint.py``): the same keys, either package loads what the other saved,
and a resumed CPU run continues bitwise.

Tolerance: none.  Keys equal JAX's ``tree_flatten_with_path`` keys; arrays
round-trip exactly; a 6-scan run saved, loaded and continued 3 scans equals
the uninterrupted 9-scan run bit for bit; a shape mismatch raises the JAX
module's ``ValueError`` message.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from legoloam_tpu.models import pipeline as jpipe
from legoloam_tpu.utils import checkpoint as jck
from legoloam_tpu_torch.models import pipeline as tpipe
from legoloam_tpu_torch.utils import checkpoint as tck
from legoloam_tpu_torch.utils.interop import slam_state_to_numpy

from _torch_parity import JCFG, TCFG, jax_run, ring_scans, to_jax_tree

N = 6


def _jax_keys(tree):
    return ["/".join(str(p) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _flat_np(state):
    return {k: t.numpy() for k, t in tck.flatten_with_keys(state)}


def test_keys_equal_jax():
    jstate = jpipe.init_slam_state(JCFG)
    tstate = tpipe.init_slam_state(TCFG, device="cpu")
    keys = [k for k, _ in tck.flatten_with_keys(tstate)]
    assert keys == _jax_keys(jstate)
    assert ".odom/.pose/.R" in keys and ".mapping/.kf/.t" in keys
    assert len(keys) == 57


def test_jax_saved_loads_in_port_and_back(tmp_path):
    states, _ = jax_run(N)
    jstate = to_jax_tree(states[-1])
    a = tmp_path / "jax.npz"
    jck.save_state(str(a), jstate)
    port = tck.load_state(str(a), tpipe.init_slam_state(TCFG, device="cpu"))
    want = np.load(a)
    got = _flat_np(port)
    assert set(got) == set(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    assert int(port.mapping.kf.count) > 0
    # The port's save loads in the JAX package, array for array.
    b = tmp_path / "port.npz"
    tck.save_state(str(b), port)
    back = jck.load_state(str(b), jpipe.init_slam_state(JCFG))
    for (pk, x), (jk, y) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(jstate)[0]):
        assert np.array_equal(np.asarray(x), np.asarray(y)), pk


def test_errors(tmp_path):
    st = tpipe.init_slam_state(TCFG, device="cpu")
    p = tmp_path / "ck.npz"
    tck.save_state(str(p), st)
    small = TCFG.replace(mapping=dataclasses.replace(TCFG.mapping,
                                                     max_keyframes=7))
    with pytest.raises(ValueError) as port_err:
        tck.load_state(str(p), tpipe.init_slam_state(small, device="cpu"))
    jsmall = JCFG.replace(mapping=dataclasses.replace(JCFG.mapping,
                                                      max_keyframes=7))
    jp = tmp_path / "jck.npz"
    jck.save_state(str(jp), jpipe.init_slam_state(JCFG))
    with pytest.raises(ValueError) as jax_err:
        jck.load_state(str(jp), jpipe.init_slam_state(jsmall))
    assert str(port_err.value) == str(jax_err.value)
    data = dict(np.load(p))
    del data[".loops/.count"]
    q = tmp_path / "missing.npz"
    np.savez(q, **data)
    with pytest.raises(KeyError, match="loops/.count"):
        tck.load_state(str(q), st)
    # An interrupted save leaves no file behind and the old one intact.
    with pytest.raises(TypeError):
        tck.save_state(str(p), (st, "not a tensor"))
    assert sorted(x.name for x in tmp_path.iterdir()) == [
        "ck.npz", "jck.npz", "missing.npz"]


def _step(st, scan, k):
    return tpipe.slam_scan_step(
        st, *(torch.from_numpy(np.array(a)) for a in scan), TCFG,
        k * TCFG.sensor.scan_period, run_mapping=(k % TCFG.mapping_every == 0),
        bootstrap=(k == 1))


def test_resume_continues_bitwise(tmp_path):
    scans, _ = ring_scans(9)
    st = tpipe.init_slam_state(TCFG, device="cpu")
    direct = []
    for k, s in enumerate(scans):
        st, out = _step(st, s, k)
        direct.append(out.fused_pose.t)
        if k == N - 1:
            p = tmp_path / "mid.npz"
            tck.save_state(str(p), st)
    final = st
    st = tck.load_state(str(p), tpipe.init_slam_state(TCFG, device="cpu"))
    resumed = []
    for k in range(N, 9):
        st, out = _step(st, scans[k], k)
        resumed.append(out.fused_pose.t)
    assert torch.equal(torch.stack(resumed), torch.stack(direct[N:]))
    for a, b in zip(_flat_np(st).values(), _flat_np(final).values()):
        assert np.array_equal(a, b)
    assert slam_state_to_numpy(st).mapping.kf.count == 3
