"""State interchange: a JAX-package SlamState taken after real steps goes to
the port and back to numpy exactly, field by field."""

import collections

import numpy as np
import pytest
import torch

from legoloam_tpu_torch.models.pipeline import SlamState
from legoloam_tpu_torch.utils.interop import (slam_state_from_numpy,
                                              slam_state_to_numpy)

from _torch_parity import jax_run


def _leaves(tree, path=""):
    fields = getattr(tree, "_fields", None)
    if fields is None:
        yield path, tree
        return
    for name, v in zip(fields, tree):
        yield from _leaves(v, f"{path}.{name}")


def test_slam_state_round_trip_exact():
    states, _ = jax_run(4)
    jstate = states[-1]
    # A state worth carrying: keyframes stored, the submap cache filled.
    assert int(jstate.mapping.kf.count) >= 2
    assert jstate.mapping.cache.s_valid.any()
    assert bool(jstate.odom.initialized)

    tstate = slam_state_from_numpy(jstate, "cpu")
    assert isinstance(tstate, SlamState)
    back = slam_state_to_numpy(tstate)
    ja, tb = list(_leaves(jstate)), list(_leaves(back))
    assert [p for p, _ in ja] == [p for p, _ in tb]
    for (path, a), (_, b) in zip(ja, tb):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    for path, leaf in _leaves(tstate):
        assert leaf.dtype in (torch.float32, torch.int32, torch.bool), path


def test_float64_leaves_are_cast():
    states, _ = jax_run(4)
    pose = states[-1].odom.pose
    p64 = type(pose)(pose.R.astype(np.float64), pose.t.astype(np.float64))
    t = slam_state_from_numpy(p64, "cpu")
    assert t.R.dtype == torch.float32 and t.t.dtype == torch.float32
    assert np.array_equal(t.t.numpy(), pose.t)


def test_unknown_state_type_raises():
    Other = collections.namedtuple("Other", ["a"])
    with pytest.raises(TypeError):
        slam_state_from_numpy(Other(np.zeros(3, np.float32)), "cpu")
