"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py):
config conversion, JAX <-> torch array conversion, and a mid-run JAX SLAM
state both packages can continue from."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import torch

import legoloam_tpu.config as jcfg_mod
import legoloam_tpu_torch.config as tcfg_mod
from legoloam_tpu.models import pipeline as jpipe
from legoloam_tpu.ops.se3 import Pose as JPose
from legoloam_tpu.utils import synthetic as jsyn

# One intra-op thread per test process: the suite runs several workers at
# once, and PyTorch's default of one thread per core in each of them
# oversubscribes the cores (the port's tests on six workers of an 8-core
# machine: 655 s with the default, 315 s with one thread each).
torch.set_num_threads(1)

# CPU-sized mapping capacities (as tests/test_slam_block.py's SMALL_MAP, with
# the default batched submap folds).
SMALL_MAP = dataclasses.replace(
    jcfg_mod.DEFAULT.mapping, max_keyframes=128, submap_corner_cap=8192,
    submap_surf_cap=16384, scan_corner_cap=1024, scan_surf_cap=4096)
JCFG = jcfg_mod.DEFAULT.replace(mapping=SMALL_MAP)


def port_cfg(obj):
    """The port's copy of a JAX-package config dataclass (field by field)."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(tcfg_mod, type(obj).__name__)
        return cls(**{f.name: port_cfg(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return obj


TCFG = port_cfg(JCFG)


def tt(x) -> torch.Tensor:
    """JAX/numpy array -> CPU torch tensor (float64 cast to float32)."""
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True))


def npy(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def to_numpy_tree(tree):
    """JAX pytree of NamedTuples -> the same NamedTuples of numpy arrays."""
    fields = getattr(tree, "_fields", None)
    if fields is None:
        return np.asarray(tree)
    return type(tree)(*(to_numpy_tree(v) for v in tree))


@functools.lru_cache(maxsize=None)
def ring_scans(n: int):
    """``n`` motion-distorted default_scene scans along a 20 m circle
    (0.15 m/scan), from the JAX package's ray caster, and the poses."""
    scene = jsyn.default_scene()
    poses = jsyn.circle_trajectory(n + 1, radius=20.0, angular_rate=0.0075)
    scans = [tuple(np.asarray(a) for a in jsyn.raycast_scan(
        scene, JPose(poses.R[k], poses.t[k]), JCFG.sensor,
        next_pose=JPose(poses.R[k + 1], poses.t[k + 1]), motion=True))
        for k in range(n)]
    return scans, np.asarray(poses.t)


@functools.lru_cache(maxsize=None)
def jax_run(n: int):
    """Run the JAX pipeline over the first ``n`` ring scans; returns the
    numpy state tree after each scan and the fused positions."""
    scans, _ = ring_scans(n)
    state = jpipe.init_slam_state(JCFG)
    states, fused = [], []
    for k, (pts, valid, ring) in enumerate(scans):
        state, out = jpipe.slam_scan_step(
            state, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(ring),
            JCFG, k * JCFG.sensor.scan_period,
            run_mapping=(k % JCFG.mapping_every == 0), bootstrap=(k == 1))
        states.append(to_numpy_tree(state))
        fused.append(np.asarray(out.fused_pose.t))
    return states, np.stack(fused)


def to_jax_tree(tree):
    """numpy NamedTuple tree -> fresh JAX arrays (safe to donate)."""
    fields = getattr(tree, "_fields", None)
    if fields is None:
        return jnp.array(tree)
    return type(tree)(*(to_jax_tree(v) for v in tree))


def rot_angle_deg(Ra, Rb) -> float:
    """Angle of Raᵀ Rb in degrees, from atan2(sin, cos) — arccos of the
    trace alone would turn float32 rounding of the matrices into ~0.03°."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    A = M - M.T
    s = 0.5 * np.linalg.norm([A[2, 1], A[0, 2], A[1, 0]])
    return float(np.degrees(np.arctan2(s, (np.trace(M) - 1.0) / 2.0)))
