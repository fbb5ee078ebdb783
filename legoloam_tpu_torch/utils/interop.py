"""State interchange with the JAX package.

The port's state NamedTuples carry the same field names in the same order as
the JAX package's, so a state taken from a JAX run — given as nested
NamedTuples of numpy arrays (``jax.tree.map(np.asarray, state)``) — becomes
the port's state and back, and both packages can continue from one mid-run
state.  A distributed state (``DistSlamState``) becomes one rank's part of
the port's distributed state (``dist_state_from_numpy``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.mapping import KeyframeStore, MapState, SubmapCache
from ..models.odometry import OdometryState
from ..models.pipeline import SlamState
from ..models.posegraph import LoopFactors
from ..ops.deskew import ImuIntegral, ImuWindow
from ..ops.features import FeatureCloud, ScanFeatures
from ..ops.se3 import Pose
from ..parallel.pipeline_dist import (CLOUD_FIELDS, DistKeyframes,
                                      DistMapState, DistSlamState)

STATE_TYPES = {cls.__name__: cls for cls in (
    SlamState, OdometryState, MapState, KeyframeStore, SubmapCache, Pose,
    FeatureCloud, ScanFeatures, LoopFactors, ImuWindow, ImuIntegral)}


def _leaf_to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    if a.dtype not in (np.float32, np.int32, np.bool_):
        raise TypeError(f"unsupported state dtype {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def slam_state_from_numpy(tree, device):
    """JAX-package state (``SlamState``, ``OdometryState``, ``MapState``, a
    scan's ``ScanFeatures``, an ``ImuWindow`` or ``ImuIntegral``, or any of
    their parts) as NamedTuples of numpy arrays -> the port's state on
    ``device``."""
    fields = getattr(tree, "_fields", None)
    if fields is None:
        return _leaf_to_tensor(tree, device)
    cls = STATE_TYPES.get(type(tree).__name__)
    if cls is None or cls._fields != fields:
        raise TypeError(f"no port state type matches {type(tree).__name__}"
                        f"{fields}")
    return cls(*(slam_state_from_numpy(v, device) for v in tree))


def slam_state_to_numpy(state):
    """The port's state -> the same NamedTuples with numpy leaves."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    return type(state)(*(slam_state_to_numpy(v) for v in state))


DIST_TYPES = {cls.__name__: cls for cls in (DistMapState, DistSlamState)}


def dist_state_from_numpy(tree, mesh):
    """JAX-package distributed state (``DistSlamState``, ``DistMapState``,
    ``DistKeyframes`` or a part) as NamedTuples of numpy arrays -> this
    rank's part of the port's distributed state on ``mesh.device``.  The
    JAX package's cloud arrays, read back whole, hold the keyframes in
    its physical cyclic order (shard r's slots in rows ``r * M/n ..
    (r+1) * M/n - 1``, ``M`` a multiple of ``n``), which is the port's
    layout of rank r's slots."""
    name = type(tree).__name__
    if name == "DistKeyframes":
        m = tree.t.shape[0]
        if m % mesh.size:
            raise ValueError(f"a JAX store of {m} keyframes cannot be "
                             f"sharded over {mesh.size} ranks")
        m_loc = m // mesh.size
        rows = slice(mesh.rank * m_loc, (mesh.rank + 1) * m_loc)
        return DistKeyframes(*(
            _leaf_to_tensor(a[rows] if f in CLOUD_FIELDS else a, mesh.device)
            for f, a in zip(tree._fields, tree)))
    if name in DIST_TYPES:
        return DIST_TYPES[name](*(dist_state_from_numpy(v, mesh)
                                  for v in tree))
    return slam_state_from_numpy(tree, mesh.device)
