"""Point-to-point ICP (frozen plain copy of ``ops/icp.py``: PCL's
``IterativeClosestPoint`` as LeGO-LOAM's loop closure runs it,
``src/mapOptmization.cpp:875-945``: correspondence distance 100 m, 100
iterations, eps 1e-6, acceptance by the mean squared NN distance).

Each iteration's correspondences are the exact 1-NN search
(``knn.knn_exact``, whose result K3 returns bit for bit), the rigid update
the Kabsch rotation by Horn's quaternion method (``smallalg.kabsch_horn``),
one iteration at a time until the eps test fires or the cap is reached:
the loop the port runs in chunks of frozen iterations.

Departures from the source, as the port's: the rotation comes from a
fixed-sweep Jacobi eigensolver, not an SVD; a correspondence is the
nearest valid point of the whole target (no k-d tree, no reciprocal
check); ``hasConverged`` is true on any termination while more than 10
correspondences exist.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import se3, smallalg
from .knn import knn_exact
from .se3 import Pose


class IcpResult(NamedTuple):
    pose: Pose                   # transform mapping src into dst's frame
    fitness: torch.Tensor        # mean squared NN distance (getFitnessScore)
    has_converged: torch.Tensor  # any termination with correspondences
    converged: torch.Tensor      # the eps test fired before the cap
    n_corr: torch.Tensor
    iters: torch.Tensor          # () int32 iterations run


class IcpState(NamedTuple):
    R: torch.Tensor          # (..., 3, 3) current transform
    t: torch.Tensor          # (..., 3)
    prev_err: torch.Tensor   # (...) the last iteration's mean squared error
    done: torch.Tensor       # (...) bool: the eps test fired
    it: torch.Tensor         # (...) int32 iterations run
    stop: torch.Tensor       # (...) bool: done or at the cap


def _corr_stats(T: Pose, src, src_valid, dst, dst_valid, max_corr_sq: float):
    """Each source point moved by ``T`` and its nearest valid target."""
    moved = se3.transform_points(T, src)
    d, i = knn_exact(moved.reshape(-1, 3), src_valid.reshape(-1), dst,
                     dst_valid, k=1)
    d = d[:, 0].reshape(src_valid.shape)
    match = src_valid & (d < max_corr_sq)
    return moved, dst[i[:, 0]].reshape(moved.shape), match, d


def icp_start(init: Pose, frozen, max_iters: int) -> IcpState:
    """The state before the first iteration; ``frozen`` (a () bool) stops
    the solve before it starts (no candidate to align)."""
    dev = init.t.device
    stop = torch.full((), max_iters < 1, dtype=torch.bool, device=dev)
    if frozen is not None:
        stop = stop | frozen
    return IcpState(R=init.R.clone(), t=init.t.clone(),
                    prev_err=torch.full((), math.inf, device=dev),
                    done=torch.zeros((), dtype=torch.bool, device=dev),
                    it=torch.zeros((), dtype=torch.int32, device=dev),
                    stop=stop)


def icp_iterate(st: IcpState, src, src_valid, dst, dst_valid,
                max_iters: int, eps: float, max_corr_sq: float) -> IcpState:
    """One iteration (a no-op once ``stop`` is set), on the solve as a
    batch of one, so its small products are the port's."""
    st = IcpState(*(a[None] for a in st))
    src, src_valid = src[None], src_valid[None]
    active = ~st.stop
    a1, a2 = active[..., None], active[..., None, None]
    T = Pose(st.R, st.t)
    moved, target, match, d = _corr_stats(T, src, src_valid & a1, dst,
                                          dst_valid, max_corr_sq)
    w = match.to(torch.float32)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    mu_s = torch.sum(moved * w[..., None], dim=-2) / wsum[..., None]
    mu_t = torch.sum(target * w[..., None], dim=-2) / wsum[..., None]
    X = (moved - mu_s[..., None, :]) * w[..., None]
    Y = target - mu_t[..., None, :]
    R_delta = smallalg.kabsch_horn(X.transpose(-1, -2) @ Y)
    t_delta = mu_t - se3.rotate_vec(R_delta, mu_s)
    err = torch.sum(d * w, dim=-1) / wsum
    done = torch.abs(st.prev_err - err) < eps
    it = st.it + active.to(torch.int32)
    st = IcpState(
        R=torch.where(a2, R_delta @ T.R, st.R),
        t=torch.where(a1, se3.rotate_vec(R_delta, T.t) + t_delta, st.t),
        prev_err=torch.where(active, err, st.prev_err),
        done=torch.where(active, done, st.done), it=it,
        stop=st.stop | (active & (done | (it >= max_iters))))
    return IcpState(*(a[0] for a in st))


def icp_result(st: IcpState, src, src_valid, dst, dst_valid,
               max_corr_sq: float) -> IcpResult:
    T = Pose(st.R[None], st.t[None])
    _, _, match, d = _corr_stats(T, src[None], src_valid[None], dst,
                                 dst_valid, max_corr_sq)
    n_corr = torch.sum(match, dim=-1)
    fitness = torch.sum(torch.where(match, d, torch.zeros_like(d)), dim=-1) \
        / torch.clamp(n_corr, min=1)
    has_converged = n_corr > 10
    return IcpResult(pose=Pose(st.R, st.t), fitness=fitness[0],
                     has_converged=has_converged[0],
                     converged=(has_converged & st.done)[0],
                     n_corr=n_corr[0], iters=st.it)


def icp(src, src_valid, dst, dst_valid, init: Pose,
        max_corr_dist: float = 100.0, max_iters: int = 100,
        eps: float = 1e-6, frozen=None) -> IcpResult:
    """Align ``src`` onto ``dst`` from ``init``: iterations until the eps
    test fires or ``max_iters`` ran (none when ``frozen`` is set)."""
    max_corr_sq = max_corr_dist * max_corr_dist
    st = icp_start(init, frozen, max_iters)
    while not bool(st.stop):
        st = icp_iterate(st, src, src_valid, dst, dst_valid, max_iters, eps,
                         max_corr_sq)
    return icp_result(st, src, src_valid, dst, dst_valid, max_corr_sq)
