"""Point-to-point ICP (port of ``legoloam_tpu/ops/icp.py``; the PCL
``IterativeClosestPoint`` replacement of the reference's loop closure,
``src/mapOptmization.cpp:875-945``: correspondence distance 100 m, 100
iterations, eps 1e-6, acceptance by mean squared NN distance).

Each iteration's correspondences are one 1-NN search — kernel K3
(``knn_cuda.knn``, ungated, exact) on the card, its plain version on the
CPU — and the rigid update is the Kabsch rotation, here by Horn's
quaternion method on a fixed-sweep Jacobi eigensolver
(``smallalg.kabsch_horn``): ``torch.linalg.svd`` reads its error flag back
to the host, which a CUDA graph cannot hold.

The JAX ``while_loop`` becomes chunks of ``chunk`` iterations, each
iteration frozen (its old values selected by ``where``) once the eps test
fired or the cap was reached, so the result equals the per-iteration loop;
one host read of the stop flag after each chunk (``ops/segments.py``).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import torch

from . import se3, smallalg
from .knn_cuda import knn
from .se3 import Pose
from .segments import EAGER

# Iterations a chunk runs between two host reads of the stop flag.
CHUNK = 8


class IcpResult(NamedTuple):
    pose: Pose                   # transform mapping src into dst's frame
    fitness: torch.Tensor        # mean squared NN distance (getFitnessScore)
    # PCL's ``hasConverged()``: true on any termination, the eps test or
    # the iteration cap, while correspondences exist.  The reference's
    # acceptance (mapOptmization.cpp:904) gates on this and the fitness.
    has_converged: torch.Tensor
    # The eps test fired before the iteration cap.
    converged: torch.Tensor
    n_corr: torch.Tensor
    iters: torch.Tensor          # () int32 iterations run (port-only)


def kabsch_rotation(H: torch.Tensor) -> torch.Tensor:
    """The rotation R maximising tr(R H) for the cross-covariance
    H = Σ x yᵀ (so R x ≈ y); the identity for H = 0."""
    return smallalg.kabsch_horn(H)


def _corr_stats(T: Pose, src, src_valid, dst, dst_valid, max_corr_sq: float):
    moved = se3.transform_points(T, src)
    d, i = knn(moved, src_valid, dst, dst_valid, k=1)
    match = src_valid & (d[:, 0] < max_corr_sq)
    return moved, dst[i[:, 0]], match, d[:, 0]


class IcpState(NamedTuple):
    R: torch.Tensor          # (3, 3) current transform
    t: torch.Tensor          # (3,)
    prev_err: torch.Tensor   # () the last iteration's mean squared error
    done: torch.Tensor       # () bool: the eps test fired
    it: torch.Tensor         # () int32 iterations run
    stop: torch.Tensor       # () bool: done or at the cap


def icp_start(init: Pose, frozen=None, max_iters: int = 1) -> IcpState:
    """The state before the first iteration; ``frozen`` (a () bool) stops
    it before it starts (no candidate to align), as does ``max_iters``
    below 1."""
    dev = init.t.device
    stop = torch.full((), max_iters < 1, dtype=torch.bool, device=dev)
    if frozen is not None:
        stop = stop | frozen
    return IcpState(R=init.R.clone(), t=init.t.clone(),
                    prev_err=torch.full((), math.inf, device=dev),
                    done=torch.zeros((), dtype=torch.bool, device=dev),
                    it=torch.zeros((), dtype=torch.int32, device=dev),
                    stop=stop)


def icp_iterate(st: IcpState, src, src_valid, dst, dst_valid, n: int,
                max_iters: int, eps: float, max_corr_sq: float) -> IcpState:
    """``n`` iterations, each a no-op once ``stop`` is set."""
    for _ in range(n):
        active = ~st.stop
        T = Pose(st.R, st.t)
        # A stopped iteration searches with no live query (K3 skips it).
        moved, target, match, d = _corr_stats(T, src, src_valid & active,
                                              dst, dst_valid, max_corr_sq)
        w = match.to(torch.float32)
        wsum = torch.clamp(torch.sum(w), min=1.0)
        mu_s = torch.sum(moved * w[:, None], dim=0) / wsum
        mu_t = torch.sum(target * w[:, None], dim=0) / wsum
        X = (moved - mu_s) * w[:, None]
        Y = target - mu_t
        R_delta = kabsch_rotation(X.T @ Y)
        t_delta = mu_t - se3.rotate_vec(R_delta, mu_s)
        err = torch.sum(d * w) / wsum
        done = torch.abs(st.prev_err - err) < eps
        it = st.it + active.to(torch.int32)
        st = IcpState(
            R=torch.where(active, R_delta @ T.R, st.R),
            t=torch.where(active, se3.rotate_vec(R_delta, T.t) + t_delta,
                          st.t),
            prev_err=torch.where(active, err, st.prev_err),
            done=torch.where(active, done, st.done), it=it,
            stop=st.stop | (active & (done | (it >= max_iters))))
    return st


def icp_result(st: IcpState, src, src_valid, dst, dst_valid,
               max_corr_sq: float) -> "IcpResult":
    T = Pose(st.R, st.t)
    _, _, match, d = _corr_stats(T, src, src_valid, dst, dst_valid,
                                 max_corr_sq)
    n_corr = torch.sum(match)
    fitness = torch.sum(torch.where(match, d, torch.zeros_like(d))) \
        / torch.clamp(n_corr, min=1)
    has_converged = n_corr > 10
    return IcpResult(pose=T, fitness=fitness, has_converged=has_converged,
                     converged=has_converged & st.done, n_corr=n_corr,
                     iters=st.it)


def icp(src, src_valid, dst, dst_valid, init: Pose,
        max_corr_dist: float = 100.0, max_iters: int = 100,
        eps: float = 1e-6, frozen=None, chunk: int | None = None, rt=EAGER,
        key="icp") -> IcpResult:
    """Align ``src`` onto ``dst`` starting from ``init``: chunks of
    ``chunk`` (default ``CHUNK``) iterations until the eps test fires or
    ``max_iters`` ran.
    ``frozen`` (a () bool) runs no iteration when set.  ``rt``/``key``:
    the segment runner and this solve's name in it."""
    max_corr_sq = max_corr_dist * max_corr_dist
    chunk = chunk or CHUNK
    st = rt.seg((key, "start", max_iters), partial(icp_start,
                                                  max_iters=max_iters),
                init, frozen)
    step = partial(icp_iterate, n=chunk, max_iters=max_iters, eps=eps,
                   max_corr_sq=max_corr_sq)
    while True:
        st = rt.seg((key, "chunk", chunk, max_iters, eps, max_corr_sq), step,
                    st, src, src_valid, dst, dst_valid, into=st)
        if rt.read(st.stop, "ICP stop"):
            break
    return rt.seg((key, "result", max_corr_sq),
                  partial(icp_result, max_corr_sq=max_corr_sq), st, src,
                  src_valid, dst, dst_valid)
