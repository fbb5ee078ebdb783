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

``icp_start``, ``icp_iterate`` and ``icp_result`` also take a batch of
solves against one target (``src`` (..., N, 3), a state per solve): the
relocalization's headings of one candidate.  Their queries go to K3 as one
search, which is exact per query, and each solve's sums and rotation are
taken over its own rows, so each solve is the one it would be alone.
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
    H = Σ x yᵀ (so R x ≈ y), (..., 3, 3); the identity for H = 0."""
    return smallalg.kabsch_horn(H)


def _corr_stats(T: Pose, src, src_valid, dst, dst_valid, max_corr_sq: float):
    """Each source point moved by its solve's ``T`` and its nearest valid
    target (one K3 search for the whole batch)."""
    moved = se3.transform_points(T, src)
    d, i = knn(moved.reshape(-1, 3), src_valid.reshape(-1), dst, dst_valid,
               k=1)
    d = d[:, 0].reshape(src_valid.shape)
    match = src_valid & (d < max_corr_sq)
    return moved, dst[i[:, 0]].reshape(moved.shape), match, d


class IcpState(NamedTuple):
    R: torch.Tensor          # (..., 3, 3) current transform
    t: torch.Tensor          # (..., 3)
    prev_err: torch.Tensor   # (...) the last iteration's mean squared error
    done: torch.Tensor       # (...) bool: the eps test fired
    it: torch.Tensor         # (...) int32 iterations run
    stop: torch.Tensor       # (...) bool: done or at the cap


def icp_start(init: Pose, frozen=None, max_iters: int = 1) -> IcpState:
    """The state before the first iteration, a solve per leading index of
    ``init``; ``frozen`` (bool, broadcast to them) stops a solve before it
    starts (no candidate to align), as does ``max_iters`` below 1."""
    dev = init.t.device
    batch = init.t.shape[:-1]
    stop = torch.full(batch, max_iters < 1, dtype=torch.bool, device=dev)
    if frozen is not None:
        stop = stop | frozen
    return IcpState(R=init.R.clone(), t=init.t.clone(),
                    prev_err=torch.full(batch, math.inf, device=dev),
                    done=torch.zeros(batch, dtype=torch.bool, device=dev),
                    it=torch.zeros(batch, dtype=torch.int32, device=dev),
                    stop=stop)


def icp_iterate(st: IcpState, src, src_valid, dst, dst_valid, n: int,
                max_iters: int, eps: float, max_corr_sq: float) -> IcpState:
    """``n`` iterations of each solve, each a no-op once its ``stop`` is
    set."""
    if src.dim() == 2:
        # One solve runs as a batch of one: the same small batched
        # products, so each solve of a batch equals its solve alone.
        st = icp_iterate(IcpState(*(a[None] for a in st)), src[None],
                         src_valid[None], dst, dst_valid, n, max_iters, eps,
                         max_corr_sq)
        return IcpState(*(a[0] for a in st))
    for _ in range(n):
        active = ~st.stop
        a1, a2 = active[..., None], active[..., None, None]
        T = Pose(st.R, st.t)
        # A stopped iteration searches with no live query (K3 skips it).
        moved, target, match, d = _corr_stats(T, src, src_valid & a1,
                                              dst, dst_valid, max_corr_sq)
        w = match.to(torch.float32)
        wsum = torch.clamp(torch.sum(w, dim=-1), min=1.0)
        mu_s = torch.sum(moved * w[..., None], dim=-2) / wsum[..., None]
        mu_t = torch.sum(target * w[..., None], dim=-2) / wsum[..., None]
        X = (moved - mu_s[..., None, :]) * w[..., None]
        Y = target - mu_t[..., None, :]
        R_delta = kabsch_rotation(X.transpose(-1, -2) @ Y)
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
    return st


def icp_result(st: IcpState, src, src_valid, dst, dst_valid,
               max_corr_sq: float) -> "IcpResult":
    if src.dim() == 2:
        res = icp_result(IcpState(*(a[None] for a in st)), src[None],
                         src_valid[None], dst, dst_valid, max_corr_sq)
        return IcpResult(Pose(res.pose.R[0], res.pose.t[0]),
                         *(a[0] for a in res[1:]))
    T = Pose(st.R, st.t)
    _, _, match, d = _corr_stats(T, src, src_valid, dst, dst_valid,
                                 max_corr_sq)
    n_corr = torch.sum(match, dim=-1)
    fitness = torch.sum(torch.where(match, d, torch.zeros_like(d)), dim=-1) \
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
