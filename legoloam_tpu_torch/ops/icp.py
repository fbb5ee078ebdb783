"""Point-to-point ICP (port of ``legoloam_tpu/ops/icp.py``; the PCL
``IterativeClosestPoint`` replacement of the reference's loop closure,
``src/mapOptmization.cpp:875-945``: correspondence distance 100 m, 100
iterations, eps 1e-6, acceptance by mean squared NN distance).

Each iteration's correspondences are one 1-NN search — kernel K3
(``knn_cuda.knn``, ungated, exact) on the card, its plain version on the
CPU — and the rigid update is the Kabsch solution from the SVD of the 3x3
cross-covariance.  On the card ``torch.linalg.svd`` goes through cuSOLVER
and synchronises; a closed form built from eager 3x3 operations took ~5x
longer a call there (``PERF.md``, Findings), so the SVD stays.
The JAX ``while_loop`` becomes a Python loop that reads the eps test back
each iteration, so it stops at the same iteration and launches K3 only as
often as the JAX loop runs its search.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import se3, smallalg
from .knn_cuda import knn
from .se3 import Pose


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


def kabsch_rotation(H: torch.Tensor) -> torch.Tensor:
    """The rotation R maximising tr(R H) for the cross-covariance
    H = Σ x yᵀ (so R x ≈ y): V diag(1, 1, sign det(V Uᵀ)) Uᵀ for
    H = U Σ Vᵀ."""
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(smallalg.det3(Vt.T @ U.T))
    return Vt.T @ (torch.stack([torch.ones_like(d), torch.ones_like(d),
                                d])[:, None] * U.T)


def _corr_stats(T: Pose, src, src_valid, dst, dst_valid, max_corr_sq: float):
    moved = se3.transform_points(T, src)
    d, i = knn(moved, src_valid, dst, dst_valid, k=1)
    match = src_valid & (d[:, 0] < max_corr_sq)
    return moved, dst[i[:, 0]], match, d[:, 0]


def icp(src, src_valid, dst, dst_valid, init: Pose,
        max_corr_dist: float = 100.0, max_iters: int = 100,
        eps: float = 1e-6) -> IcpResult:
    """Align ``src`` onto ``dst`` starting from ``init``."""
    max_corr_sq = max_corr_dist * max_corr_dist
    T = init
    prev_err = torch.tensor(math.inf, device=src.device)
    done = False
    it = 0
    while it < max_iters and not done:
        moved, target, match, d = _corr_stats(T, src, src_valid, dst,
                                              dst_valid, max_corr_sq)
        w = match.to(torch.float32)
        wsum = torch.clamp(torch.sum(w), min=1.0)
        mu_s = torch.sum(moved * w[:, None], dim=0) / wsum
        mu_t = torch.sum(target * w[:, None], dim=0) / wsum
        X = (moved - mu_s) * w[:, None]
        Y = target - mu_t
        R_delta = kabsch_rotation(X.T @ Y)
        t_delta = mu_t - se3.rotate_vec(R_delta, mu_s)
        T = Pose(R_delta @ T.R, se3.rotate_vec(R_delta, T.t) + t_delta)
        err = torch.sum(d * w) / wsum
        done = bool(torch.abs(prev_err - err) < eps)
        prev_err = err
        it += 1

    _, _, match, d = _corr_stats(T, src, src_valid, dst, dst_valid,
                                 max_corr_sq)
    n_corr = torch.sum(match)
    fitness = torch.sum(torch.where(match, d, torch.zeros_like(d))) \
        / torch.clamp(n_corr, min=1)
    has_converged = n_corr > 10
    return IcpResult(pose=T, fitness=fitness, has_converged=has_converged,
                     converged=has_converged & done, n_corr=n_corr)
