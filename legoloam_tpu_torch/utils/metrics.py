"""Trajectory evaluation, ATE and RPE (port of
``legoloam_tpu/utils/metrics.py``)."""

from __future__ import annotations

import torch

from ..ops import se3
from ..ops.se3 import Pose


def umeyama_alignment(est: torch.Tensor, ref: torch.Tensor,
                      with_scale: bool = False):
    """Least-squares rigid alignment est -> ref over (N, 3) positions:
    (R, t, s) minimising ||s R est + t - ref||²."""
    mu_e, mu_r = est.mean(dim=0), ref.mean(dim=0)
    e, r = est - mu_e, ref - mu_r
    cov = r.T @ e / est.shape[0]
    U, D, Vt = torch.linalg.svd(cov)
    S = torch.eye(3, dtype=est.dtype, device=est.device)
    S[2, 2] = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    R = U @ S @ Vt
    if with_scale:
        s = torch.trace(torch.diag(D) @ S) / ((e * e).sum() / est.shape[0])
    else:
        s = torch.tensor(1.0, dtype=est.dtype, device=est.device)
    return R, mu_r - s * R @ mu_e, s


def ate_rmse(est_pos: torch.Tensor, ref_pos: torch.Tensor,
             align: bool = True) -> torch.Tensor:
    """Absolute trajectory error RMSE over (N, 3) positions."""
    if align:
        R, t, s = umeyama_alignment(est_pos, ref_pos)
        est_pos = (s * (R @ est_pos.T)).T + t
    err = est_pos - ref_pos
    return torch.sqrt(torch.mean(torch.sum(err * err, dim=-1)))


def rpe(est: Pose, ref: Pose, delta: int = 1):
    """Relative pose error over pose batches (leading dim = time):
    (translation RMSE, rotation RMSE in radians) of the ``delta``-step
    motions."""
    def rel(p: Pose) -> Pose:
        return se3.relative(Pose(p.R[:-delta], p.t[:-delta]),
                            Pose(p.R[delta:], p.t[delta:]))

    e = se3.relative(rel(ref), rel(est))
    t_err = torch.sqrt(torch.mean(torch.sum(e.t * e.t, dim=-1)))
    w = se3.so3_log(e.R)
    return t_err, torch.sqrt(torch.mean(torch.sum(w * w, dim=-1)))
