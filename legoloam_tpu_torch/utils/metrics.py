"""Trajectory evaluation (port of ``legoloam_tpu/utils/metrics.py``)."""

from __future__ import annotations

import torch


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
