"""Batched Gauss-Newton/LM building blocks shared by odometry and mapping
(port of ``legoloam_tpu/ops/lm.py``).

Residual rows are dense masked arrays (invalid rows zeroed), the normal
equations one (N, D)ᵀ(N, D) float32 product, and the solve + degeneracy
analysis run on tiny DxD systems.  Degeneracy handling mirrors the
reference: on the refresh iteration eigen-decompose JᵀJ, zero the
eigendirections below the threshold and project every step through
P = VᵀV₂ (featureAssociation.cpp:1329-1356, mapOptmization.cpp:1280-1306).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import smallalg


class DegeneracyState(NamedTuple):
    P: torch.Tensor             # (D, D) step projection matrix
    is_degenerate: torch.Tensor  # () bool


def identity_degeneracy(d: int, device=None) -> DegeneracyState:
    return DegeneracyState(P=torch.eye(d, device=device),
                           is_degenerate=torch.zeros((), dtype=torch.bool,
                                                     device=device))


def analyze_degeneracy(AtA: torch.Tensor, eig_thresh: float
                       ) -> DegeneracyState:
    """Eigen-decompose the normal matrix (closed form for 3x3, Jacobi for
    6x6) and build the projection that zeroes under-constrained
    directions."""
    if AtA.shape[-1] == 3:
        evals, evecs = smallalg.eigh3x3(AtA)
    else:
        # Fixed-sweep Jacobi (unordered, which the projection below does
        # not need): the library eigh reads its error flag back to the
        # host, which a CUDA graph cannot hold.
        evals, evecs = smallalg.jacobi_eigen(AtA, sweeps=5)
    keep = evals >= eig_thresh
    V = evecs.T
    V2 = torch.where(keep[:, None], V, torch.zeros_like(V))
    return DegeneracyState(P=V.T @ V2, is_degenerate=torch.any(~keep))


def assemble_normal_equations(
    J: torch.Tensor, r: torch.Tensor, row_valid: torch.Tensor, damping: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) row Jacobians + residuals -> (AtA (D, D), AtB (D,))."""
    Jm = torch.where(row_valid[:, None], J, torch.zeros_like(J))
    rm = torch.where(row_valid, r, torch.zeros_like(r))
    return Jm.T @ Jm, Jm.T @ (-damping * rm)


def solve_assembled(
    AtA: torch.Tensor, AtB: torch.Tensor, deg: DegeneracyState,
    update_degeneracy: bool, eig_thresh: float,
) -> Tuple[torch.Tensor, DegeneracyState]:
    """Solve pre-assembled normal equations with the reference's degeneracy
    projection (refreshed when ``update_degeneracy``)."""
    if update_degeneracy:
        deg = analyze_degeneracy(AtA, eig_thresh)
    d = AtA.shape[0]
    eye = torch.eye(d, dtype=AtA.dtype, device=AtA.device)
    if d == 3:
        delta = smallalg.solve3(AtA + 1e-6 * eye, AtB)
    elif d == 6:
        delta = smallalg.solve6_spd(AtA + 1e-6 * eye, AtB)
    else:
        delta = torch.linalg.solve(AtA + 1e-6 * eye, AtB)
    delta = torch.where(deg.is_degenerate, deg.P @ delta, delta)
    delta = torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))
    return delta, deg


def solve_normal_equations(
    J: torch.Tensor, r: torch.Tensor, row_valid: torch.Tensor, damping: float,
    deg: DegeneracyState, update_degeneracy: bool, eig_thresh: float,
) -> Tuple[torch.Tensor, DegeneracyState]:
    """One damped GN step:  δ = P · (JᵀJ)⁻¹ Jᵀ(−damping·r)."""
    AtA, AtB = assemble_normal_equations(J, r, row_valid, damping)
    return solve_assembled(AtA, AtB, deg, update_degeneracy, eig_thresh)


def point_to_plane(p, t1, t2, t3):
    """(unit normal (N, 3), signed distance (N,)) of p to the plane through
    (t1, t2, t3) (featureAssociation.cpp:1234-1249)."""
    n = torch.linalg.cross(t2 - t1, t3 - t1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    d = torch.sum(n * (p - t1), dim=-1)
    return n, d


def point_to_line(p, t1, t2):
    """(gradient direction (N, 3), distance (N,)) of p to the line through
    (t1, t2) (featureAssociation.cpp:1121-1135)."""
    cross = torch.linalg.cross(p - t1, p - t2)
    a012 = torch.linalg.norm(cross, dim=-1)
    l12 = torch.linalg.norm(t1 - t2, dim=-1)
    ld2 = a012 / torch.clamp(l12, min=1e-12)
    dir_ = torch.linalg.cross(cross, t2 - t1)
    dn = torch.linalg.norm(dir_, dim=-1, keepdim=True)
    return dir_ / torch.clamp(dn, min=1e-12), ld2


def fit_plane_lstsq(pts: torch.Tensor):
    """Centred plane fit n·x + d = 0 to (N, K, 3) neighbour sets; returns
    (n (N, 3), d (N,), max |n·x + d| over the K points)."""
    c = torch.mean(pts, dim=1)
    q = pts - c[:, None, :]
    cov = q.transpose(1, 2) @ q
    _, evecs = smallalg.eigh3x3(cov)
    n = evecs[..., 0]
    d = -torch.sum(n * c, dim=-1)
    off = torch.abs((pts @ n[:, :, None])[..., 0] + d[:, None])
    return n, d, torch.amax(off, dim=-1)


def pca_line(pts: torch.Tensor):
    """PCA of (N, K, 3) neighbour sets: (centroid, principal direction,
    ascending eigenvalues) (mapOptmization.cpp:1102-1127)."""
    c = torch.mean(pts, dim=1)
    q = pts - c[:, None, :]
    cov = (q.transpose(1, 2) @ q) / pts.shape[1]
    evals, evecs = smallalg.eigh3x3(cov)
    return c, evecs[..., -1], evals
