"""Closed-form small-matrix linear algebra (port of
``legoloam_tpu/ops/smallalg.py``): Cramer 3x3 solve, Cardano symmetric 3x3
eigendecomposition, and a Schur-complement 6x6 SPD solve, batched over
leading dims.  Accuracy ~1e-6 relative for well-conditioned inputs."""

from __future__ import annotations

import math
from typing import Tuple

import torch


def det3(A: torch.Tensor) -> torch.Tensor:
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def adjugate3(A: torch.Tensor) -> torch.Tensor:
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    row0 = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1)
    row1 = torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1)
    row2 = torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def solve3(A: torch.Tensor, b: torch.Tensor, eps: float = 1e-20
           ) -> torch.Tensor:
    """x = A⁻¹ b for (..., 3, 3) @ (..., 3); singular systems return 0."""
    det = det3(A)
    x = (adjugate3(A) @ b[..., None])[..., 0]
    safe = torch.abs(det) > eps
    return torch.where(safe[..., None],
                       x / torch.where(safe, det, torch.ones_like(det))[
                           ..., None],
                       torch.zeros_like(x))


def inv3(A: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    det = det3(A)
    safe = torch.abs(det) > eps
    inv = adjugate3(A) / torch.where(safe, det, torch.ones_like(det))[
        ..., None, None]
    return torch.where(safe[..., None, None], inv, torch.zeros_like(A))


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3), ascending (trigonometric
    closed form, Smith 1961)."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    a00 = A[..., 0, 0] - q
    a11 = A[..., 1, 1] - q
    a22 = A[..., 2, 2] - q
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    p2 = (a00 * a00 + a11 * a11 + a22 * a22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    B00, B11, B22 = a00 / p, a11 / p, a22 / p
    B01, B02, B12 = a01 / p, a02 / p, a12 / p
    detB = (B00 * (B11 * B22 - B12 * B12)
            - B01 * (B01 * B22 - B12 * B02)
            + B02 * (B01 * B12 - B11 * B02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    zerop = p2 < 1e-28
    e1 = torch.where(zerop, q, e1)
    e2 = torch.where(zerop, q, e2)
    e3 = torch.where(zerop, q, e3)
    return torch.stack([e3, e2, e1], dim=-1)


def _eigvec(A: torch.Tensor, lam: torch.Tensor,
            fallback: torch.Tensor) -> torch.Tensor:
    """Eigenvector of symmetric A for eigenvalue lam: the largest cross
    product of two rows of (A - lam I), else ``fallback``."""
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype,
                                             device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    norm = torch.linalg.norm(best, dim=-1, keepdim=True)
    ok = norm[..., 0] > 1e-12
    return torch.where(ok[..., None], best / torch.clamp(norm, min=1e-30),
                       fallback)


def eigh3x3(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric (..., 3, 3) eigendecomposition, ascending eigenvalues,
    eigenvectors as COLUMNS."""
    evals = eigvalsh3(A)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=A.dtype,
                      device=A.device).expand(A.shape[:-1])
    v2 = _eigvec(A, evals[..., 2], ex)
    v0 = _eigvec(A, evals[..., 0], _perp(v2))
    v0 = v0 - torch.sum(v0 * v2, dim=-1, keepdim=True) * v2
    n0 = torch.linalg.norm(v0, dim=-1, keepdim=True)
    v0 = torch.where(n0 > 1e-12, v0 / torch.clamp(n0, min=1e-30), _perp(v2))
    v1 = torch.linalg.cross(v2, v0)
    return evals, torch.stack([v0, v1, v2], dim=-1)


def solve6_spd(A: torch.Tensor, b: torch.Tensor, eps: float = 1e-8
               ) -> torch.Tensor:
    """x = A⁻¹ b for symmetric positive (semi)definite (..., 6, 6) via the
    2x2-block Schur complement over closed-form 3x3 inverses."""
    reg = eps * torch.eye(3, dtype=A.dtype, device=A.device)
    P = A[..., :3, :3] + reg
    Q = A[..., :3, 3:]
    S = A[..., 3:, 3:] + reg
    b1, b2 = b[..., :3], b[..., 3:]
    Pinv = inv3(P)
    PinvQ = Pinv @ Q
    schur = S - Q.transpose(-1, -2) @ PinvQ
    rhs2 = b2 - (PinvQ.transpose(-1, -2) @ b1[..., None])[..., 0]
    x2 = solve3(schur + reg, rhs2)
    x1 = (Pinv @ b1[..., None])[..., 0] - (PinvQ @ x2[..., None])[..., 0]
    return torch.cat([x1, x2], dim=-1)


def _perp(v: torch.Tensor) -> torch.Tensor:
    """Any unit vector perpendicular to unit v."""
    ax = torch.argmin(torch.abs(v), dim=-1)
    e = torch.nn.functional.one_hot(ax, 3).to(v.dtype)
    p = torch.linalg.cross(v, e)
    n = torch.linalg.norm(p, dim=-1, keepdim=True)
    return p / torch.clamp(n, min=1e-30)
