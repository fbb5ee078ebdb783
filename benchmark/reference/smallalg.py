"""Closed-form small-matrix linear algebra (port of
``legoloam_tpu/ops/smallalg.py``): Cramer 3x3 solve, Cardano symmetric 3x3
eigendecomposition, and a Schur-complement 6x6 SPD solve, batched over
leading dims.  Accuracy ~1e-6 relative for well-conditioned inputs."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .device import const


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
    ex = const((1.0, 0.0, 0.0), A.device, A.dtype).expand(A.shape[:-1])
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
    e = (ax[..., None] == torch.arange(3, device=v.device)).to(v.dtype)
    p = torch.linalg.cross(v, e)
    n = torch.linalg.norm(p, dim=-1, keepdim=True)
    return p / torch.clamp(n, min=1e-30)


def _round_robin(n: int):
    """The n-1 rounds of a round-robin tournament on n (even) indices, each
    n/2 disjoint pairs (p, q), p < q: one parallel Jacobi sweep."""
    idx = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append([tuple(sorted((idx[k], idx[n - 1 - k])))
                       for k in range(n // 2)])
        idx = [idx[0], idx[-1]] + idx[1:-1]
    return rounds


def jacobi_eigen(A: torch.Tensor, sweeps: int):
    """Eigenvalues (unordered) and eigenvectors (columns, in the same order)
    of symmetric (..., n, n) matrices, n even, by parallel cyclic Jacobi:
    each round rotates n/2 disjoint (p, q) planes at once, each rotation
    the smaller angle that zeroes A[p, q]; ``sweeps`` sweeps of n-1 rounds.
    No data-dependent control flow and no library solver (whose error
    check reads back to the host), so it can run inside a CUDA graph."""
    n = A.shape[-1]
    batch = A.shape[:-2]
    dev, dt = A.device, A.dtype
    V = torch.eye(n, dtype=dt, device=dev).expand(*batch, n, n)
    rounds = []
    for pairs in _round_robin(n):
        p = tuple(a for a, _ in pairs)
        q = tuple(b for _, b in pairs)
        # Flat positions of J's (p,p), (q,q), (p,q), (q,p) entries.
        flat = tuple(a * n + a for a in p) + tuple(b * n + b for b in q) \
            + tuple(a * n + b for a, b in pairs) \
            + tuple(b * n + a for a, b in pairs)
        rounds.append((const(p, dev, torch.int64), const(q, dev, torch.int64),
                       const(flat, dev, torch.int64)))
    for _ in range(sweeps):
        for p, q, flat in rounds:
            app, aqq, apq = A[..., p, p], A[..., q, q], A[..., p, q]
            theta = 0.5 * torch.atan(2.0 * apq / (aqq - app))
            theta = torch.where(apq == 0, torch.zeros_like(theta), theta)
            c, s = torch.cos(theta), torch.sin(theta)
            J = torch.zeros(*batch, n * n, dtype=dt, device=dev).index_copy(
                -1, flat, torch.cat([c, c, s, -s], dim=-1)).reshape(
                    *batch, n, n)
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    return torch.diagonal(A, dim1=-2, dim2=-1), V


# Horn's symmetric 4x4 N(H) as a linear map of H's 9 entries (row-major,
# H[a, b] = S_ab): (entry of N's upper triangle, entry of H, coefficient).
# The rotation of a unit quaternion (w, x, y, z) is a linear map of its 16
# products q_a q_b: (product, entry of R, coefficient).
_HORN_N = (
    (0, 0, 1), (0, 4, 1), (0, 8, 1),               # N00 = Sxx + Syy + Szz
    (1, 5, 1), (1, 7, -1),                         # N01 = Syz - Szy
    (2, 6, 1), (2, 2, -1),                         # N02 = Szx - Sxz
    (3, 1, 1), (3, 3, -1),                         # N03 = Sxy - Syx
    (5, 0, 1), (5, 4, -1), (5, 8, -1),             # N11 = Sxx - Syy - Szz
    (6, 1, 1), (6, 3, 1),                          # N12 = Sxy + Syx
    (7, 6, 1), (7, 2, 1),                          # N13 = Szx + Sxz
    (10, 0, -1), (10, 4, 1), (10, 8, -1),          # N22 = -Sxx + Syy - Szz
    (11, 5, 1), (11, 7, 1),                        # N23 = Syz + Szy
    (15, 0, -1), (15, 4, -1), (15, 8, 1),          # N33 = -Sxx - Syy + Szz
)
_HORN_R = (
    (0, 0, 1), (5, 0, 1), (10, 0, -1), (15, 0, -1),   # w²+x²-y²-z²
    (6, 1, 2), (3, 1, -2),                            # 2(xy - wz)
    (7, 2, 2), (2, 2, 2),                             # 2(xz + wy)
    (6, 3, 2), (3, 3, 2),                             # 2(xy + wz)
    (0, 4, 1), (5, 4, -1), (10, 4, 1), (15, 4, -1),   # w²-x²+y²-z²
    (11, 5, 2), (1, 5, -2),                           # 2(yz - wx)
    (7, 6, 2), (2, 6, -2),                            # 2(xz - wy)
    (11, 7, 2), (1, 7, 2),                            # 2(yz + wx)
    (0, 8, 1), (5, 8, -1), (10, 8, -1), (15, 8, 1),   # w²-x²-y²+z²
)


def _linear_map(entries, rows: int, cols: int, device, dtype,
                mirror: int = 0):
    """The (rows, cols) matrix of ``entries``; with ``mirror`` = n, each
    entry at row i*n+j, i != j, is also put at row j*n+i."""
    m = [0.0] * (rows * cols)
    for r, c, v in entries:
        m[r * cols + c] += float(v)
        if mirror and r // mirror != r % mirror:
            m[(r % mirror * mirror + r // mirror) * cols + c] += float(v)
    return const(tuple(m), device, dtype).reshape(rows, cols)


def kabsch_horn(H: torch.Tensor, sweeps: int = 5) -> torch.Tensor:
    """The rotation R maximising tr(R H) for the 3x3 cross-covariance
    H = Σ x yᵀ (so R x ≈ y), by Horn's quaternion method: the unit
    eigenvector of the largest eigenvalue of the symmetric 4x4 N(H)
    (Jacobi, ``sweeps`` sweeps).  On ties the first eigenvector wins, so
    H = 0 gives the identity, as the SVD form does.  ``H`` (..., 3, 3): a
    batch (the relocalization's headings) solves each as it would alone
    (a single matrix runs as a batch of one, and the two linear maps are
    elementwise products and sums, whose order does not depend on the
    batch)."""
    if H.dim() == 2:
        # As a batch of one: the same small batched products as a batch.
        return kabsch_horn(H[None], sweeps)[0]
    dev, dt = H.device, H.dtype
    batch = H.shape[:-2]
    Nmap = _linear_map(_HORN_N, 16, 9, dev, dt, mirror=4)
    N = torch.sum(H.reshape(*batch, 1, 9) * Nmap, dim=-1).reshape(
        *batch, 4, 4)
    evals, V = jacobi_eigen(N, sweeps)
    top = torch.argmax(evals, dim=-1)
    q = torch.gather(V, -1, top[..., None, None].expand(*batch, 4, 1))[..., 0]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                        min=1e-30)
    qq = (q[..., :, None] * q[..., None, :]).reshape(*batch, 16, 1)
    Rmap = _linear_map(_HORN_R, 16, 9, dev, dt)
    return torch.sum(qq * Rmap, dim=-2).reshape(*batch, 3, 3)
