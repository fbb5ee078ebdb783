"""SE(3) pose graph: loop-factor store and the link-space Gauss-Newton
solver (port of ``legoloam_tpu/models/posegraph.py``; the gtsam/iSAM2
replacement of ``src/mapOptmization.cpp:36-47,347-350,939-942,1375-1399``).

The variables are per-link corrections u_k (node perturbation v_k = Σ_{m≤k}
u_m), so every chain factor touches one variable: the chain Hessian is
block-diagonal, D_k = B_kᵀ W B_k with B_k = Ad(x_k⁻¹), and its inverse is
exactly Ad(x_k) W⁻¹ Ad(x_k)ᵀ.  D and D⁻¹ are applied factored and never
formed — with 10²-m lever arms D's entries span 1e12 down to 1e6, which
float32 cannot hold in one matrix.  Each loop factor is a rank-6 term over
a contiguous link range.  CG preconditioned by D⁻¹ sees identity plus
rank 6L and exits on ``pcg_tol`` in ~6L+1 iterations.

Where the JAX package scatter-adds the loop terms onto range boundaries and
takes a cumulative sum, the port multiplies by the (nodes x loops) range
indicator matrix: the same sums, in a fixed order on every device (a float
scatter-add on the card sums in no fixed order), without the boundary
difference's cancellation.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import PoseGraphConfig
from ..ops import se3
from ..ops.se3 import Pose


class LoopFactors(NamedTuple):
    """Fixed-cap loop-closure between-factors: measurement Z = T_i⁻¹ T_j."""

    i: torch.Tensor        # (L,) int32 from-node
    j: torch.Tensor        # (L,) int32 to-node
    R: torch.Tensor        # (L, 3, 3)
    t: torch.Tensor        # (L, 3)
    var: torch.Tensor      # (L,) isotropic variance (the ICP fitness)
    valid: torch.Tensor    # (L,) bool
    count: torch.Tensor    # () int32
    # Accepted closures dropped because the store was full, plus factors
    # that keyframe decimation collapsed onto one node.
    dropped: torch.Tensor  # () int32


def init_loop_factors(cap: int, device=None) -> LoopFactors:
    i32 = dict(dtype=torch.int32, device=device)
    return LoopFactors(
        i=torch.zeros(cap, **i32), j=torch.zeros(cap, **i32),
        R=torch.eye(3, device=device).expand(cap, 3, 3).clone(),
        t=torch.zeros((cap, 3), device=device),
        var=torch.ones(cap, device=device),
        valid=torch.zeros(cap, dtype=torch.bool, device=device),
        count=torch.tensor(0, **i32), dropped=torch.tensor(0, **i32))


def add_loop_factor(lf: LoopFactors, i, j, meas: Pose, variance
                    ) -> LoopFactors:
    """A new store with the factor appended, or with ``dropped`` counted
    when the store is full."""
    k = int(lf.count)
    if k >= lf.i.shape[0]:
        return lf._replace(dropped=lf.dropped + 1)

    def put(arr, val):
        out = arr.clone()
        out[k] = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
        return out

    return LoopFactors(
        i=put(lf.i, i), j=put(lf.j, j), R=put(lf.R, meas.R),
        t=put(lf.t, meas.t), var=put(lf.var, variance),
        valid=put(lf.valid, True), count=lf.count + 1, dropped=lf.dropped)


def _adjoint(p: Pose) -> torch.Tensor:
    """SE(3) adjoint for [w; v] twist ordering: [[R, 0], [[t]x R, R]]."""
    R = p.R
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([se3.hat(p.t) @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _between_residual(xi_pose: Pose, xj_pose: Pose, Z: Pose):
    """r = log(Z⁻¹ x_i⁻¹ x_j), batched."""
    return se3.se3_log(se3.compose(se3.inverse(Z),
                                   se3.relative(xi_pose, xj_pose)))


def _mv(A, v):
    """Batched A v for (..., 6, 6) @ (..., 6)."""
    return (A @ v[..., None])[..., 0]


def _mtv(A, v):
    """Batched Aᵀ v."""
    return (A.transpose(-1, -2) @ v[..., None])[..., 0]


def optimize(R, t, n_nodes, chain_R, chain_t, loops: LoopFactors,
             prior: Pose, cfg: PoseGraphConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full GN re-solve in link space.  R/t: (M, 3, 3)/(M, 3) node
    estimates (rows >= n_nodes inert); chain_R/chain_t: (M, ...) between
    measurements from node k-1 to k (row 0 unused); ``prior`` anchors node
    0.  Returns updated (R, t).  ``cfg.gn_iters`` GN steps; each CG loop
    reads its tolerance test back once an iteration."""
    M = R.shape[0]
    dev = R.device
    idx = torch.arange(M, device=dev)
    node_ok = idx < n_nodes
    chain_ok = (idx >= 1) & node_ok
    inert = ~node_ok
    zero6 = torch.zeros(6, device=dev)
    W_c = torch.tensor([1.0 / cfg.odom_rot_var] * 3
                       + [1.0 / cfg.odom_trans_var] * 3, device=dev)
    W_p = torch.tensor([1.0 / cfg.prior_rot_var] * 3
                       + [1.0 / cfg.prior_trans_var] * 3, device=dev)

    # Only the first ``count`` slots can hold a factor.
    n_l = int(loops.count)
    li, lj = loops.i[:n_l].long(), loops.j[:n_l].long()
    l_lo, l_hi = torch.minimum(li, lj), torch.maximum(li, lj)
    sgn = torch.where(lj >= li, 1.0, -1.0)
    wl6 = torch.where(loops.valid[:n_l],
                      1.0 / torch.clamp(loops.var[:n_l], min=1e-9),
                      0.0)[:, None] * torch.ones((1, 6), device=dev)
    Z_l = Pose(loops.R[:n_l], loops.t[:n_l])
    # Range indicator: in_range[m, l] = lo_l < m <= hi_l.
    in_range = ((idx[:, None] > l_lo[None]) & (idx[:, None] <= l_hi[None])
                ).to(torch.float32)
    prev = torch.clamp(idx - 1, min=0)
    Wrow = torch.where(chain_ok[:, None], W_c[None], 0.0)
    Wrow[0] = torch.where(node_ok[0], W_p, zero6)
    Winv_row = torch.where(Wrow > 0, 1.0 / torch.clamp(Wrow, min=1e-30), 0.0)

    R_cur, t_cur = R, t
    for _ in range(cfg.gn_iters):
        x_self = Pose(R_cur, t_cur)
        r_c = _between_residual(Pose(R_cur[prev], t_cur[prev]), x_self,
                                Pose(chain_R, chain_t))
        r_c = torch.where(chain_ok[:, None], r_c, 0.0)
        B = _adjoint(se3.inverse(x_self))                       # (M, 6, 6)
        B_inv = _adjoint(x_self)                                # exact B⁻¹
        r_p = se3.se3_log(se3.compose(se3.inverse(prior),
                                      Pose(R_cur[0], t_cur[0])))
        r_rows = r_c.clone()
        r_rows[0] = torch.where(node_ok[0], r_p, zero6)

        x_i = Pose(R_cur[li], t_cur[li])
        x_j = Pose(R_cur[lj], t_cur[lj])
        r_l = _between_residual(x_i, x_j, Z_l)
        B_l = _adjoint(se3.inverse(x_j))                        # (L, 6, 6)

        g = _mtv(B, Wrow * r_rows)
        g = g + in_range @ (sgn[:, None] * _mtv(B_l, wl6 * r_l))
        g = torch.where(inert[:, None], 0.0, g)

        def hvp(v, B=B, B_l=B_l):
            out = _mtv(B, Wrow * _mv(B, v))                     # D v
            Qv = torch.cumsum(torch.where(node_ok[:, None], v, 0.0), dim=0)
            S = Qv[l_hi] - Qv[l_lo]                             # (L, 6)
            out = out + in_range @ _mtv(B_l, wl6 * _mv(B_l, S))
            return torch.where(inert[:, None], v, out)

        def precond(v, B_inv=B_inv):
            return torch.where(inert[:, None], v,
                               _mv(B_inv, Winv_row * _mtv(B_inv, v)))

        b = -g
        b2 = torch.sum(b * b)
        x = torch.zeros((M, 6), device=dev)
        rr = b
        p = precond(b)
        rz = torch.sum(b * p)
        i = 0
        while i < cfg.pcg_iters and bool(torch.sum(rr * rr)
                                         > cfg.pcg_tol * b2):
            Hp = hvp(p)
            alpha = rz / torch.clamp(torch.sum(p * Hp), min=1e-30)
            x = x + alpha * p
            rr = rr - alpha * Hp
            z = precond(rr)
            rz_new = torch.sum(rr * z)
            p = z + rz_new / torch.clamp(rz, min=1e-30) * p
            rz = rz_new
            i += 1

        # Links -> nodes (v = cumsum u) and the left-multiplicative update.
        du = torch.where(node_ok[:, None], x, 0.0)
        v = torch.where(node_ok[:, None], torch.cumsum(du, dim=0), 0.0)
        upd = se3.se3_exp(v)
        R_cur, t_cur = upd.R @ R_cur, se3.rotate_vec(upd.R, t_cur) + upd.t
    return R_cur, t_cur
