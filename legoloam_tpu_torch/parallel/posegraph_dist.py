"""Distributed pose-graph solve: the node/link axis in blocks over the ranks
(port of ``legoloam_tpu/parallel/posegraph_dist.py``).

The single-device solver (``models/posegraph.py``) works in link space:
block-diagonal chain factors applied factored, loop factors as rank-6 terms
over contiguous link ranges, CG preconditioned by the exact chain inverse.
Distributed along the axes of that math:

  * rank r holds nodes ``r*m_loc .. (r+1)*m_loc - 1``; every per-link
    product (residuals, adjoints, block matvecs) is local;
  * each Gauss-Newton step all-gathers the poses: the loop factors (tiny,
    L <= 256) are linearised against them on every rank, and the chain
    residual of a rank's first node takes its predecessor, the previous
    rank's last row, from them (rank 0's first node has none: its row is
    chain-invalid);
  * prefix sums are a local cumsum plus an all-gather of the per-rank
    totals;
  * the loop terms reach the local rows through the port's range-indicator
    product, sliced to those rows — the single-device solve's fixed
    summation order, where the JAX package scatter-adds;
  * CG dot products are local partial sums, all-reduced; the tolerance test
    reads one all-reduced value an iteration.

Port-only: the node axis is padded to a multiple of the world size with
inert rows, where the JAX package asserts ``M % n_dev == 0``.
"""

from __future__ import annotations

import torch

from ..config import PoseGraphConfig
from ..models import posegraph as pg
from ..models.posegraph import LoopFactors, _mtv, _mv
from ..ops import se3
from ..ops.se3 import Pose
from .mesh import Mesh, pad_rows


def optimize_sharded(R, t, n_nodes, chain_R, chain_t, loops: LoopFactors,
                     prior: Pose, cfg: PoseGraphConfig, mesh: Mesh):
    """Same contract as ``models.posegraph.optimize``: replicated (M, 3, 3)
    / (M, 3) node estimates and chain measurements in, the updated (R, t)
    out, replicated on every rank; the node axis solved in blocks over
    ``mesh``."""
    M = R.shape[0]
    n = mesh.size
    dev = R.device
    m_loc = -(-M // n)
    Mp = m_loc * n
    eye = torch.eye(3, dtype=R.dtype, device=dev)
    lo = mesh.rank * m_loc
    rows = slice(lo, lo + m_loc)
    R_loc = pad_rows(R, Mp, eye)[rows]
    t_loc = pad_rows(t, Mp)[rows]
    cR = pad_rows(chain_R, Mp, eye)[rows]
    ct = pad_rows(chain_t, Mp)[rows]

    idx_g = lo + torch.arange(m_loc, device=dev)
    node_ok = idx_g < n_nodes
    chain_ok = (idx_g >= 1) & node_ok
    inert = ~node_ok
    is0 = idx_g == 0
    W_c = torch.tensor([1.0 / cfg.odom_rot_var] * 3
                       + [1.0 / cfg.odom_trans_var] * 3, device=dev)
    W_p = torch.tensor([1.0 / cfg.prior_rot_var] * 3
                       + [1.0 / cfg.prior_trans_var] * 3, device=dev)
    Wrow = torch.where(chain_ok[:, None], W_c[None], 0.0)
    Wrow = torch.where((is0 & node_ok)[:, None], W_p[None], Wrow)
    Winv_row = torch.where(Wrow > 0, 1.0 / torch.clamp(Wrow, min=1e-30), 0.0)

    n_l = mesh.read(loops.count, "loop count")
    li, lj = loops.i[:n_l].long(), loops.j[:n_l].long()
    l_lo, l_hi = torch.minimum(li, lj), torch.maximum(li, lj)
    sgn = torch.where(lj >= li, 1.0, -1.0)
    wl6 = torch.where(loops.valid[:n_l],
                      1.0 / torch.clamp(loops.var[:n_l], min=1e-9),
                      0.0)[:, None] * torch.ones((1, 6), device=dev)
    Z_l = Pose(loops.R[:n_l], loops.t[:n_l])
    # The range indicator's local rows: in_range[m, l] = lo_l < m <= hi_l.
    in_range = ((idx_g[:, None] > l_lo[None]) & (idx_g[:, None] <= l_hi[None])
                ).to(torch.float32)
    prev = torch.clamp(idx_g - 1, min=0)

    def gather_rows(x):
        return mesh.all_gather(x).reshape(Mp, *x.shape[1:])

    def dist_cumsum(v):
        """Global inclusive prefix sum along the node axis."""
        local = torch.cumsum(v, dim=0)
        totals = mesh.all_gather(local[-1])                    # (n, 6)
        return local + torch.sum(totals[:mesh.rank], dim=0)

    def gdot(a, b):
        return mesh.all_reduce(torch.sum(a * b))

    for _ in range(cfg.gn_iters):
        R_all, t_all = gather_rows(R_loc), gather_rows(t_loc)
        x_self = Pose(R_loc, t_loc)
        r_c = pg._between_residual(Pose(R_all[prev], t_all[prev]), x_self,
                                   Pose(cR, ct))
        r_c = torch.where(chain_ok[:, None], r_c, 0.0)
        B = pg._adjoint(se3.inverse(x_self))
        B_inv = pg._adjoint(x_self)
        r_p = se3.se3_log(se3.compose(se3.inverse(prior), x_self))
        r_rows = torch.where(is0[:, None], r_p, r_c)

        r_l = pg._between_residual(Pose(R_all[li], t_all[li]),
                                   Pose(R_all[lj], t_all[lj]), Z_l)
        B_l = pg._adjoint(se3.inverse(Pose(R_all[lj], t_all[lj])))

        g = _mtv(B, Wrow * r_rows)
        g = g + in_range @ (sgn[:, None] * _mtv(B_l, wl6 * r_l))
        g = torch.where(inert[:, None], 0.0, g)

        def hvp(v, B=B, B_l=B_l):
            out = _mtv(B, Wrow * _mv(B, v))
            Q_all = gather_rows(dist_cumsum(
                torch.where(node_ok[:, None], v, 0.0)))
            S = Q_all[l_hi] - Q_all[l_lo]
            out = out + in_range @ _mtv(B_l, wl6 * _mv(B_l, S))
            return torch.where(inert[:, None], v, out)

        def precond(v, B_inv=B_inv):
            return torch.where(inert[:, None], v,
                               _mv(B_inv, Winv_row * _mtv(B_inv, v)))

        b = -g
        b2 = gdot(b, b)
        x = torch.zeros((m_loc, 6), device=dev)
        rr = b
        p = precond(b)
        rz = gdot(b, p)
        rr2 = b2
        i = 0
        while i < cfg.pcg_iters and mesh.read(rr2 > cfg.pcg_tol * b2,
                                              "CG tolerance test"):
            Hp = hvp(p)
            alpha = rz / torch.clamp(gdot(p, Hp), min=1e-30)
            x = x + alpha * p
            rr = rr - alpha * Hp
            z = precond(rr)
            sums = mesh.all_reduce(torch.stack([torch.sum(rr * z),
                                                torch.sum(rr * rr)]))
            rz_new, rr2 = sums[0], sums[1]
            p = z + rz_new / torch.clamp(rz, min=1e-30) * p
            rz = rz_new
            i += 1

        du = torch.where(node_ok[:, None], x, 0.0)
        v = torch.where(node_ok[:, None], dist_cumsum(du), 0.0)
        upd = se3.se3_exp(v)
        R_loc, t_loc = upd.R @ R_loc, se3.rotate_vec(upd.R, t_loc) + upd.t
    return gather_rows(R_loc)[:M], gather_rows(t_loc)[:M]
