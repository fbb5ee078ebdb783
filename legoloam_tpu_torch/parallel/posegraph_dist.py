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
  * CG dot products are local partial sums, all-reduced;
  * every slot of the factor store takes part, an invalid one with weight
    0, so the solve has one shape whatever the count (as the single
    device's since it became a graph).

Like ``models/posegraph.optimize`` the solve runs as segments
(``ops/segments.py``): the CG in chunks of ``posegraph.CHUNK`` iterations,
each frozen once stopped, with one read of the replicated tolerance test
a chunk through the runner (``Mesh.read``); the collectives are inside the
segments, so on NCCL the solve replays as CUDA graphs.

Port-only: the node axis is padded to a multiple of the world size with
inert rows, where the JAX package asserts ``M % n_dev == 0``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..config import PoseGraphConfig
from ..device import const
from ..models import posegraph as pg
from ..models.posegraph import LoopFactors, _mtv, _mv
from ..ops import se3
from ..ops.se3 import Pose
from ..ops.segments import Eager
from .mesh import Mesh, pad_rows


class _Shard(NamedTuple):
    """What the GN steps of one sharded solve share: this rank's rows and
    the loop factors' terms."""

    idx: torch.Tensor        # (m_loc,) global node index of each local row
    node_ok: torch.Tensor
    chain_ok: torch.Tensor
    is0: torch.Tensor
    Wrow: torch.Tensor       # (m_loc, 6) chain weights, the prior on node 0
    Winv_row: torch.Tensor
    prev: torch.Tensor       # (m_loc,) global index of each row's predecessor
    cR: torch.Tensor         # (m_loc, 3, 3) chain measurements
    ct: torch.Tensor
    li: torch.Tensor         # (L,) int64 loop endpoints
    lj: torch.Tensor
    l_lo: torch.Tensor
    l_hi: torch.Tensor
    sgn: torch.Tensor
    wl6: torch.Tensor        # (L, 6) loop weights, 0 for an invalid slot
    in_range: torch.Tensor   # (m_loc, L) the range indicator's local rows
    Z_R: torch.Tensor
    Z_t: torch.Tensor
    prior_R: torch.Tensor
    prior_t: torch.Tensor


def _setup(R, n_nodes, chain_R, chain_t, loops: LoopFactors, prior: Pose,
           cfg: PoseGraphConfig, mesh: Mesh) -> _Shard:
    """The shard's constants (``R`` gives the node count)."""
    M = R.shape[0]
    n = mesh.size
    dev = R.device
    m_loc = -(-M // n)
    Mp = m_loc * n
    eye = torch.eye(3, dtype=R.dtype, device=dev)
    lo = mesh.rank * m_loc
    rows = slice(lo, lo + m_loc)
    idx = lo + torch.arange(m_loc, device=dev)
    node_ok = idx < n_nodes
    chain_ok = (idx >= 1) & node_ok
    is0 = idx == 0
    W_c = const((1.0 / cfg.odom_rot_var,) * 3
                + (1.0 / cfg.odom_trans_var,) * 3, dev)
    W_p = const((1.0 / cfg.prior_rot_var,) * 3
                + (1.0 / cfg.prior_trans_var,) * 3, dev)
    Wrow = torch.where(chain_ok[:, None], W_c[None], 0.0)
    Wrow = torch.where((is0 & node_ok)[:, None], W_p[None], Wrow)
    li, lj = loops.i.long(), loops.j.long()
    l_lo, l_hi = torch.minimum(li, lj), torch.maximum(li, lj)
    G = _Shard(
        idx=idx, node_ok=node_ok, chain_ok=chain_ok, is0=is0, Wrow=Wrow,
        Winv_row=torch.where(Wrow > 0, 1.0 / torch.clamp(Wrow, min=1e-30),
                             0.0),
        prev=torch.clamp(idx - 1, min=0),
        cR=pad_rows(chain_R, Mp, eye)[rows], ct=pad_rows(chain_t, Mp)[rows],
        li=li, lj=lj, l_lo=l_lo, l_hi=l_hi,
        sgn=torch.where(lj >= li, 1.0, -1.0),
        wl6=torch.where(loops.valid, 1.0 / torch.clamp(loops.var, min=1e-9),
                        0.0)[:, None] * torch.ones((1, 6), device=dev),
        in_range=((idx[:, None] > l_lo[None]) & (idx[:, None] <= l_hi[None])
                  ).to(torch.float32),
        Z_R=loops.R.clone(), Z_t=loops.t.clone(), prior_R=prior.R.clone(),
        prior_t=prior.t.clone())
    return G


def _gather_rows(x, mesh: Mesh):
    return mesh.all_gather(x).reshape(-1, *x.shape[1:])


def _cumsum(v, mesh: Mesh):
    """Global inclusive prefix sum along the node axis."""
    local = torch.cumsum(v, dim=0)
    totals = mesh.all_gather(local[-1])                    # (n, 6)
    return local + torch.sum(totals[:mesh.rank], dim=0)


def _gdot(a, b, mesh: Mesh):
    return mesh.all_reduce(torch.sum(a * b))


class _Lin(NamedTuple):
    B: torch.Tensor
    B_inv: torch.Tensor
    B_l: torch.Tensor
    b2: torch.Tensor


def _precond(G: _Shard, lin: _Lin, v):
    return torch.where(G.node_ok[:, None],
                       _mv(lin.B_inv, G.Winv_row * _mtv(lin.B_inv, v)), v)


def _hvp(G: _Shard, lin: _Lin, v, mesh: Mesh):
    out = _mtv(lin.B, G.Wrow * _mv(lin.B, v))
    Q_all = _gather_rows(_cumsum(torch.where(G.node_ok[:, None], v, 0.0),
                                 mesh), mesh)
    S = Q_all[G.l_hi] - Q_all[G.l_lo]
    out = out + G.in_range @ _mtv(lin.B_l, G.wl6 * _mv(lin.B_l, S))
    return torch.where(G.node_ok[:, None], out, v)


def _linearize(G: _Shard, R_loc, t_loc, cfg: PoseGraphConfig, mesh: Mesh):
    """One GN step's linearisation at the shard's rows and the CG's
    start."""
    R_all, t_all = _gather_rows(R_loc, mesh), _gather_rows(t_loc, mesh)
    x_self = Pose(R_loc, t_loc)
    r_c = pg._between_residual(Pose(R_all[G.prev], t_all[G.prev]), x_self,
                               Pose(G.cR, G.ct))
    r_c = torch.where(G.chain_ok[:, None], r_c, 0.0)
    r_p = se3.se3_log(se3.compose(se3.inverse(Pose(G.prior_R, G.prior_t)),
                                  x_self))
    r_rows = torch.where(G.is0[:, None], r_p, r_c)
    r_l = pg._between_residual(Pose(R_all[G.li], t_all[G.li]),
                               Pose(R_all[G.lj], t_all[G.lj]),
                               Pose(G.Z_R, G.Z_t))
    lin = _Lin(B=pg._adjoint(se3.inverse(x_self)), B_inv=pg._adjoint(x_self),
               B_l=pg._adjoint(se3.inverse(Pose(R_all[G.lj], t_all[G.lj]))),
               b2=torch.zeros((), device=R_loc.device))
    g = _mtv(lin.B, G.Wrow * r_rows)
    g = g + G.in_range @ (G.sgn[:, None] * _mtv(lin.B_l, G.wl6 * r_l))
    b = -torch.where(G.node_ok[:, None], g, 0.0)
    b2 = _gdot(b, b, mesh)
    lin = lin._replace(b2=b2)
    p = _precond(G, lin, b)
    stop = ~(b2 > cfg.pcg_tol * b2)
    if cfg.pcg_iters < 1:
        stop = torch.ones_like(stop)
    return lin, pg._Pcg(x=torch.zeros_like(b), rr=b, p=p,
                        rz=_gdot(b, p, mesh),
                        i=torch.zeros((), dtype=torch.int32,
                                      device=R_loc.device), stop=stop)


def _pcg_iterate(pcg: pg._Pcg, G: _Shard, lin: _Lin, n: int,
                 cfg: PoseGraphConfig, mesh: Mesh) -> pg._Pcg:
    """``n`` CG iterations, each a no-op once ``stop`` is set (the stop
    test on all-reduced sums: replicated)."""
    for _ in range(n):
        active = ~pcg.stop
        x, rr, p, rz = pcg.x, pcg.rr, pcg.p, pcg.rz
        Hp = _hvp(G, lin, p, mesh)
        alpha = rz / torch.clamp(_gdot(p, Hp, mesh), min=1e-30)
        x = x + alpha * p
        rr = rr - alpha * Hp
        z = _precond(G, lin, rr)
        sums = mesh.all_reduce(torch.stack([torch.sum(rr * z),
                                            torch.sum(rr * rr)]))
        rz_new, rr2 = sums[0], sums[1]
        p = z + rz_new / torch.clamp(rz, min=1e-30) * p
        i = pcg.i + active.to(torch.int32)
        more = (i < cfg.pcg_iters) & (rr2 > cfg.pcg_tol * lin.b2)
        pcg = pg._Pcg(x=torch.where(active, x, pcg.x),
                      rr=torch.where(active, rr, pcg.rr),
                      p=torch.where(active, p, pcg.p),
                      rz=torch.where(active, rz_new, pcg.rz), i=i,
                      stop=pcg.stop | (active & ~more))
    return pcg


def _update(G: _Shard, R_loc, t_loc, pcg: pg._Pcg, mesh: Mesh):
    du = torch.where(G.node_ok[:, None], pcg.x, 0.0)
    v = torch.where(G.node_ok[:, None], _cumsum(du, mesh), 0.0)
    upd = se3.se3_exp(v)
    return upd.R @ R_loc, se3.rotate_vec(upd.R, t_loc) + upd.t


def optimize_sharded(R, t, n_nodes, chain_R, chain_t, loops: LoopFactors,
                     prior: Pose, cfg: PoseGraphConfig, mesh: Mesh,
                     rt=None):
    """Same contract as ``models.posegraph.optimize``: replicated (M, 3, 3)
    / (M, 3) node estimates and chain measurements in, the updated (R, t)
    out, replicated on every rank; the node axis solved in blocks over
    ``mesh``.  ``rt``: the segment runner (default: eager, reading through
    ``Mesh.read``; a graph runner writes the result into ``R`` and
    ``t``)."""
    rt = rt or Eager(mesh.read)
    G = rt.seg(("pgd", "setup", cfg), partial(_setup, cfg=cfg, mesh=mesh),
               R, n_nodes, chain_R, chain_t, loops, prior)
    loc = rt.seg(("pgd", "rows"), partial(_rows, mesh=mesh), R, t)
    for _ in range(cfg.gn_iters):
        lin, pcg = rt.seg(("pgd", "linearize", cfg),
                          partial(_linearize, cfg=cfg, mesh=mesh), G, *loc)
        while True:
            pcg = rt.seg(("pgd", "pcg", cfg),
                         partial(_pcg_iterate, n=pg.CHUNK, cfg=cfg,
                                 mesh=mesh),
                         pcg, G, lin, into=pcg)
            if rt.read(pcg.stop, "CG stop"):
                break
        loc = rt.seg(("pgd", "update"), partial(_update, mesh=mesh), G,
                     *loc, pcg, into=loc)
    return rt.seg(("pgd", "gather"), partial(_gather, M=R.shape[0],
                                             mesh=mesh), *loc, into=(R, t))


def _rows(R, t, mesh: Mesh):
    """This rank's rows of the node estimates (padded with inert rows)."""
    M = R.shape[0]
    m_loc = -(-M // mesh.size)
    lo = mesh.rank * m_loc
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return (pad_rows(R, m_loc * mesh.size, eye)[lo:lo + m_loc].clone(),
            pad_rows(t, m_loc * mesh.size)[lo:lo + m_loc].clone())


def _gather(R_loc, t_loc, M: int, mesh: Mesh):
    return (_gather_rows(R_loc, mesh)[:M], _gather_rows(t_loc, mesh)[:M])
