"""SE(3) pose graph: the loop-factor store and the link-space Gauss-Newton
solve (frozen plain copy of ``models/posegraph.py``; the gtsam role of
``src/mapOptmization.cpp:36-47,347-350,939-942,1375-1399``).

The variables are per-link corrections u_k (node perturbation v_k = Σ_{m≤k}
u_m), so each chain factor touches one variable and the chain Hessian is
block-diagonal, D_k = B_kᵀ W B_k with B_k = Ad(x_k⁻¹), inverted exactly as
Ad(x_k) W⁻¹ Ad(x_k)ᵀ and applied factored.  Each loop factor is a rank-6
term over a contiguous link range, summed onto the nodes by the (nodes x
loops) range indicator matrix.  Each GN step solves for u by CG
preconditioned with D⁻¹, one iteration at a time until the relative
residual falls below ``pcg_tol`` or ``pcg_iters`` ran.

Departures from the source, as the port's: every accepted closure re-solves
the whole graph by ``gn_iters`` GN steps from the current estimate, where
LeGO-LOAM updates iSAM2 incrementally (one ``update`` plus ``calculateEstimate``);
the noise models are isotropic, the loop factor's variance the ICP fitness
as in the source; every slot of the fixed-cap factor store takes part, an
empty one with weight 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3
from .config import PoseGraphConfig
from .device import const
from .se3 import Pose


class LoopFactors(NamedTuple):
    """Fixed-cap loop-closure between-factors: measurement Z = T_i⁻¹ T_j."""

    i: torch.Tensor        # (L,) int32 from-node
    j: torch.Tensor        # (L,) int32 to-node
    R: torch.Tensor        # (L, 3, 3)
    t: torch.Tensor        # (L, 3)
    var: torch.Tensor      # (L,) isotropic variance (the ICP fitness)
    valid: torch.Tensor    # (L,) bool
    count: torch.Tensor    # () int32
    dropped: torch.Tensor  # () int32 accepted closures the full store lost


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
    """The store with the factor appended at slot ``count``, or with
    ``dropped`` counted when it is full."""
    cap = lf.i.shape[0]
    ok = lf.count < cap
    k = torch.clamp(lf.count, max=cap - 1).long().reshape(1)

    def put(arr, val):
        val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
        return torch.where(ok, arr.index_put((k,), val.unsqueeze(0)), arr)

    return LoopFactors(
        i=put(lf.i, i), j=put(lf.j, j), R=put(lf.R, meas.R),
        t=put(lf.t, meas.t), var=put(lf.var, variance),
        valid=put(lf.valid, torch.ones((), dtype=torch.bool,
                                       device=lf.valid.device)),
        count=lf.count + ok.to(torch.int32),
        dropped=lf.dropped + (~ok).to(torch.int32))


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
    return (A @ v[..., None])[..., 0]


def _mtv(A, v):
    return (A.transpose(-1, -2) @ v[..., None])[..., 0]


class _Graph(NamedTuple):
    node_ok: torch.Tensor
    chain_ok: torch.Tensor
    Wrow: torch.Tensor
    Winv_row: torch.Tensor
    li: torch.Tensor
    lj: torch.Tensor
    l_lo: torch.Tensor
    l_hi: torch.Tensor
    sgn: torch.Tensor
    wl6: torch.Tensor
    in_range: torch.Tensor
    Z_R: torch.Tensor
    Z_t: torch.Tensor
    prior_R: torch.Tensor
    prior_t: torch.Tensor


class _Lin(NamedTuple):
    B: torch.Tensor
    B_inv: torch.Tensor
    B_l: torch.Tensor
    b2: torch.Tensor


class _Pcg(NamedTuple):
    x: torch.Tensor
    rr: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    i: torch.Tensor
    stop: torch.Tensor


def _setup(R, n_nodes, loops: LoopFactors, prior: Pose,
           cfg: PoseGraphConfig) -> _Graph:
    M = R.shape[0]
    dev = R.device
    idx = torch.arange(M, device=dev)
    node_ok = idx < n_nodes
    chain_ok = (idx >= 1) & node_ok
    W_c = const((1.0 / cfg.odom_rot_var,) * 3
                + (1.0 / cfg.odom_trans_var,) * 3, dev)
    W_p = const((1.0 / cfg.prior_rot_var,) * 3
                + (1.0 / cfg.prior_trans_var,) * 3, dev)
    li, lj = loops.i.long(), loops.j.long()
    l_lo, l_hi = torch.minimum(li, lj), torch.maximum(li, lj)
    sgn = torch.where(lj >= li, 1.0, -1.0)
    wl6 = torch.where(loops.valid,
                      1.0 / torch.clamp(loops.var, min=1e-9),
                      0.0)[:, None] * torch.ones((1, 6), device=dev)
    in_range = ((idx[:, None] > l_lo[None]) & (idx[:, None] <= l_hi[None])
                ).to(torch.float32)
    Wrow = torch.where(chain_ok[:, None], W_c[None], 0.0)
    Wrow = torch.cat([torch.where(node_ok[0], W_p, 0.0)[None], Wrow[1:]])
    Winv_row = torch.where(Wrow > 0, 1.0 / torch.clamp(Wrow, min=1e-30), 0.0)
    return _Graph(node_ok=node_ok, chain_ok=chain_ok, Wrow=Wrow,
                  Winv_row=Winv_row, li=li, lj=lj, l_lo=l_lo, l_hi=l_hi,
                  sgn=sgn, wl6=wl6, in_range=in_range, Z_R=loops.R.clone(),
                  Z_t=loops.t.clone(), prior_R=prior.R.clone(),
                  prior_t=prior.t.clone())


def _precond(G: _Graph, lin: _Lin, v):
    return torch.where(G.node_ok[:, None],
                       _mv(lin.B_inv, G.Winv_row * _mtv(lin.B_inv, v)), v)


def _hvp(G: _Graph, lin: _Lin, v):
    out = _mtv(lin.B, G.Wrow * _mv(lin.B, v))                   # D v
    Qv = torch.cumsum(torch.where(G.node_ok[:, None], v, 0.0), dim=0)
    S = Qv[G.l_hi] - Qv[G.l_lo]                                 # (L, 6)
    out = out + G.in_range @ _mtv(lin.B_l, G.wl6 * _mv(lin.B_l, S))
    return torch.where(G.node_ok[:, None], out, v)


def _linearize(G: _Graph, R, t, chain_R, chain_t, cfg: PoseGraphConfig):
    """One GN step's linearisation at (R, t) and the CG's start."""
    M = R.shape[0]
    prev = torch.clamp(torch.arange(M, device=R.device) - 1, min=0)
    x_self = Pose(R, t)
    r_c = _between_residual(Pose(R[prev], t[prev]), x_self,
                            Pose(chain_R, chain_t))
    r_p = se3.se3_log(se3.compose(se3.inverse(Pose(G.prior_R, G.prior_t)),
                                  Pose(R[0], t[0])))
    r_rows = torch.where(G.chain_ok[:, None], r_c, 0.0)
    r_rows = torch.cat([torch.where(G.node_ok[0], r_p, 0.0)[None],
                        r_rows[1:]])
    r_l = _between_residual(Pose(R[G.li], t[G.li]), Pose(R[G.lj], t[G.lj]),
                            Pose(G.Z_R, G.Z_t))
    lin = _Lin(B=_adjoint(se3.inverse(x_self)), B_inv=_adjoint(x_self),
               B_l=_adjoint(se3.inverse(Pose(R[G.lj], t[G.lj]))),
               b2=torch.zeros((), device=R.device))
    g = _mtv(lin.B, G.Wrow * r_rows)
    g = g + G.in_range @ (G.sgn[:, None] * _mtv(lin.B_l, G.wl6 * r_l))
    b = -torch.where(G.node_ok[:, None], g, 0.0)
    b2 = torch.sum(b * b)
    lin = lin._replace(b2=b2)
    p = _precond(G, lin, b)
    stop = ~(b2 > cfg.pcg_tol * b2)
    if cfg.pcg_iters < 1:
        stop = torch.ones_like(stop)
    return lin, _Pcg(x=torch.zeros_like(b), rr=b, p=p,
                     rz=torch.sum(b * p),
                     i=torch.zeros((), dtype=torch.int32, device=R.device),
                     stop=stop)


def _pcg_iteration(pcg: _Pcg, G: _Graph, lin: _Lin,
                   cfg: PoseGraphConfig) -> _Pcg:
    """One CG iteration (a no-op once ``stop`` is set)."""
    active = ~pcg.stop
    x, rr, p, rz = pcg.x, pcg.rr, pcg.p, pcg.rz
    Hp = _hvp(G, lin, p)
    alpha = rz / torch.clamp(torch.sum(p * Hp), min=1e-30)
    x = x + alpha * p
    rr = rr - alpha * Hp
    z = _precond(G, lin, rr)
    rz_new = torch.sum(rr * z)
    p = z + rz_new / torch.clamp(rz, min=1e-30) * p
    i = pcg.i + active.to(torch.int32)
    more = (i < cfg.pcg_iters) & (torch.sum(rr * rr) > cfg.pcg_tol * lin.b2)
    return _Pcg(x=torch.where(active, x, pcg.x),
                rr=torch.where(active, rr, pcg.rr),
                p=torch.where(active, p, pcg.p),
                rz=torch.where(active, rz_new, pcg.rz), i=i,
                stop=pcg.stop | (active & ~more))


def _update(G: _Graph, R, t, pcg: _Pcg):
    """Links -> nodes (v = cumsum u) and the left-multiplicative update."""
    du = torch.where(G.node_ok[:, None], pcg.x, 0.0)
    v = torch.where(G.node_ok[:, None], torch.cumsum(du, dim=0), 0.0)
    upd = se3.se3_exp(v)
    return upd.R @ R, se3.rotate_vec(upd.R, t) + upd.t


def optimize(R, t, n_nodes, chain_R, chain_t, loops: LoopFactors,
             prior: Pose, cfg: PoseGraphConfig):
    """The full re-solve: ``cfg.gn_iters`` GN steps from (R, t) (rows >=
    ``n_nodes`` inert; ``chain_R/chain_t`` the measurement from node k-1 to
    k; ``prior`` anchors node 0), each CG run to its stop.  Returns the
    updated (R, t)."""
    G = _setup(R, n_nodes, loops, prior, cfg)
    for _ in range(cfg.gn_iters):
        lin, pcg = _linearize(G, R, t, chain_R, chain_t, cfg)
        while not bool(pcg.stop):
            pcg = _pcg_iteration(pcg, G, lin, cfg)
        R, t = _update(G, R, t, pcg)
    return R, t
