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

Every slot of the factor store takes part (an invalid one with weight 0),
so the solve has one shape whatever the count.  The JAX ``while_loop`` of
the CG runs as chunks of ``chunk`` iterations, each frozen once the
tolerance test or the cap stopped it, with one host read of the stop flag
after each chunk (``ops/segments.py``): the per-iteration loop's result.

Where the JAX package scatter-adds the loop terms onto range boundaries and
takes a cumulative sum, the port multiplies by the (nodes x loops) range
indicator matrix: the same sums, in a fixed order on every device (a float
scatter-add on the card sums in no fixed order), without the boundary
difference's cancellation.  The link-axis prefix sums (the loop terms'
range sums, links to nodes) go through K5 (``ops/link_scan_cuda.py``),
which on the card gives the plain ``cumsum`` lines' result bitwise.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import torch

from ..config import PoseGraphConfig
from ..device import const
from ..ops import link_scan_cuda, se3
from ..ops.se3 import Pose
from ..ops.segments import EAGER

# CG iterations a chunk runs between two host reads of the stop flag (the
# fastest of those chip_smoke times on the loop lap's first closure).
CHUNK = 2


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
    """A new store with the factor appended at slot ``count``, or with
    ``dropped`` counted when the store is full (``i``, ``j`` and
    ``variance`` may be tensors on the store's device)."""
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
    """Batched A v for (..., 6, 6) @ (..., 6)."""
    return (A @ v[..., None])[..., 0]


def _mtv(A, v):
    """Batched Aᵀ v."""
    return (A.transpose(-1, -2) @ v[..., None])[..., 0]


class _Graph(NamedTuple):
    """What the GN steps of one solve share."""

    node_ok: torch.Tensor    # (M,) bool
    n: torch.Tensor          # () int32 nodes: node_ok's count
    chain_ok: torch.Tensor   # (M,) bool: a chain factor ends at node m
    Wrow: torch.Tensor       # (M, 6) chain weights, the prior on row 0
    Winv_row: torch.Tensor
    li: torch.Tensor         # (L,) int64 loop endpoints
    lj: torch.Tensor
    l_lo: torch.Tensor
    l_hi: torch.Tensor
    sgn: torch.Tensor        # (L,)
    wl6: torch.Tensor        # (L, 6) loop weights, 0 for an invalid slot
    in_range: torch.Tensor   # (M, L) lo_l < m <= hi_l
    Z_R: torch.Tensor        # (L, 3, 3) loop measurements
    Z_t: torch.Tensor
    prior_R: torch.Tensor    # node 0's prior, as the solve started
    prior_t: torch.Tensor


class _Lin(NamedTuple):
    """One GN step's linearisation: B = Ad(x⁻¹) per node, its exact
    inverse and the loops' B_l."""

    B: torch.Tensor
    B_inv: torch.Tensor
    B_l: torch.Tensor
    b2: torch.Tensor         # ||b||² of the right-hand side b = -g


class _Pcg(NamedTuple):
    x: torch.Tensor
    rr: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    i: torch.Tensor          # () int32 iterations run
    stop: torch.Tensor       # () bool


def optimize(R, t, n_nodes, chain_R, chain_t, loops: LoopFactors,
             prior: Pose, cfg: PoseGraphConfig, chunk: int | None = None,
             rt=EAGER) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full GN re-solve in link space.  R/t: (M, 3, 3)/(M, 3) node
    estimates (rows >= n_nodes inert); chain_R/chain_t: (M, ...) between
    measurements from node k-1 to k (row 0 unused); ``prior`` anchors node
    0.  Returns updated (R, t).  ``cfg.gn_iters`` GN steps, each CG solve
    in chunks of ``chunk`` (default ``CHUNK``) iterations.  ``rt``: the
    segment runner (a graph runner writes each step's update into ``R``
    and ``t``), which tallies each GN step's CG iterations (``cg_iters``)
    once its stop flag is read."""
    chunk = chunk or CHUNK
    G = rt.seg(("pg", "graph", cfg), partial(_setup, cfg=cfg), R, n_nodes,
               loops, prior)
    for _ in range(cfg.gn_iters):
        lin, pcg = rt.seg(("pg", "linearize", cfg),
                          partial(_linearize, cfg=cfg), G, R, t, chain_R,
                          chain_t)
        while True:
            pcg = rt.seg(("pg", "pcg", chunk, cfg),
                         partial(_pcg_iterate, n=chunk, cfg=cfg), pcg, G,
                         lin, into=pcg)
            if rt.read(pcg.stop, "CG stop"):
                break
        rt.tally("cg_iters", pcg.i)
        R, t = rt.seg(("pg", "update"), _update, G, R, t, pcg, into=(R, t))
    return R, t


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
    return _Graph(node_ok=node_ok, n=torch.sum(node_ok, dtype=torch.int32),
                  chain_ok=chain_ok, Wrow=Wrow,
                  Winv_row=Winv_row, li=li, lj=lj, l_lo=l_lo, l_hi=l_hi,
                  sgn=sgn, wl6=wl6, in_range=in_range, Z_R=loops.R.clone(),
                  Z_t=loops.t.clone(), prior_R=prior.R.clone(),
                  prior_t=prior.t.clone())


def _precond(G: _Graph, lin: _Lin, v):
    return torch.where(G.node_ok[:, None],
                       _mv(lin.B_inv, G.Winv_row * _mtv(lin.B_inv, v)), v)


def _hvp(G: _Graph, lin: _Lin, v):
    out = _mtv(lin.B, G.Wrow * _mv(lin.B, v))                   # D v
    S = link_scan_cuda.link_scan_ranges(v, G.node_ok, G.n, G.l_lo,
                                        G.l_hi)                 # (L, 6)
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


def _pcg_iterate(pcg: _Pcg, G: _Graph, lin: _Lin, n: int,
                 cfg: PoseGraphConfig) -> _Pcg:
    """``n`` CG iterations, each a no-op once ``stop`` is set."""
    for _ in range(n):
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
        more = (i < cfg.pcg_iters) & (torch.sum(rr * rr)
                                      > cfg.pcg_tol * lin.b2)
        pcg = _Pcg(x=torch.where(active, x, pcg.x),
                   rr=torch.where(active, rr, pcg.rr),
                   p=torch.where(active, p, pcg.p),
                   rz=torch.where(active, rz_new, pcg.rz), i=i,
                   stop=pcg.stop | (active & ~more))
    return pcg


def _update(G: _Graph, R, t, pcg: _Pcg):
    """Links -> nodes (v = cumsum u) and the left-multiplicative update."""
    v = link_scan_cuda.link_scan(pcg.x, G.node_ok, G.n)
    upd = se3.se3_exp(v)
    return upd.R @ R, se3.rotate_vec(upd.R, t) + upd.t
