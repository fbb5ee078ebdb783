"""Loop-closure factor store (the state half of
``legoloam_tpu/models/posegraph.py``; the link-space solver is not ported
yet).  ``SlamState`` carries it so the state matches the JAX package's field
for field."""

from __future__ import annotations

from typing import NamedTuple

import torch


class LoopFactors(NamedTuple):
    """Fixed-cap loop-closure between-factors: measurement Z = T_i⁻¹ T_j."""

    i: torch.Tensor        # (L,) int32 from-node
    j: torch.Tensor        # (L,) int32 to-node
    R: torch.Tensor        # (L, 3, 3)
    t: torch.Tensor        # (L, 3)
    var: torch.Tensor      # (L,) isotropic variance
    valid: torch.Tensor    # (L,) bool
    count: torch.Tensor    # () int32
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
