"""Kernel K1: connected-component labelling of the range-image seed mask.

Replaces the Pallas kernel ``legoloam_tpu/ops/ccl_pallas.py::_ccl_kernel``
(wrapper ``label_propagation_pallas``).  Output contract, shared by the CUDA
kernel (``csrc/ccl.cu``) and the plain PyTorch version below:

  * ``labels`` (N, H) int32: each seed cell's component root = the
    component's minimum flat index; non-seed cells get ``N*H``;
  * ``ring_min`` = ``labels // H`` (non-seeds: N);
  * ``ring_max`` (N, H) int32: the component's maximum ring (non-seeds: -1).

A batch of scans, (B, N, H), is labelled scan by scan in one call (the
kernel's three launches, or one plain sweep loop): a label is the minimum
flat index within its scan's (N, H) image, and no component crosses a scan.

Components are 4-connected under ``conn_h`` (cell (r, c) to (r, (c+1) % H),
column wrap included) and ``conn_v`` (cell (r, c) to (r+1, c)), gated by the
seed mask at both ends.

The plain version is the JAX package's XLA path: alternating segmented
min-scans swept to a fixpoint, at most ``max_iters`` sweeps, then one
pointer-jump compression, with the ring extrema from segment reductions.
The CUDA kernel is a union-find, which always reaches the fixpoint and
ignores ``max_iters``; the two agree wherever the sweeps converge within the
cap.  On VLP-16 ring scans the sweeps need 15 to 54 (the first 64 scans of
one H100-cast run: 26 of them over the DEFAULT cap of 32, and on one of
those the capped labels differ after the pointer jumps while K1's equal the
fixpoint's), so where the plain path must equal K1 the cap is N * H.  A batch
sweeps until every scan is at its fixpoint or the cap is hit, which gives
each scan what it gets alone: a sweep at a scan's fixpoint changes nothing
(the JAX package's vmap of its while_loop runs the same way).
"""

from __future__ import annotations

import torch

from . import _native

KERNEL = _native.register(
    "ccl", "legoloam_tpu_torch/csrc/ccl.cu",
    "legoloam_tpu/ops/ccl_pallas.py:50")


def _shift_back(a: torch.Tensor, d: int, dim: int, fill) -> torch.Tensor:
    """out[i] = a[i - d] along ``dim`` (constant fill for i < d)."""
    head = a.narrow(dim, 0, a.shape[dim] - d)
    pad_shape = list(a.shape)
    pad_shape[dim] = d
    pad = torch.full(pad_shape, fill, dtype=a.dtype, device=a.device)
    return torch.cat([pad, head], dim=dim)


def _seg_min_scan(labels: torch.Tensor, boundary: torch.Tensor, dim: int,
                  reverse: bool) -> torch.Tensor:
    """Segmented running-min along ``dim`` (``boundary`` starts a new run):
    the unique result of the associative scan with combine
    (v, g)·(v', g') = (g' ? v' : min(v, v'), g | g'), by Hillis-Steele
    doubling."""
    if reverse:
        labels = torch.flip(labels, (dim,))
        boundary = torch.flip(boundary, (dim,))
    v, g = labels, boundary
    size = v.shape[dim]
    d = 1
    while d < size:
        v_prev = _shift_back(v, d, dim, torch.iinfo(v.dtype).max)
        g_prev = _shift_back(g, d, dim, False)
        v = torch.where(g, v, torch.minimum(v_prev, v))
        g = g | g_prev
        d *= 2
    return torch.flip(v, (dim,)) if reverse else v


def label_propagation_plain(seed_mask, conn_h, conn_v, max_iters: int):
    """Plain PyTorch version, on (N, H) masks or a batch (B, N, H).
    Returns (labels, ring_min, ring_max, sweeps), ``sweeps`` being the
    number of sweeps run (a Python int; a batch's largest)."""
    shape = seed_mask.shape
    n, h = shape[-2:]
    seed_mask, conn_h, conn_v = (t.reshape(-1, *t.shape[-2:])
                                 for t in (seed_mask, conn_h, conn_v))
    b = seed_mask.shape[0]
    n_cells = n * h
    dev = seed_mask.device
    big = n_cells
    flat_ids = torch.arange(n_cells, dtype=torch.int32, device=dev)
    labels = torch.where(seed_mask, flat_ids.reshape(n, h),
                         torch.full((n, h), big, dtype=torch.int32,
                                    device=dev))
    conn_h = conn_h & seed_mask & torch.roll(seed_mask, -1, -1)
    conn_v = conn_v & seed_mask[:, :-1] & seed_mask[:, 1:]
    rbf = ~torch.roll(conn_h, 1, -1)
    rbr = ~conn_h
    rbf2 = torch.cat([rbf, rbf], dim=-1)
    rbr2 = torch.cat([rbr, rbr], dim=-1)
    ones = torch.ones((b, 1, h), dtype=torch.bool, device=dev)
    cbf = torch.cat([ones, ~conn_v], dim=-2)
    cbr = torch.cat([~conn_v, ones], dim=-2)

    def sweep(lab):
        lab2 = torch.cat([lab, lab], dim=-1)
        fwd = _seg_min_scan(lab2, rbf2, -1, False)[..., h:]
        bwd = _seg_min_scan(lab2, rbr2, -1, True)[..., :h]
        lab = torch.minimum(fwd, bwd)
        down = _seg_min_scan(lab, cbf, -2, False)
        up = _seg_min_scan(lab, cbr, -2, True)
        return torch.minimum(down, up)

    # Same loop as the JAX while_loop: a first sweep, then sweep while the
    # labels changed and fewer than max_iters sweeps ran.
    labels = sweep(labels)
    sweeps, changed = 1, True
    while changed and sweeps < max_iters:
        new = sweep(labels)
        changed = bool(torch.any(new != labels))
        labels, sweeps = new, sweeps + 1

    # Pointer jumps and the ring extrema over each label class (the JAX XLA
    # path's segment reductions) on each scan's (N*H + 1) cells, read back
    # per cell.
    tail = torch.full((b, 1), big, dtype=torch.int32, device=dev)
    flat = torch.cat([labels.reshape(b, -1), tail], dim=1)
    flat = torch.gather(flat, 1, flat[:, :n_cells].long())
    flat = torch.gather(torch.cat([flat, tail], dim=1), 1, flat.long())
    labels = flat[:, :n_cells]
    seeds = seed_mask.reshape(b, -1)
    ring_of = torch.div(flat_ids, h, rounding_mode="floor").expand(b, -1)
    idx = labels.long()
    rmin = torch.full((b, n_cells + 1), n, dtype=torch.int32, device=dev)
    rmin.scatter_reduce_(1, idx, torch.where(seeds, ring_of,
                                             torch.full_like(ring_of, n)),
                         "amin", include_self=True)
    rmax = torch.full((b, n_cells + 1), -1, dtype=torch.int32, device=dev)
    rmax.scatter_reduce_(1, idx, torch.where(seeds, ring_of,
                                             torch.full_like(ring_of, -1)),
                         "amax", include_self=True)
    return (labels.reshape(shape), torch.gather(rmin, 1, idx).reshape(shape),
            torch.gather(rmax, 1, idx).reshape(shape), sweeps)


def label_propagation(seed_mask: torch.Tensor, conn_h: torch.Tensor,
                      conn_v: torch.Tensor, max_iters: int):
    """Connected components + ring extrema: (labels, ring_min, ring_max),
    of (N, H) masks or of a batch of scans (B, N, H) in one call.

    CPU tensors take the plain version; CUDA tensors launch ``csrc/ccl.cu``
    once for the whole batch (or raise)."""
    if seed_mask.device.type == "cpu":
        return label_propagation_plain(seed_mask, conn_h, conn_v,
                                       max_iters)[:3]
    _native.require(seed_mask.dim() in (2, 3), "ccl: (N, H) or (B, N, H)")
    *lead, n, h = seed_mask.shape
    b = lead[0] if lead else 1
    _native.require(seed_mask.dtype == torch.bool and conn_h.dtype
                    == torch.bool and conn_v.dtype == torch.bool,
                    "ccl: masks must be bool")
    _native.require(tuple(conn_h.shape) == (*lead, n, h)
                    and tuple(conn_v.shape) == (*lead, n - 1, h),
                    "ccl: conn_h must be (..., N, H) and conn_v (..., N-1, H)")
    _native.require(b <= 65535, "ccl: at most 65535 scans a launch")
    seed_mask, conn_h, conn_v = (t.contiguous() for t in
                                 (seed_mask, conn_h, conn_v))
    _native.require_cuda(seed_mask, conn_h, conn_v)
    lib = _native.library()
    opts = dict(dtype=torch.int32, device=seed_mask.device)
    parent = torch.empty(b * n * h, **opts)
    rmax_root = torch.empty(b * n * h, **opts)
    labels = torch.empty(seed_mask.shape, **opts)
    ring_min = torch.empty(seed_mask.shape, **opts)
    ring_max = torch.empty(seed_mask.shape, **opts)
    err = lib.ccl_launch(
        seed_mask.data_ptr(), conn_h.data_ptr(), conn_v.data_ptr(),
        parent.data_ptr(), labels.data_ptr(), ring_min.data_ptr(),
        ring_max.data_ptr(), rmax_root.data_ptr(), b, n, h,
        _native.stream_handle(seed_mask))
    _native.check(err, "ccl")
    KERNEL.launches += 1
    return labels, ring_min, ring_max
