"""Kernel K5: the pose graph's link-axis prefix sum.

Replaces no Pallas kernel: the JAX package's link-space solver takes
``jnp.cumsum`` over the (M, 6) link array
(``legoloam_tpu/models/posegraph.py:220,230,270``), and the port carried it
over as ``torch.cumsum(., dim=0)`` (``models/posegraph.py``).  On the card
that is PyTorch's outer-dimension scan, one thread a column walking every
row of the store, ~0.5 ms a call at M = 4096, once a CG iteration and once a
GN step; the kernel (``csrc/link_scan.cu``) stages the filled rows through
shared memory and sums each column there, a few microseconds.

Contract, shared with the plain lines (the CPU path here): with ``ok`` the
node mask (rows below the node count ``n``),

  * ``link_scan(v, ok, n)`` is ``where(ok, cumsum(where(ok, v, 0)), 0)``;
  * ``link_scan_ranges(v, ok, n, lo, hi)`` is ``Q[hi] - Q[lo]`` with
    ``Q = cumsum(where(ok, v, 0))``.

On the card the kernel returns the plain lines' result bitwise: it adds
each column in row order in float32 from 0.0, as CUDA's ``torch.cumsum``
does, reads ``n`` (int32, on the device) rather than the mask, and fills
the rows from ``n`` on as the plain scan of masked zeros leaves them.
Endpoints are node indices in [0, M); one at or past ``n`` reads that tail.

Bound: bytes, the rows read once and the result written once
(``bytes_moved``); the kernel is held instead by its chain of dependent
adds, one a row in each column.
"""

from __future__ import annotations

import torch

from . import _native

KERNEL = _native.register(
    "link_scan", "legoloam_tpu_torch/csrc/link_scan.cu",
    "none: legoloam_tpu/models/posegraph.py:220,230,270 cumsum is jnp")

COLS = 6        # a link's twist; fixed in csrc/link_scan.cu
TILE = 512      # rows a shared-memory tile; fixed in csrc/link_scan.cu
GROUP = 16      # rows a scan lane loads ahead, the last tile padded to
                # whole groups; fixed in csrc/link_scan.cu
THREADS = 512   # the one block's threads; fixed in csrc/link_scan.cu


def bytes_moved(m: int, n: int, loops: int | None = None) -> int:
    """Bytes the contract needs: the ``n`` filled rows read once, the node
    count, and the (M, 6) result written once, or for the ranges entry the
    two int64 endpoints and the (L, 6) result of each of ``loops`` slots."""
    read = 4 * COLS * n + 4
    if loops is None:
        return read + 4 * COLS * m
    return read + loops * (16 + 4 * COLS)


def _inputs(v, n):
    m = v.shape[0] if v.dim() == 2 else 0
    _native.require(v.dtype == torch.float32 and v.dim() == 2
                    and v.shape[1] == COLS and m >= 1,
                    f"link_scan: v must be float32 (M >= 1, {COLS})")
    _native.require(n.dtype == torch.int32 and n.numel() == 1,
                    "link_scan: n must be one int32 on the device")
    _native.require(m * COLS < 2 ** 31, "link_scan: M x 6 must fit in int32")
    v = v.contiguous()
    _native.require_cuda(v, n)
    return v, m


def link_scan_plain(v: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """``link_scan``'s plain lines."""
    return torch.where(ok[:, None], torch.cumsum(
        torch.where(ok[:, None], v, 0.0), dim=0), 0.0)


def link_scan_ranges_plain(v: torch.Tensor, ok: torch.Tensor,
                           lo: torch.Tensor, hi: torch.Tensor
                           ) -> torch.Tensor:
    """``link_scan_ranges``' plain lines."""
    Qv = torch.cumsum(torch.where(ok[:, None], v, 0.0), dim=0)
    return Qv[hi] - Qv[lo]


def link_scan(v: torch.Tensor, ok: torch.Tensor, n: torch.Tensor
              ) -> torch.Tensor:
    """(M, 6): the running sums of ``v``'s rows below ``n``, 0 from ``n``
    on.

    CPU tensors take the plain lines; CUDA tensors launch
    ``link_scan_rows`` (or raise)."""
    if v.device.type == "cpu":
        return link_scan_plain(v, ok)
    v, m = _inputs(v, n)
    out = torch.empty_like(v)
    err = _native.library().link_scan_rows_launch(
        v.data_ptr(), n.data_ptr(), out.data_ptr(), m,
        _native.stream_handle(v))
    _native.check(err, "link_scan")
    KERNEL.launches += 1
    return out


def link_scan_ranges(v: torch.Tensor, ok: torch.Tensor, n: torch.Tensor,
                     lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(L, 6): the sums of ``v``'s rows in (lo_l, hi_l] below ``n``, as the
    difference of two running sums.

    CPU tensors take the plain lines; CUDA tensors launch
    ``link_scan_ranges`` (or raise)."""
    if v.device.type == "cpu":
        return link_scan_ranges_plain(v, ok, lo, hi)
    v, m = _inputs(v, n)
    l_n = lo.shape[0]
    _native.require(lo.dtype == torch.int64 and hi.dtype == torch.int64
                    and lo.shape == (l_n,) and hi.shape == (l_n,)
                    and l_n >= 1 and l_n * COLS < 2 ** 31,
                    "link_scan_ranges: lo and hi int64 (L,), L >= 1")
    lo, hi = lo.contiguous(), hi.contiguous()
    _native.require_cuda(v, lo, hi)
    q = torch.empty_like(v)
    out = torch.empty((l_n, COLS), dtype=torch.float32, device=v.device)
    err = _native.library().link_scan_ranges_launch(
        v.data_ptr(), n.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        q.data_ptr(), out.data_ptr(), m, l_n, _native.stream_handle(v))
    _native.check(err, "link_scan_ranges")
    KERNEL.launches += 1
    return out
