"""Kernel K4: the odometry's class-windowed nearest-neighbour search.

Replaces no Pallas kernel: the JAX package's ``class_nn``
(``legoloam_tpu/ops/voxel.py:199``) is ``jnp``, a (512 x R) distance matrix a
query tile with a penalty and an argmin a class, and the port carried it over
as plain PyTorch (``voxel.class_nn``).  At VLS-128 that form moved ~220 GB a
scan through device memory and took most of the step; the kernel
(``csrc/class_nn.cu``) keeps every (query, reference) value in registers.

Contract, shared with the plain version (``voxel.class_nn``): for class c and
query q, the nearest reference with ``key_lo[c, q] <= ref_key <= key_hi[c, q]``
and squared distance > ``excl_le[c, q]``, as the plain version computes it:
the distance in matrix form (``q_sq - 2 q.r + r_sq``, invalid references moved
to 1e6), a 1e30 penalty outside the class, the minimum with ties to the lower
index, clamped at 0.  On the card the kernel returns the plain version's
(d, i) bitwise; ``q_tile`` (the plain version's query tiling) does not change
the result and the kernel ignores it.

Bound: operations.  A pair whose key lies in a class window of its query
needs its distance (9 float32 operations: the K = 3 dot as a matrix product
counts it, 2K, then the doubling, the difference and the sum) and, per such
class, the exclusion and the running minimum's compares (2); ``needed_ops``
counts them.
"""

from __future__ import annotations

import torch

from . import _native
from . import voxel

KERNEL = _native.register(
    "class_nn", "legoloam_tpu_torch/csrc/class_nn.cu",
    "none: legoloam_tpu/ops/voxel.py:199 class_nn is jnp")

TQ = 512            # queries per tile; fixed in csrc/class_nn.cu
RC = 64             # references per chunk; fixed in csrc/class_nn.cu
BLOCKS_PER_SM = 4   # the kernel's __launch_bounds__ minimum
MAX_SPLITS = 64
MAX_CLASSES = 2


def splits(q_n: int, r_n: int, n_sm: int) -> int:
    """Splits of each query tile's chunks of references on ``n_sm`` SMs:
    enough (tile, split) blocks for ``BLOCKS_PER_SM`` an SM, at most one a
    chunk, at most ``MAX_SPLITS`` partials to merge."""
    tiles = -(-q_n // TQ)
    want = -(-n_sm * BLOCKS_PER_SM // tiles)
    return max(1, min(want, -(-r_n // RC), MAX_SPLITS))


def needed_ops(ref_key, key_lo, key_hi, n_classes: int = 1,
               q_block: int = 1024) -> int:
    """Float32 operations the contract needs for these inputs: 9 for each
    (query, reference) pair whose key lies in a class window of the query,
    2 more for each such class.  The yardstick of K4's bound."""
    pairs = classes = 0
    for s in range(0, key_lo.shape[1], q_block):
        inside = [(ref_key[None, :] >= key_lo[c, s:s + q_block, None])
                  & (ref_key[None, :] <= key_hi[c, s:s + q_block, None])
                  for c in range(n_classes)]
        any_in = inside[0]
        for m in inside[1:]:
            any_in = any_in | m
        pairs += int(any_in.sum())
        classes += sum(int(m.sum()) for m in inside)
    return 9 * pairs + 2 * classes


def class_nn(query, ref, r_valid, ref_key, key_lo, key_hi, excl_le,
             q_tile: int = 512, n_classes: int = 1):
    """(sq_dists (C, Q) float32, indices (C, Q) int64), C = ``n_classes``.

    CPU tensors take the plain version (``voxel.class_nn``); CUDA tensors
    launch ``csrc/class_nn.cu`` (or raise)."""
    if query.device.type == "cpu":
        return voxel.class_nn(query, ref, r_valid, ref_key, key_lo, key_hi,
                              excl_le, q_tile=q_tile, n_classes=n_classes)
    q_n, r_n = query.shape[0], ref.shape[0]
    _native.require(1 <= n_classes <= MAX_CLASSES,
                    f"class_nn: n_classes must be in [1, {MAX_CLASSES}]")
    _native.require(q_n >= 1 and r_n >= 1,
                    "class_nn: at least one query and one reference")
    _native.require(all(t.dtype == torch.float32 for t in (
        query, ref, ref_key, key_lo, key_hi, excl_le)),
        "class_nn: float32 points, keys and class bounds")
    _native.require(r_valid.dtype == torch.bool, "class_nn: bool validity")
    _native.require(query.shape == (q_n, 3) and ref.shape == (r_n, 3)
                    and r_valid.shape == (r_n,) and ref_key.shape == (r_n,)
                    and all(t.dim() == 2 and t.shape[0] >= n_classes
                            and t.shape[1] == q_n
                            for t in (key_lo, key_hi, excl_le)),
                    "class_nn: query (Q, 3), ref (R, 3), r_valid and "
                    "ref_key (R,), class bounds (>= n_classes, Q)")
    # The plain version's O(Q + R) preparation, op for op.
    ref_m = torch.where(r_valid[:, None], ref, torch.full_like(ref, 1e6))
    r_sq = torch.sum(ref_m * ref_m, dim=-1)
    q_sq = torch.sum(query * query, dim=-1)
    q = query.contiguous()
    key = ref_key.contiguous()
    lo, hi, ex = (t[:n_classes].contiguous()
                  for t in (key_lo, key_hi, excl_le))
    _native.require_cuda(q, q_sq, ref_m, r_sq, key, lo, hi, ex)
    s = splits(q_n, r_n, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    chunks = torch.empty(3 * (-(-r_n // RC)), dtype=torch.float32,
                         device=q.device)
    part_d = torch.empty((s, n_classes, q_n), dtype=torch.float32,
                         device=q.device)
    part_i = torch.empty((s, n_classes, q_n), dtype=torch.int32,
                         device=q.device)
    d = torch.empty((n_classes, q_n), dtype=torch.float32, device=q.device)
    i = torch.empty((n_classes, q_n), dtype=torch.int64, device=q.device)
    err = _native.library().class_nn_launch(
        q.data_ptr(), q_sq.data_ptr(), ref_m.data_ptr(), r_sq.data_ptr(),
        key.data_ptr(), lo.data_ptr(), hi.data_ptr(), ex.data_ptr(),
        chunks.data_ptr(), part_d.data_ptr(), part_i.data_ptr(), d.data_ptr(),
        i.data_ptr(), q_n, r_n, n_classes, s, _native.stream_handle(q))
    _native.check(err, "class_nn")
    KERNEL.launches += 1
    return d, i
