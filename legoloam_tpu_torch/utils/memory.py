"""Memory accounting for the SLAM state (port of
``legoloam_tpu/utils/memory.py``).

The budget is tallied from shapes alone: the state constructors run on
PyTorch's ``meta`` device, which allocates nothing, and each field's bytes
follow from ``numel × itemsize``.  This is exact for the persistent state
(dense, fixed-shape tensors updated in place); transient workspace is not
covered.  On the card, ``measured`` reads the caching allocator's own
counts (``torch.cuda.memory_stats``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for v in tree:
            yield from _leaves(v)


def tree_bytes(tree) -> int:
    """Total bytes of a NamedTuple tree of tensors (meta tensors too)."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def slam_state_bytes(cfg) -> Dict[str, int]:
    """Byte budget of the single-device ``pipeline.SlamState`` for
    ``cfg``, built on the meta device without allocating."""
    from ..models import pipeline

    shapes = pipeline.init_slam_state(cfg, device="meta")
    out = {
        "odom": tree_bytes(shapes.odom),
        "loops": tree_bytes(shapes.loops),
        "kf_store": tree_bytes(shapes.mapping.kf),
        "submap_cache": tree_bytes(shapes.mapping.cache),
    }
    out["total"] = tree_bytes(shapes)
    return out


def dist_state_bytes(cfg, n_devices: int) -> Dict[str, int]:
    """PER-SHARD byte budget of the JAX package's distributed state on an
    ``n_devices`` mesh (``legoloam_tpu/parallel/pipeline_dist.py``):
    keyframe clouds sharded on the keyframe axis, everything else (poses,
    chain, odometry state, loop factors) replicated.  The port's
    distributed path is not written yet; this is the budget it inherits."""
    from ..models import odometry, posegraph

    m = cfg.mapping.max_keyframes
    f32 = 4
    sharded_clouds = (
        m * cfg.mapping.scan_corner_cap * (3 * f32 + 1)     # corner + valid
        + m * cfg.mapping.scan_surf_cap * (3 * f32 + 1))    # surf + valid
    replicated_poses = (
        m * (9 + 3 + 9 + 3) * f32   # R, t, chain_R, chain_t
        + m * f32                   # time
        + 8)                        # count + overflow
    out = {
        "kf_clouds_per_shard": math.ceil(sharded_clouds / n_devices),
        "kf_poses_replicated": replicated_poses,
        "odom_replicated": tree_bytes(
            odometry.init_state(cfg.odom, cfg.feat, "meta")),
        "loops_replicated": tree_bytes(posegraph.init_loop_factors(
            cfg.posegraph.max_loop_factors, "meta")),
    }
    out["per_shard_total"] = sum(out.values())
    return out


def measured(device=None) -> Dict[str, int]:
    """The caching allocator's current and peak allocated bytes on a CUDA
    device (``torch.cuda.memory_stats``)."""
    stats = torch.cuda.memory_stats(device)
    return {"allocated": stats.get("allocated_bytes.all.current", 0),
            "peak": stats.get("allocated_bytes.all.peak", 0)}


def fmt_gib(n: int) -> str:
    return f"{n / 2**30:.3f} GiB"


def summary(cfg, n_devices: int | None = None) -> str:
    """Human-readable budget block."""
    lines = []
    b = slam_state_bytes(cfg)
    lines.append(
        f"[mem] single-device state {fmt_gib(b['total'])} "
        f"(kf store {fmt_gib(b['kf_store'])}, submap cache "
        f"{fmt_gib(b['submap_cache'])}, odom {fmt_gib(b['odom'])})")
    if n_devices:
        d = dist_state_bytes(cfg, n_devices)
        lines.append(
            f"[mem] per-shard on a {n_devices}-device mesh "
            f"{fmt_gib(d['per_shard_total'])} "
            f"(sharded clouds {fmt_gib(d['kf_clouds_per_shard'])}, "
            f"replicated poses {fmt_gib(d['kf_poses_replicated'])})")
    return "\n".join(lines)
