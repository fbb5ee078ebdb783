"""Per-step cost accounting for the distributed SLAM loop.

Everything here is host-computable from static shapes (config + mesh size):
collective payload bytes per distributed mapping step, per-shard work rows,
and the single-device equivalents — so the mesh-vs-single step composition
is a printed number, not an asserted claim (PERF.md "Multi-chip cost
accounting"; VERDICT r2 item 7).

Conventions: payloads are BYTES MOVED PER DEVICE per mapping step (the ICI
bisection view: an ``all_gather`` of per-shard payload ``p`` over ``n``
devices moves ``(n-1)*p`` inbound per device; a ``psum`` of payload ``p``
costs ``~2p`` in a ring reduce-scatter + all-gather).
"""

from __future__ import annotations

from ..config import MappingConfig

F32 = 4
BOOL = 1


def _submap_caps(cfg: MappingConfig, n_dev: int):
    c_cap = max(cfg.submap_corner_cap // n_dev, cfg.scan_corner_cap)
    s_cap = max(cfg.submap_surf_cap // n_dev, cfg.scan_surf_cap)
    return c_cap, s_cap


def dist_mapping_step_cost(cfg: MappingConfig, n_dev: int,
                           lm_iters: int | None = None) -> dict:
    """Collective bytes + work rows for ONE distributed mapping step."""
    if lm_iters is None:
        lm_iters = cfg.max_iterations
    c_cap, s_cap = _submap_caps(cfg, n_dev)
    n_sel = min(cfg.search_num, cfg.max_keyframes)
    own_cap = min(n_sel, max(1, 2 * (-(-n_sel // n_dev))))

    # extract_submap_dist: per-shard submap payload, all_gathered.
    per_shard_submap = (c_cap + s_cap) * (3 * F32 + BOOL)
    submap_allgather = (n_dev - 1) * per_shard_submap

    # scan_to_map_sharded: per LM iteration psum of AtA (6x6) + AtB (6)
    # + 2 counts, for corner and surf jointly (one reduce set).
    per_iter_psum = (36 + 6 + 2) * F32
    lm_psum = 2 * per_iter_psum * lm_iters

    # Per-shard work rows (the sort-dominated voxelize + the kNN row count).
    gather_rows = own_cap * (cfg.scan_corner_cap + cfg.scan_surf_cap)
    lm_rows = -(-(cfg.scan_corner_cap + cfg.scan_surf_cap) // n_dev)

    return {
        "n_dev": n_dev,
        "submap_allgather_bytes": submap_allgather,
        "lm_psum_bytes": lm_psum,
        "total_collective_bytes": submap_allgather + lm_psum,
        "per_shard_gather_rows": gather_rows,
        "per_shard_voxel_rows": gather_rows,          # sorted once per channel set
        "per_shard_lm_residual_rows": lm_rows,
        "replicated_submap_rows": n_dev * (c_cap + s_cap),
        "own_cap_keyframes": own_cap,
    }


def single_mapping_step_cost(cfg: MappingConfig) -> dict:
    """Single-device equivalents (incremental-cache fast path)."""
    # Incremental merge sorts cache + one scan's rows.
    merge_rows = (cfg.submap_corner_cap + cfg.scan_corner_cap
                  + cfg.submap_surf_cap + cfg.scan_surf_cap)
    return {
        "n_dev": 1,
        "total_collective_bytes": 0,
        "incremental_merge_rows": merge_rows,
        "rebuild_rows": min(cfg.search_num, cfg.max_keyframes)
        * (cfg.scan_corner_cap + cfg.scan_surf_cap),
        "lm_residual_rows": cfg.scan_corner_cap + cfg.scan_surf_cap,
    }


def loop_closure_gather_cost(cfg_loop, cfg_map: MappingConfig,
                             n_dev: int) -> dict:
    """gather_keyframe_clouds masked-psum: K window keyframes x cloud caps.
    Each device contributes its owned rows (zeros elsewhere); one psum sums
    them — ring cost ~2x the payload per device."""
    k = 2 * cfg_loop.history_num + 1
    payload = k * (cfg_map.scan_corner_cap + cfg_map.scan_surf_cap) \
        * (3 * F32 + BOOL)
    return {"window_keyframes": k, "psum_payload_bytes": payload,
            "psum_bytes_per_device": 2 * payload}
