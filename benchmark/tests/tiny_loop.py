"""A tiny loop-closure cell for the CPU tests: ``tiny.py``'s 16 x 360
sensor and small caps with LeGO-LOAM's loop closure on, cut so that a
closure comes within a few dozen scans.

Cut for the tests only, each for a reason:

  * ``loop.min_time_gap`` 1.0 s (30 s in the source): a keyframe one
    second old is a candidate, so an attempt closes on the ring's first
    metres instead of after a lap;
  * ``loop.fitness_thresh`` 2.0 (0.3): the tiny sensor's 1-degree columns
    leave a mean squared NN distance near 0.8-0.9 m² between two
    keyframes' clouds;
  * ``loop.cadence`` 0.5 s: an attempt every 5 scans;
  * the ring's ``radius`` 2 m and ``angular_rate`` 0.15 rad a scan (30 m
    and 0.009: 0.3 m a scan either way): a lap of 42 scans inside the
    ring world's lane-free middle, so the program's warm-up (a lap and 6
    attempts) stays short and every keyframe lies within the 7 m search
    radius;
  * ``mapping.max_keyframes`` 128: the store never nears the saturation
    guard's margin, as in the benchmark's cell (the reference steps no
    decimation).
"""

from __future__ import annotations

from benchmark.tests import tiny

LOOP_TRAFFIC = {**tiny.TRAFFIC, "program": "slam_loop",
                "radius": 2.0, "angular_rate": 0.15, "start_scans": 6, "segments": 2,
                "segment_scans": 6, "sample_below": 60, "trace_from": 24,
                "trace_scans": 3, "chunk": 16, "decimate_every": 100,
                "decimate_margin": 48}


def loop_pipeline(min_time_gap: float = 1.0, cadence: float = 0.5) -> dict:
    """``tiny.tiny_pipeline()`` with loop closure on (the ``recent``
    submap, the plain sweeps to their fixpoint) and the cuts above."""
    d = tiny.tiny_pipeline()
    d["loop"].update(enabled=True, min_time_gap=min_time_gap,
                     cadence=cadence, fitness_thresh=2.0, cur_cap=1024,
                     hist_cap=2048)
    d["mapping"].update(submap_mode="recent", max_keyframes=128)
    d["posegraph"]["max_loop_factors"] = 32
    d["seg"]["ccl_max_iters"] = 16 * 360
    return d
