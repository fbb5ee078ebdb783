"""A tiny cell for the CPU tests: a 16 x 360 sensor with small caps, a few
scans a window, written as new files beside copies of the benchmark's
own, so that the harness finds them by name alone."""

from __future__ import annotations

import copy
import dataclasses
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TRAFFIC = {"driver": "closed", "program": "slam", "world": "ring",
           "radius": 30.0, "height": 0.8, "angular_rate": 0.009,
           "motion": True, "noise_sigma": 0.02, "chunk": 8,
           "decimate_every": 4, "decimate_margin": 2, "start_scans": 3,
           "segments": 1, "segment_scans": 3, "sample_below": 12,
           "trace_from": 3, "trace_scans": 3, "cast_batch": 4,
           "preroll_seconds": 0.5}
LIMITS = {"pose_gap_m": 1e-4, "rot_gap": 1e-4, "state_gap": 1e-4,
          "state_mismatch": 0}
METRIC = '''"""Scans stepped in the window (a metric added as a file)."""


def read(ctx):
    return float(ctx.rec.scans)
'''


def tiny_pipeline() -> dict:
    from benchmark.reference import config as rc
    cfg = rc.PipelineConfig()
    cfg = cfg.replace(
        sensor=dataclasses.replace(cfg.sensor, name="tiny", horizon_scan=360,
                                   ang_res_x_deg=1.0),
        feat=dataclasses.replace(cfg.feat, max_sharp=128, max_less_sharp=512,
                                 max_flat=256, max_less_flat=1024,
                                 max_outlier=512),
        mapping=dataclasses.replace(
            cfg.mapping, max_keyframes=16, submap_corner_cap=1024,
            submap_surf_cap=2048, scan_corner_cap=256, scan_surf_cap=1024,
            submap_merge_batch=1))
    return dataclasses.asdict(cfg)


def make(tmp: Path, traffic: dict | None = None, name: str = "tiny.grow"):
    """A copy of the benchmark's folder in ``tmp`` with a config ``tiny``,
    a mix ``tiny_mix``, the limits of cell ``name`` and a per-layer metric
    ``scans_in_window`` added as new files, and the spec with their
    entries.  Returns (bench_dir, spec, cell)."""
    bench = tmp / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics", "programs"):
        shutil.copytree(BENCH / sub, bench / sub)
    (bench / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "pipeline": tiny_pipeline()}))
    (bench / "traffic" / "tiny_mix.json").write_text(
        json.dumps(traffic or TRAFFIC))
    (bench / "limits" / f"{name}.json").write_text(json.dumps(LIMITS))
    (bench / "metrics" / "scans_in_window.py").write_text(METRIC)
    spec = copy.deepcopy(json.loads((ROOT / "BENCHMARK.json").read_text()))
    cell = {"name": name, "config": "tiny", "traffic": "tiny_mix",
            "chips": 1, "why": "a test cell"}
    spec["workloads"].append(cell)
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "a test config"})
    spec["end_to_end"][0]["workloads"].append(name)
    spec["per_layer"].append({
        "name": "scans_in_window", "unit": "scans", "better": "higher",
        "source": "program_counter", "layer": "driver", "moves":
        "scans_per_s", "workloads": [name]})
    return bench, spec, cell


def run(bench, spec, cell, seed=12345678901, seconds=0.5, trace=False,
        device="cpu", judged=None):
    import time

    from benchmark import harness
    return harness.run_cell(spec, bench, cell, seed, seconds, trace, device,
                            time.perf_counter(), judged=judged)
