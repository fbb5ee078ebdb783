"""One run of one cell: everything is found by name.

  * ``BENCHMARK.json``'s ``workloads`` entry names the cell's config and
    traffic mix;
  * ``configs/<config>.json`` holds the configuration as it is run (its
    ``pipeline`` object is every field of the port's ``PipelineConfig``);
  * ``traffic/<mix>.json`` holds the mix's parameters: the driver
    (``closed`` or ``open``), the program kind, the scan stream, the
    check's segments and the traced scans;
  * ``programs/<kind>.py`` is the mix's program kind.  Its
    ``Program(cfg, device, traffic)`` wraps the port's step (imported
    when it is built) and owns its state: ``outputs``, ``n_warm`` (the
    warm-up's scans), ``is_mapping(k)``, ``step(k, scan) -> {output:
    Pose}``, ``restart()`` (a fresh state), ``maintain()``, ``state`` and
    ``counters()`` ({name: count}, with ``replays``, ``reads`` and
    ``captures``).  Its ``Reference(cfg, device)``, built from
    ``reference/`` alone and checking its configuration, has ``empty()``
    and ``step(state, k, scan) -> (state, {output: Pose})``.  The file is
    loaded by path, so it imports absolutely (``from benchmark.reference
    import step``);
  * ``limits/<cell>.json`` holds the limit of each compared number;
  * ``metrics/<metric>.py`` reads one metric: ``read(ctx) -> float or
    None`` (None: nothing to read, the metric is left out of the line).

A later change adds a config, a mix, a program kind, a cell or a metric
by adding files and entries; no file here names one.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "legoloam_tpu")


def load_spec(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_json(bench_dir: Path, kind: str, name: str) -> dict:
    with open(bench_dir / kind / f"{name}.json") as f:
        return json.load(f)


def load_file(path: Path, name: str):
    """The Python file at ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(
        name.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(bench_dir: Path, metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    return load_file(bench_dir / "metrics" / f"{metric}.py",
                     f"benchmark_metric_{metric}").read


def load_program(bench_dir: Path, kind: str):
    """``programs/<kind>.py``: its ``Program`` and ``Reference``."""
    path = bench_dir / "programs" / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"no program kind {kind!r}: {path} not found")
    return load_file(path, f"benchmark_program_{kind}")


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` False) or per-layer
    metrics (True): those whose ``workloads`` name it, those without the
    key, and for a per-layer metric without it, those whose ``moves`` the
    cell reports."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


def build_config(template, values: dict):
    """A frozen dataclass like ``template`` with every field from
    ``values`` (nested dataclasses from nested objects); a field missing
    or unknown raises, so the file is the whole configuration."""
    names = {f.name for f in dataclasses.fields(template)}
    if set(values) != names:
        raise ValueError(f"{type(template).__name__}: missing "
                         f"{sorted(names - set(values))}, unknown "
                         f"{sorted(set(values) - names)}")
    kw = {}
    for f in dataclasses.fields(template):
        cur, v = getattr(template, f.name), values[f.name]
        if dataclasses.is_dataclass(cur):
            v = build_config(cur, v)
        elif isinstance(cur, tuple):
            v = tuple(v)
        kw[f.name] = v
    return type(template)(**kw)


def plan_for(traffic: dict, seed: int):
    """The check's segments: scans [0, start_scans) from the empty state,
    then ``segments`` runs of ``segment_scans`` scans each, their starts
    drawn from the seed in [start_scans, sample_below), clear of the
    profiled scans (a snapshot there would be traced)."""
    from .drivers import Plan
    rng = random.Random(seed)
    n0, n = int(traffic["start_scans"]), int(traffic["segment_scans"])
    t0 = int(traffic["trace_from"])
    t1 = t0 + int(traffic["trace_scans"])
    chunk = int(traffic["chunk"])
    if t0 // chunk != (t1 - 1) // chunk:
        raise ValueError(f"the profiled scans [{t0}, {t1}) cross a staging "
                         f"chunk of {chunk}: staging would be traced")
    free = [s for s in range(n0, int(traffic["sample_below"]) - n)
            if s + n < t0 or s > t1]
    starts = sorted(rng.sample(free, int(traffic["segments"])))
    segs = [(0, n0)]
    for s in starts:
        if s >= segs[-1][0] + segs[-1][1]:
            segs.append((s, n))
    return Plan(segs)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


# The card's start transient: after a program's captures the replayed step
# runs 11-16% slower (VLP-16 odometry ~198 against ~223 scans/s, VLS-128
# ~90 against ~105), then steps up once, at a time that varies from run to
# run (2 s to over 45 s after the warm-up); building another program brings
# it back.  Its end: the rate over STEADY_S seconds of steps up by
# STEADY_GAIN on the slowest such stretch since the warm-up, twice running.
STEADY_S = 2.0
STEADY_GAIN = 1.08
STEADY_CAP_S = 75.0


def preroll(prog, stager, seconds: float, until_steady: bool):
    """The step on, as in the window, after the warm-up: for ``seconds``,
    and with ``until_steady`` (on the card) also until the start transient
    has ended or ``STEADY_CAP_S`` has passed.  A window opened after it
    reads the steady rate instead of a mix of the two that varies from run
    to run.  Its length is set by the clock and the card, not by the
    program, so it is left out of ``setup_s``.  Returns (seconds it took,
    seconds to the transient's end or None, the scans/s of each
    ``STEADY_S`` stretch)."""
    clock = stager.clock
    t0 = time.perf_counter()
    k = prog.n_warm
    rates, ended = [], None
    while True:
        done = time.perf_counter() - t0
        if done >= seconds and (not until_steady or ended is not None
                                or done >= STEADY_CAP_S):
            break
        clock.sync()
        s0, k0 = clock.now(), k
        while clock.now() - s0 < STEADY_S and (
                until_steady or time.perf_counter() - t0 < seconds):
            prog.step(k, stager.get(k))
            k += 1
        clock.sync()
        rates.append((k - k0) / (clock.now() - s0))
        if ended is None and len(rates) >= 3 and min(rates[-2:]) \
                >= STEADY_GAIN * min(rates[:-2]):
            ended = time.perf_counter() - t0
    return time.perf_counter() - t0, ended, rates


@dataclasses.dataclass
class Context:
    """What a metric's reader sees."""

    cell: dict
    traffic: dict
    cfg: object          # the port's PipelineConfig
    rec: object          # drivers.Record
    setup_s: float       # set-up, the pre-roll left out
    trace: object        # trace.Trace or None


def run_cell(spec: dict, bench_dir: Path, cell: dict, seed: int,
             seconds: float, traced: bool, device, t_start: float,
             judged=None, with_preroll: bool = True,
             check_threads: int | None = None) -> dict:
    """One run of ``cell``.  Returns the result's fields: ``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` (a
    traced run) and ``compared``.  ``judged(reference, plan, before,
    stream)``, where given, returns the (outputs, after) the check judges
    in the program's place (the control, ``control.py``): ``correct`` and
    ``compared`` are then the control's, and ``program_compared`` holds
    the program's own numbers.  ``with_preroll`` False skips the pre-roll
    (the control needs only the window's states).  ``check_threads``, where
    given, is the host's intra-op thread count for the check, which runs
    after the window."""
    import torch

    from legoloam_tpu_torch import config as port_config

    from . import compare, drivers, generator, trace as trace_mod
    from .reference import config as ref_config

    doc = load_json(bench_dir, "configs", cell["config"])
    traffic = load_json(bench_dir, "traffic", cell["traffic"])
    limits = load_json(bench_dir, "limits", cell["name"])
    cfg = build_config(port_config.PipelineConfig(), doc["pipeline"])
    rcfg = build_config(ref_config.PipelineConfig(), doc["pipeline"])
    dev = torch.device(device)

    # Set-up: the program, the first chunk of scans, the warm-up on a
    # throwaway state (every step variant captured), a fresh state.
    program = load_program(bench_dir, traffic["program"])
    prog = program.Program(cfg, dev, traffic)
    stream = generator.ScanStream(traffic, seed, cfg.sensor, dev)
    clock = drivers.Clock(dev)
    stager = drivers.Stager(stream, traffic["chunk"], clock)
    stager.first()
    for k in range(prog.n_warm):
        prog.step(k, stager.get(k))
    preroll_s, steady_at, pre_rates = preroll(
        prog, stager, float(traffic.get("preroll_seconds", 0)),
        dev.type == "cuda") if with_preroll else (0.0, None, [])
    prog.restart()
    stager.get(0)
    stager.marks.clear()
    stager.seconds = 0.0
    clock.sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start - preroll_s

    plan = plan_for(traffic, seed)
    # The set-up's objects out of the collector's way: a collection inside
    # the window then walks only what the window made.
    gc.collect()
    gc.freeze()
    tracer = drivers.Tracer(traffic["trace_from"], traffic["trace_scans"],
                            clock) if traced else None
    rec = drivers.DRIVERS[traffic["driver"]](prog, stager, traffic, seconds,
                                             plan, tracer)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    print(f"[bench] {cell['name']} seed {seed}: set-up {setup_s:.3f} s "
          f"(pre-roll {preroll_s:.3f} s apart), "
          f"{rec.scans} scans in {rec.window_s:.3f} s, staging "
          f"{rec.stage_s:.3f} s outside the clock, {rec.captures} graph "
          f"captures and {rec.decimations} decimations in the window",
          file=sys.stderr)
    if pre_rates:
        print("[bench] pre-roll: the start transient "
              + ("not seen to end" if steady_at is None else
                 f"ended after {steady_at:.1f} s")
              + f"; scans/s each {STEADY_S:g} s: "
              + " ".join(f"{r:.1f}" for r in pre_rates), file=sys.stderr)
    marks = [(k, t) for k, t in stager.marks if k <= rec.scans]
    if len(marks) > 1:
        print("[bench] scans/s between stagings: " + " ".join(
            f"{(k1 - k0) / (t1 - t0):.1f}"
            for (k0, t0), (k1, t1) in zip(marks, marks[1:])),
            file=sys.stderr)
    if rec.latency_ms:
        for kind in (True, False):
            v = sorted(x for x, m in zip(rec.latency_ms, rec.kinds)
                       if m == kind)
            if v:
                q = {p: v[min(len(v) - 1, int(p * len(v)))]
                     for p in (0.5, 0.9, 0.95, 0.99)}
                print(f"[bench] latency ms, {'mapping' if kind else 'other'}"
                      f" scans ({len(v)}): " + " ".join(
                          f"p{int(100 * p)} {x:.3f}" for p, x in q.items())
                      + f" max {v[-1]:.3f}", file=sys.stderr)
    if rec.generator_lag_ms:
        print(f"[bench] generator lateness: median "
              f"{sorted(rec.generator_lag_ms)[len(rec.generator_lag_ms) // 2]}"
              f" ms, max {max(rec.generator_lag_ms)} ms", file=sys.stderr)
    tr = None
    if rec.profile is not None:
        t0 = time.perf_counter()
        tr = trace_mod.reduce(rec.profile, rec.profiled_scans)
        rec.profile = tracer.prof = tracer.rec = None
        print(f"[bench] trace read in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)

    # The check, once the window has closed and the program is freed.
    prog_out = compare.host_outputs(rec.outputs)
    prog_after = rec.after
    before = rec.before
    rec.outputs = {}
    del prog, stager, tracer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    if check_threads:
        torch.set_num_threads(check_threads)
    t0 = time.perf_counter()
    reference = program.Reference(rcfg, dev)
    ref_out, ref_after = compare.follow(reference, plan, before, stream)
    values = compare.numbers(prog_out, prog_after, ref_out, ref_after)
    program_values = values
    if judged is not None:
        j_out, j_after = judged(reference, plan, before, stream)
        values = compare.numbers(j_out, j_after, ref_out, ref_after)
    correct = compare.judge(values, limits) and rec.captures == 0
    print(f"[bench] check: {len(plan.segments)} segments "
          f"{plan.segments}, {len(ref_out)} scans, "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)

    ctx = Context(cell=cell, traffic=traffic, cfg=cfg, rec=rec,
                  setup_s=setup_s, trace=tr)
    metrics = {}
    for m in cell_metrics(spec, cell["name"], traced):
        v = load_reader(bench_dir, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": rec.scans,
              "failed": rec.late, "metrics": metrics,
              "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_us * 1e-6
        device_info["window_s"] = tr.window_us * 1e-6
        result["breakdown"] = trace_mod.breakdown(tr)
    if judged is not None:
        result["program_compared"] = {n: program_values[n] for n in limits}
    compared = {n: {"value": values[n], "limit": limits[n]}
                for n in limits}
    compared["graph_captures_in_window"] = {"value": rec.captures,
                                            "limit": 0}
    result["compared"] = compared
    return result
