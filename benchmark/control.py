"""The check's control: the reference computed with TF32 on (the next
precision below the float32 the configuration states, with TF32 off), put
in the program's place, judged against the reference in float32.  It must
come out not correct.  The benchmark's own runs never run it.

    python3 -m benchmark.control --workload vlp16.grow --seeds 11,12,13 \\
        --seconds 5

runs the cell's set-up (without the pre-roll) and a short window once a
seed (the window leaves the states the later segments start from), then
the reference and the control over the check's segments, and prints one
JSON line a seed: the compared numbers of the control, whether they pass
the cell's limits, and the program's own numbers on the same seed (the
lower readings a limit is set from).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def tf32_in_place(reference, plan, before, stream):
    from benchmark import compare
    return compare.follow(reference, plan, before, stream, use_tf32=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    from benchmark import harness, run
    run.cache_dirs(run.ROOT)
    spec = harness.load_spec(run.ROOT / "BENCHMARK.json")
    cell = harness.find_cell(spec, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA card", file=sys.stderr)
        return 2
    check_threads = run.prepare_torch()
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.set_num_threads(1)
        res = harness.run_cell(spec, run.BENCH_DIR, cell, seed, args.seconds,
                               False, "cuda", time.perf_counter(),
                               judged=tf32_in_place, with_preroll=False,
                               check_threads=check_threads)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": res["correct"],
                          "compared": res["compared"],
                          "program": res["program_compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
