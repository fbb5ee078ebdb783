"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload vlp16.grow --seed 7 --seconds 30 \\
        --trace 0

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``compared``: each number the check
compared with its limit.  The same numbers end standard error.

It exits 2, printing no result, without enough CUDA cards; 3 if a module
of JAX or of the JAX package was loaded.  Kernel and compiler caches go to
``build/`` in the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="benchmark.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels into ``build/kernels/<hash>`` itself)."""
    base = root / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def prepare_torch() -> int:
    """Matrix products in float32 (TF32 off), and one intra-op thread for
    the window: no idle worker threads spin beside the host's dispatch.
    Returns the thread count the check may use after the window."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    return threads


def emit(result: dict) -> None:
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs(ROOT)
    from benchmark import harness
    spec = harness.load_spec(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(spec, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); {torch.cuda.device_count()} available",
              file=sys.stderr)
        return 2
    check_threads = prepare_torch()
    result = harness.run_cell(spec, BENCH_DIR, cell, args.seed,
                              args.seconds, bool(args.trace), "cuda",
                              T_START, check_threads=check_threads)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
