"""Build, load and count the hand-written CUDA kernels in ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, into ``build/kernels/<hash>``
beside the package (listed in ``.gitignore``), keyed by a hash of the sources
and flags.  Every ``.cu`` file compiles in its own ``nvcc`` process, all
started together, and one more call links them.  The library is loaded with
``ctypes``; every entry point launches on the caller's stream and returns
``cudaGetLastError()``.

Nothing here runs at import time: the CPU tests import every module, and a
machine without ``nvcc`` only fails when a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -fmad=false: no contraction of a*b+c into FMA, so the kernels' float
# arithmetic rounds exactly like the plain PyTorch versions (the pick
# kernel's curvature decides picks by float compares).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")
# ptxas's report (registers, shared memory, spills per kernel), written
# beside the library by ``build``.
PTXAS_LOG = "ptxas.log"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point: (argtypes), each returning an int error.
SIGNATURES = {
    # seed, conn_h, conn_v, parent, labels, ring_min, ring_max, rmax_root,
    # b (scans), n, h, stream
    "ccl_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # rng, col, ground, count, label, b (scans), n, h, sections, halfwin,
    # edge_trips, edge_sharp, surf_trips, edge_thr, surf_thr, col_gap,
    # range_jump, parallel_frac, stream
    "picks_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                     _F, _I, _F, _F, _P),
    # q, q_valid, r, r_valid, chunk_lo, chunk_hi (scratch), d_out, i_out
    # (int64), visited, q_n, r_n, k, gate_sq, use_gate, stream
    "knn_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                   _P),
    # q, q_sq, ref_m, r_sq, key, lo, hi, ex, chunks, part_d, part_i
    # (scratch), d_out, i_out (int64), q_n, r_n, n_classes, splits, stream
    "class_nn_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _P),
    # v, n (int32), out, m (rows), stream
    "link_scan_rows_launch": (_P, _P, _P, _I, _P),
    # v, n (int32), lo, hi (int64), q (scratch), out, m (rows), l (slots),
    # stream
    "link_scan_ranges_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
}


class Kernel:
    """One hand-written kernel: its name and the number of times it was
    launched (a plain count, read and reset by ``chip_smoke.py``): each
    wrapper call that launches it adds one, and each replay of a CUDA graph
    adds the launches the graph captured (``models/step_graph.py``)."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0


KERNELS: dict[str, Kernel] = {}


def register(name: str, source: str, replaces: str) -> Kernel:
    k = Kernel(name, source, replaces)
    KERNELS[name] = k
    return k


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def counts() -> dict[str, int]:
    """Every kernel's launch count, by name."""
    return {name: k.launches for name, k in KERNELS.items()}


def add_counts(delta: dict[str, int]) -> None:
    """Add launches made outside a wrapper call (a graph replay)."""
    for name, n in delta.items():
        KERNELS[name].launches += n


_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "liblegoloam_kernels.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` (one nvcc each, in parallel) and link the shared
    library, unless a library for these exact sources already exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
                 obj], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors, logs = [], []
        for src, p in procs:
            log = f"{src.name}:\n{p.communicate()[0].decode(errors='replace')}"
            (errors if p.returncode != 0 else logs).append(log)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        (out.parent / PTXAS_LOG).write_text("".join(logs))
        staged = os.path.join(tmp, out.name)
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", staged,
                               *objs], capture_output=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace")
                               + link.stderr.decode(errors="replace"))
        os.replace(staged, out)       # atomic: never a half-written library
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_cuda(*tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        require(t.device == dev and t.is_cuda,
                f"kernel inputs must share one CUDA device, got {t.device}")
        require(t.is_contiguous(), "kernel inputs must be contiguous")
