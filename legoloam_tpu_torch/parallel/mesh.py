"""The rank group the distributed paths run over (port of
``legoloam_tpu/parallel/mesh.py``).

The JAX package's mesh is one program over many devices; here it is one
process per rank (SPMD) over a ``torch.distributed`` process group, each
rank holding its shard as a plain local tensor.  ``launch`` starts the
ranks: NCCL with one rank per card, or gloo for ranks on the CPU (and, asked
for explicitly, for ranks that share one card).  Every group gets a timeout,
so a rank that dies or calls another collective than its peers fails the
run instead of hanging it.

The rule every distributed function keeps: a host decision that guards a
collective (``bool()``/``int()`` of a gate, a count, a convergence test)
reads a value that is bitwise equal on every rank — a replicated input, a
value computed from replicated inputs by the same operations, or the result
of an all-reduce.  ``Mesh.read`` is that read; with ``strict`` it also
all-gathers the value and raises where the ranks disagree (the tests run so).
A read never happens inside a segment of a CUDA graph
(``models/step_graph.py``): on NCCL the collectives are captured with the
segments, and the reads sit at their boundaries.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..device import resolve_device

DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a 1-D mesh: ``size`` ranks named ``axis``, this
    one ``rank``, its tensors on ``device``, its collectives on ``group``
    (None: the default group)."""

    size: int
    rank: int
    axis: str
    device: torch.device
    group: Any = None
    strict: bool = False

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of ``x`` (a new tensor; ``x`` is not written)."""
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    @property
    def capturable(self) -> bool:
        """Whether the collectives can be captured in a CUDA graph: on
        NCCL, never on gloo."""
        return dist.get_backend(self.group) == "nccl"

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order: ``(size, *x.shape)``."""
        x = x.contiguous()
        if self.capturable:
            out = x.new_empty((self.size, *x.shape))
            dist.all_gather_into_tensor(out, x, group=self.group)
            return out
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.stack(parts)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank (a new tensor)."""
        out = x.contiguous().clone()
        dist.broadcast(out, src=0, group=self.group)
        return out

    def gather0(self, x: torch.Tensor):
        """Every rank's ``x`` stacked in rank order on rank 0; None on the
        other ranks."""
        x = x.contiguous()
        parts = ([torch.empty_like(x) for _ in range(self.size)]
                 if self.rank == 0 else None)
        dist.gather(x, parts, dst=0, group=self.group)
        return torch.stack(parts) if self.rank == 0 else None

    def assert_replicated(self, x: torch.Tensor, what: str = "value"):
        """Raise unless ``x`` is bitwise equal on every rank."""
        if self.size == 1:
            return
        g = self.all_gather(x.reshape(-1))
        if g.dtype != torch.bool:
            g = g.view(torch.uint8)             # bitwise, NaN included
        if not bool(torch.all(g == g[:1])):
            raise RuntimeError(f"rank {self.rank}: {what} differs between "
                               f"ranks: {g.tolist()}")

    def read(self, x: torch.Tensor, what: str = "decision"):
        """The host value (``bool``, ``int`` or ``float``) of a 0-d tensor
        that must be equal on every rank; checked across ranks when
        ``strict``."""
        if self.strict:
            self.assert_replicated(x, what)
        return x.item()


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device=None, strict: bool = False) -> Mesh:
    """The mesh over the already-initialised default process group.
    ``n_devices``, when given, must equal its world size.  ``device``:
    where this rank's tensors live (default: the card ``cuda:<rank mod the
    visible cards>``, whatever the backend; raises when there is none —
    ranks run on the CPU only when ``device="cpu"`` is passed)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start the ranks "
                           "with parallel.mesh.launch")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}) over a group of {size} "
                         "ranks")
    if device is None:
        resolve_device(None)                # raises without a card
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(size=size, rank=rank, axis=axis,
                device=torch.device(device), strict=strict)


def pad_rows(a: torch.Tensor, rows: int, fill=0) -> torch.Tensor:
    """``a`` padded to ``rows`` rows with ``fill`` (a scalar or a row): the
    port pads an axis split over the ranks to a multiple of the world size
    where the JAX package requires one."""
    extra = rows - a.shape[0]
    if extra <= 0:
        return a
    pad = (fill.to(a.device, a.dtype).expand(extra, *a.shape[1:])
           if isinstance(fill, torch.Tensor)
           else a.new_full((extra, *a.shape[1:]), fill))
    return torch.cat([a, pad])


def rank_device(rank: int, device, backend: str) -> torch.device:
    """Where rank ``rank`` runs: the CPU, or under NCCL its own card, or
    under gloo on CUDA the cards in turn."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank if backend == "nccl"
                        else rank % torch.cuda.device_count())


def check_devices(n: int, device=None, backend: str | None = None):
    """(device, backend) for ``n`` ranks: gloo on the CPU; NCCL on the
    cards unless ``backend`` says otherwise.  Raises where NCCL would need
    more cards than are visible, or where there is no card at all."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda")
    if dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU; use gloo")
        return dev, "gloo"
    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = backend or "nccl"
    need = n if backend == "nccl" else 1
    if n_dev < need:
        raise RuntimeError(f"--mesh {n} but only {n_dev} devices visible")
    return dev, backend


def _rank_main(rank: int, n: int, fn: Callable, args: tuple, device,
               backend: str, init: str, timeout_s: float, strict: bool,
               threads: int):
    dev = rank_device(rank, device, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(threads)
    # NCCL then honours the group's timeout.
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    dist.init_process_group(
        backend, init_method=init, world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = make_mesh(n, device=dev, strict=strict)
        fn(mesh, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, args: tuple = (), device=None,
           backend: str | None = None, timeout_s: float = DEFAULT_TIMEOUT_S,
           strict: bool = False) -> None:
    """Run ``fn(mesh, *args)`` on ``n`` ranks, one spawned process each,
    and wait for all of them.  ``fn`` must be importable by name (a module
    level function); it returns nothing — rank 0 writes what the caller
    needs.  Rendezvous through a file (no network).  Raises if any rank
    raises or dies; the others are then terminated."""
    import torch.multiprocessing as mp

    device, backend = check_devices(n, device, backend)
    # The ranks share the caller's intra-op threads.
    threads = max(1, torch.get_num_threads() // n)
    tmp = tempfile.mkdtemp(prefix="legoloam_rdzv_")
    try:
        mp.start_processes(
            _rank_main, args=(n, fn, args, str(device), backend,
                              "file://" + os.path.join(tmp, "store"),
                              timeout_s, strict, threads),
            nprocs=n, join=True, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
