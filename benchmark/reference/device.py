"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else the CUDA
    device.  Raises when no device was given and no CUDA device exists — a
    run on the card never silently turns into a CPU run."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda")


_CONSTS: dict = {}


def const(values, device, dtype=torch.float32) -> torch.Tensor:
    """A cached tensor of the Python ``values`` (a number or a flat
    sequence) on ``device``, made by fill kernels: no host-to-device copy,
    so the per-scan step can use it inside a CUDA graph.  It is made on
    first use, which must come before any capture (the step's warm-up);
    a first use under capture raises.  Callers must not write to it."""
    dev = torch.device(device)
    scalar = not isinstance(values, (tuple, list))
    vals = (values,) if scalar else tuple(values)
    key = (str(dev), dtype, scalar, vals)
    t = _CONSTS.get(key)
    if t is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"constant {vals} first needed under CUDA "
                               "graph capture; the warm-up must make it")
        t = torch.stack([torch.full((), v, dtype=dtype, device=dev)
                         for v in vals])
        t = t[0] if scalar else t
        _CONSTS[key] = t
    return t


def at(x: torch.Tensor, i) -> torch.Tensor:
    """``x[i]`` for a () integer tensor ``i``, as a gather on the device
    (indexing with a 0-d tensor reads it back to the host); a Python int
    indexes as usual."""
    if not isinstance(i, torch.Tensor):
        return x[i]
    return x.index_select(0, i.reshape(1))[0]
