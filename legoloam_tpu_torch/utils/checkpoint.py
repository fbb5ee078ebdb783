"""Checkpoint and resume of the full SLAM state (port of
``legoloam_tpu/utils/checkpoint.py``).

The state is nested NamedTuples of fixed-shape tensors, saved as one flat
npz (atomic: written beside the target, then renamed over it).  Keys are
the JAX package's: each field as ``"." + name``, joined by ``/`` from the
root (``.odom/.pose/.R``, ``.mapping/.kf/.t``), so a checkpoint written by
either package loads into the other.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Iterator, Tuple

import numpy as np
import torch


def flatten_with_keys(tree: Any, prefix: str = ""
                      ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(key, tensor) for every tensor of a NamedTuple tree, in field
    order."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    fields = getattr(tree, "_fields", None)
    if fields is None:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} "
                        f"at {prefix!r}")
    for name in fields:
        key = f"{prefix}/.{name}" if prefix else f".{name}"
        yield from flatten_with_keys(getattr(tree, name), key)


def save_state(path: str, state: Any) -> None:
    """Atomic save of a NamedTuple tree of tensors to ``path`` (npz)."""
    flat = {k: t.detach().cpu().numpy() for k, t in flatten_with_keys(state)}
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _rebuild(tree: Any, arrays: dict, prefix: str = ""):
    if isinstance(tree, torch.Tensor):
        return arrays[prefix]
    return type(tree)(*(_rebuild(getattr(tree, n), arrays,
                                 f"{prefix}/.{n}" if prefix else f".{n}")
                        for n in tree._fields))


def load_state(path: str, template: Any) -> Any:
    """Load a checkpoint into the structure of ``template`` (a state built
    with the same config): every tensor on the template's device, in the
    template's dtype."""
    arrays = {}
    with np.load(path) as data:
        for key, tmpl in flatten_with_keys(template):
            if key not in data:
                raise KeyError(f"checkpoint missing array {key!r}")
            arr = data[key]
            if arr.shape != tuple(tmpl.shape):
                raise ValueError(
                    f"checkpoint shape mismatch for {key!r}: "
                    f"{arr.shape} vs {tuple(tmpl.shape)} (config changed?)")
            np_dtype = torch.empty(0, dtype=tmpl.dtype).numpy().dtype
            arrays[key] = torch.from_numpy(
                np.array(arr, dtype=np_dtype, order="C")).to(tmpl.device)
    return _rebuild(template, arrays)
