"""Segments: how the per-scan step's code is cut for CUDA graphs.

A function that the step runs is written as calls of ``rt.seg(key, fn,
*args, into=...)`` — a piece of straight-line tensor code, no host read
inside — separated by ``rt.read(x, what)``, the host value of a 0-d tensor
that decides what runs next (which submap branch, whether a chunk of an
iterative solve was the last), and by ``rt.cut()``, a graph boundary with
no read (each pass of a body replayed many times: a relocalization
candidate).  ``EAGER`` runs each segment as a plain call and reads with
``.item()``.  ``models/step_graph.py`` runs the same code with the
segments between two boundaries one captured CUDA graph over static
buffers, so the step's logic has one copy.

A segment's ``args`` and its result are trees of tensors (NamedTuples,
tuples, None).  Under a graph runner every tensor of ``args`` must be a
static buffer (the state, the step's inputs, or another segment's result),
and the result is written into ``into`` (a tree of static buffers, None
leaves allocating their own) before it is returned.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


class Eager:
    """Segments as plain calls, decisions read back with ``read_fn``
    (default ``.item()``; a mesh's ``Mesh.read``); ``reads`` counts the
    reads, ``tallies`` what the step's code tallied (``tally``).
    ``tracer``: the ``utils.profiling.Tracer`` of a traced step (set by
    the program for the step), else None."""

    tracer = None

    def __init__(self, read_fn: Callable | None = None):
        self.reads = 0
        self.read_fn = read_fn
        self.tallies: dict = {}

    def seg(self, key, fn: Callable, *args, into=None):
        """``fn(*args)``; ``key`` names the segment (with every static
        argument ``fn`` closes over) for a graph runner."""
        return fn(*args)

    def read(self, x: torch.Tensor, what: str = ""):
        """The host value of the 0-d tensor ``x``; ``what`` names it."""
        self.flush()
        self.reads += 1
        if self.tracer is None:
            return self._value(x, what)
        with self.tracer.read(what):
            return self._value(x, what)

    def tally(self, name: str, x) -> None:
        """Add ``x`` to the tally ``name`` and to the tracer's: a Python
        int, or a 0-d integer tensor that a read has just flushed (a
        solve's iteration count), summed on its device and never read
        here."""
        if isinstance(x, torch.Tensor):
            x = x.to(torch.int64, copy=True)
        self.tallies[name] = self.tallies.get(name, 0) + x
        if self.tracer is not None:
            self.tracer.tally(name, x)

    def _value(self, x: torch.Tensor, what: str):
        return x.item() if self.read_fn is None else self.read_fn(x, what)

    def adopt(self, tree):
        """Declare ``tree``'s tensors static buffers that segments may
        take as arguments (the state, a program's inputs); returns it.  A
        graph runner refuses any other argument that is not a segment's
        result or a view of one."""
        return tree

    def cut(self) -> None:
        """A graph boundary: the segments since the last boundary are one
        graph (a plain call runs at once: nothing to do)."""
        self.flush()

    def flush(self) -> None:
        """Run what was deferred, so every segment's result is written
        (before a read, after a step)."""


EAGER = Eager()


def leaves(tree) -> list:
    """The tensors of a tree, depth first (None leaves skipped)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in leaves(v)]
    raise TypeError(f"not a tensor tree: {type(tree)}")


def map_tree(fn: Callable[[torch.Tensor], Any], tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v) for v in tree)
    raise TypeError(f"not a tensor tree: {type(tree)}")


def bind(into, out):
    """The static tree for a result ``out``: ``into``'s buffers where it
    has them, fresh clones of ``out`` where ``into`` is None."""
    if into is None:
        return map_tree(lambda t: t.clone(), out)
    if isinstance(into, torch.Tensor):
        return into
    if isinstance(into, tuple) and hasattr(into, "_fields"):
        return type(into)(*(bind(a, b) for a, b in zip(into, out)))
    return type(into)(bind(a, b) for a, b in zip(into, out))


def copy_tree(dst, src) -> None:
    """Copy every tensor of ``src`` into the same place of ``dst``; a
    tensor that already is its destination is left alone (the keyframe
    store, written in place), and a source that shares memory with another
    destination is cloned first, so no copy reads what an earlier one
    wrote."""
    pairs = [(d, s) for d, s in zip(leaves(dst), leaves(src), strict=True)
             if d is not s]
    written = {d.untyped_storage().data_ptr() for d, _ in pairs}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in written
              else s) for d, s in pairs]
    for d, s in pairs:
        d.copy_(s)
