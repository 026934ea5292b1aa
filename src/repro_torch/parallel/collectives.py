"""The collectives of the parallel layers, in two forms behind one interface.

The JAX package runs its parallel layers under ``shard_map`` on M devices,
each holding one shard, and moves data between them with collectives.  The
port runs the same per-shard bodies over a :class:`Shards`: the shards of a
mesh that this process holds, and the collectives between them.  Two forms
implement it:

- :class:`ListShards`, what a bare :class:`~repro_torch.launch.mesh.Mesh`
  gives: every shard in this process, their tensors a Python list on one
  device, the collectives list operations;
- :class:`~repro_torch.parallel.dist.RankShards`, what a
  ``torch.distributed`` ``DeviceMesh`` gives: one shard a rank, this
  rank's, the collectives ``torch.distributed`` calls over the mesh's
  process groups.

Every collective takes a list of the held shards' tensors (in the order of
``Shards.coords``) and returns what each of them receives:

- :meth:`~Shards.all_gather`: the tensors of the shards that differ only
  along ``axes``, stacked in their row-major order over those axes;
- :meth:`~Shards.all_to_all`: shard ``i`` of ``axis`` sends block ``j``
  of its operand to shard ``j`` and receives a list of blocks, block ``i``
  from shard ``i``: ``out[j][i] = in[i][j]``;
- :meth:`~Shards.ppermute_next`: shard ``i`` of ``axis`` sends to shard
  ``i + 1``; shard 0 receives zeros (``lax.ppermute`` with the pairs
  ``(i, i + 1)``);
- :meth:`~Shards.psum` / :meth:`~Shards.pmean`: the sum / mean over
  ``axes``, reduced in shard order, so every shard holds the same bits.

Inside :func:`observe` each collective reports once, whichever form runs
it, its kind under the JAX package's HLO names and one participant's
operand bytes (the dry run's collective counter,
:mod:`repro_torch.launch.roofline`).  The module-level functions are the
list form over one axis of ``len(xs)`` shards.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Callable, Sequence

import torch

from ..launch.mesh import Mesh

_observers: list[Callable[[str, int], None]] = []


@contextlib.contextmanager
def observe(fn: Callable[[str, int], None]):
    """Inside the block every collective calls ``fn(kind, nbytes)``:
    ``kind`` one of ``all-gather``, ``all-to-all``,
    ``collective-permute``, ``all-reduce``; ``nbytes`` the operand bytes
    of one participant (the first held shard), what one device sends into
    the collective."""
    _observers.append(fn)
    try:
        yield
    finally:
        _observers.remove(fn)


def _report(kind: str, operand) -> None:
    if _observers:
        parts = [operand] if isinstance(operand, torch.Tensor) else operand
        nbytes = sum(t.numel() * t.element_size() for t in parts
                     if isinstance(t, torch.Tensor))
        for fn in _observers:
            fn(kind, nbytes)


class Shards:
    """The shards of ``mesh`` held by this process (``coords``, each a
    ``{axis: index}``, in row-major order) and the collectives between
    them.  A form implements the ``_``-prefixed methods; the public ones
    report to :func:`observe` and call them."""

    mesh = None                  # the whole mesh: axis names and sizes
    coords: list[dict[str, int]]

    def index(self, axis: str) -> list[int]:
        """Each held shard's index along ``axis``."""
        return [c[axis] for c in self.coords]

    def flat_index(self, axes: Sequence[str]) -> list[int]:
        """Each held shard's row-major index over ``axes``."""
        out = []
        for c in self.coords:
            i = 0
            for a in axes:
                i = i * self.mesh.shape[a] + c[a]
            out.append(i)
        return out

    def _axes(self, axes) -> tuple[str, ...]:
        """``axes`` (a name or several) in the mesh's order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = set(axes) - set(self.mesh.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} not in {self.mesh}")
        return tuple(a for a in self.mesh.axis_names if a in axes)

    def all_gather(self, xs: Sequence, axes) -> list[torch.Tensor]:
        _report("all-gather", xs[0])
        return self._all_gather(list(xs), self._axes(axes))

    def all_to_all(self, xs: Sequence, axis: str) -> list[list]:
        n = self.mesh.shape[self._axes(axis)[0]]
        if any(len(x) != n for x in xs):
            raise ValueError(f"all_to_all over {n} shards needs {n} blocks "
                             "each")
        _report("all-to-all", xs[0])
        return self._all_to_all(list(xs), axis)

    def ppermute_next(self, xs: Sequence, axis: str) -> list[torch.Tensor]:
        _report("collective-permute", xs[0])
        return self._ppermute_next(list(xs), self._axes(axis)[0])

    def psum(self, xs: Sequence, axes) -> list[torch.Tensor]:
        _report("all-reduce", xs[0])
        return _reduce(self._all_gather(list(xs), self._axes(axes)),
                       lambda g: g.sum(dim=0))

    def pmean(self, xs: Sequence, axes) -> list[torch.Tensor]:
        _report("all-reduce", xs[0])
        return _reduce(self._all_gather(list(xs), self._axes(axes)),
                       lambda g: g.mean(dim=0))

    def _all_gather(self, xs, axes):
        raise NotImplementedError

    def _all_to_all(self, xs, axis):
        raise NotImplementedError

    def _ppermute_next(self, xs, axis):
        raise NotImplementedError


def _reduce(gathered: list, op) -> list:
    """``op`` of each gathered stack, once per distinct stack (the list
    form hands one stack to every shard of a group)."""
    done: dict[int, torch.Tensor] = {}
    for g in gathered:
        if id(g) not in done:
            done[id(g)] = op(g)
    return [done[id(g)] for g in gathered]


class ListShards(Shards):
    """Every shard of ``mesh`` in this process: the list form."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        names = mesh.axis_names
        self.coords = [dict(zip(names, c)) for c in itertools.product(
            *(range(mesh.shape[a]) for a in names))]

    @classmethod
    def over(cls, n: int) -> "ListShards":
        """``n`` shards along one axis, ``"group"``."""
        return cls(Mesh((n,), ("group",)))

    def _groups(self, axes) -> list[list[int]]:
        """Positions of the held shards, grouped by their coordinates off
        ``axes``; each group in row-major order over ``axes``."""
        groups: dict[tuple, list[int]] = {}
        for i, c in enumerate(self.coords):
            key = tuple(v for a, v in c.items() if a not in axes)
            groups.setdefault(key, []).append(i)
        return list(groups.values())

    def _all_gather(self, xs, axes):
        out = [None] * len(xs)
        for g in self._groups(axes):
            stacked = torch.stack([xs[i] for i in g])
            for i in g:
                out[i] = stacked
        return out

    def _all_to_all(self, xs, axis):
        out = [None] * len(xs)
        for g in self._groups((axis,)):
            for j, i in enumerate(g):
                out[i] = [xs[src][j] for src in g]
        return out

    def _ppermute_next(self, xs, axis):
        out = [None] * len(xs)
        for g in self._groups((axis,)):
            out[g[0]] = torch.zeros_like(xs[g[0]])
            for src, dst in zip(g, g[1:]):
                out[dst] = xs[src]
        return out


def shards(mesh) -> Shards:
    """The shards a parallel layer runs over: a :class:`Shards` as it is,
    a ``DeviceMesh`` the rank form, a bare ``Mesh`` the list form."""
    if isinstance(mesh, Shards):
        return mesh
    if hasattr(mesh, "get_group"):                   # a DeviceMesh
        from .dist import RankShards
        return RankShards.from_device_mesh(mesh)
    return ListShards(mesh)


# -- the list form over one axis ----------------------------------------------

def all_gather(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``[M, ...]``: the shards' tensors stacked in shard order (what each
    participant of ``lax.all_gather`` holds)."""
    return ListShards.over(len(xs)).all_gather(xs, "group")[0]


def all_to_all(blocks: Sequence[Sequence]) -> list[list]:
    """``blocks[i][j]`` is what shard ``i`` sends to shard ``j``; returns
    ``out`` with ``out[j][i] = blocks[i][j]``."""
    return ListShards.over(len(blocks)).all_to_all(blocks, "group")


def ppermute_next(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Each shard's tensor moved to the next shard; the first receives
    zeros, the last shard's tensor is dropped."""
    return ListShards.over(len(xs)).ppermute_next(xs, "group")


def psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return ListShards.over(len(xs)).psum(xs, "group")[0]


def pmean(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return ListShards.over(len(xs)).pmean(xs, "group")[0]
