"""Collectives over a list of per-shard tensors on one device.

The JAX package runs its parallel layers under ``shard_map`` on M devices,
each holding one shard, and moves data between them with collectives.  On
one card the port runs the same per-shard bodies over a Python list of the
M shards' tensors, and these four functions are the collectives:

- :func:`all_gather`: every shard receives every shard's tensor (stacked);
- :func:`all_to_all`: shard ``j`` receives block ``j`` of every shard, in
  shard order: ``out[j][i] = in[i][j]``;
- :func:`ppermute_next`: shard ``i`` sends to shard ``i + 1``; shard 0
  receives zeros (``lax.ppermute`` with the pairs ``(i, i + 1)``);
- :func:`psum` / :func:`pmean`: the sum / mean over the shards.

They compute what the collectives compute; a form over real process groups
(``torch.distributed``, one rank a card) waits for a machine with more
than one card.  Inside :func:`observe` each call reports its kind, under
the JAX package's HLO names, and one participant's operand bytes (the
dry run's collective counter, :mod:`repro_torch.launch.roofline`).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch

_observers: list[Callable[[str, int], None]] = []


@contextlib.contextmanager
def observe(fn: Callable[[str, int], None]):
    """Inside the block every collective calls ``fn(kind, nbytes)``:
    ``kind`` one of ``all-gather``, ``all-to-all``,
    ``collective-permute``, ``all-reduce``; ``nbytes`` the operand bytes
    of shard 0, what one device sends into the collective."""
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


def all_gather(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``[M, ...]``: the shards' tensors stacked in shard order (what each
    participant of ``lax.all_gather`` holds)."""
    _report("all-gather", xs[:1])
    return torch.stack(list(xs))


def all_to_all(blocks: Sequence[Sequence]) -> list[list]:
    """``blocks[i][j]`` is what shard ``i`` sends to shard ``j``; returns
    ``out`` with ``out[j][i] = blocks[i][j]``."""
    m = len(blocks)
    if any(len(row) != m for row in blocks):
        raise ValueError(f"all_to_all over {m} shards needs {m} blocks each")
    _report("all-to-all", blocks[0])
    return [[blocks[i][j] for i in range(m)] for j in range(m)]


def ppermute_next(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Each shard's tensor moved to the next shard; the first receives
    zeros, the last shard's tensor is dropped."""
    _report("collective-permute", xs[:1])
    return [torch.zeros_like(xs[0]), *xs[:-1]]


def psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    _report("all-reduce", xs[:1])
    return torch.stack(list(xs)).sum(dim=0)


def pmean(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    _report("all-reduce", xs[:1])
    return torch.stack(list(xs)).mean(dim=0)
