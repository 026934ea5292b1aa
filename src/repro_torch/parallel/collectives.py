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
than one card.
"""
from __future__ import annotations

from typing import Sequence

import torch


def all_gather(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``[M, ...]``: the shards' tensors stacked in shard order (what each
    participant of ``lax.all_gather`` holds)."""
    return torch.stack(list(xs))


def all_to_all(blocks: Sequence[Sequence]) -> list[list]:
    """``blocks[i][j]`` is what shard ``i`` sends to shard ``j``; returns
    ``out`` with ``out[j][i] = blocks[i][j]``."""
    m = len(blocks)
    if any(len(row) != m for row in blocks):
        raise ValueError(f"all_to_all over {m} shards needs {m} blocks each")
    return [[blocks[i][j] for i in range(m)] for j in range(m)]


def ppermute_next(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Each shard's tensor moved to the next shard; the first receives
    zeros, the last shard's tensor is dropped."""
    return [torch.zeros_like(xs[0]), *xs[:-1]]


def psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack(list(xs)).sum(dim=0)


def pmean(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack(list(xs)).mean(dim=0)
