"""Pipeline parallelism: the GPipe-style microbatch schedule over a ``pipe``
axis.

The JAX package lays the stages along the mesh's ``pipe`` axis inside
``shard_map`` and hands microbatches from stage to stage with
``lax.ppermute``.  Here the stages are a list on one device and the
hand-off is :func:`~repro_torch.parallel.collectives.ppermute_next`; the
schedule is the reference's (n_micro + n_stages − 1)-tick loop: tick ``t``
feeds microbatch ``t`` to stage 0, stage ``s`` processes microbatch
``t − s``, and every stage runs at every tick (the bubble's ticks compute
on zeros or on a repeated last microbatch, as the reference's do).  Bubble
fraction = (n_stages − 1)/(n_micro + n_stages − 1).
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import tree
from .collectives import ppermute_next


def pipeline_apply(
    stage_fn: Callable,        # (stage_params, x) -> x
    stage_params,              # tree stacked on a leading n_stages dim
    x: torch.Tensor,           # [n_micro, mb, ...] microbatched input
    mesh,
    axis: str = "pipe",
) -> torch.Tensor:
    """Run ``x`` through ``n_stages = mesh.shape[axis]`` pipeline stages;
    returns the ``[n_micro, mb, ...]`` outputs of the last stage.  As in
    the reference, ``n_micro`` must be a multiple of ``n_stages`` (its
    microbatches start sharded over the stages)."""
    n_stages = mesh.shape[axis]
    n_micro = x.shape[0]
    if n_micro < 1 or n_micro % n_stages:
        raise ValueError(f"{n_micro} microbatches over {n_stages} stages: "
                         "need a positive multiple")
    params = [tree.map(lambda p, s=s: p[s], stage_params)
              for s in range(n_stages)]
    buf = [torch.zeros_like(x[0]) for _ in range(n_stages)]   # stage inputs
    outs = []                                                 # last stage's
    for t in range(n_micro + n_stages - 1):
        feed = x[min(t, n_micro - 1)]
        out = [stage_fn(params[s], feed if s == 0 else buf[s])
               for s in range(n_stages)]
        if t >= n_stages - 1:        # microbatch t - (n_stages - 1) is done
            outs.append(out[-1])
        buf = ppermute_next(out)
    return torch.stack(outs)


def stage_split(n_layers: int, n_stages: int) -> list[int]:
    """Even layer split with remainder on early stages."""
    base, rem = divmod(n_layers, n_stages)
    return [base + (1 if i < rem else 0) for i in range(n_stages)]
