"""Pipeline parallelism: the GPipe-style microbatch schedule over a ``pipe``
axis.

The JAX package lays the stages along the mesh's ``pipe`` axis inside
``shard_map`` and hands microbatches from stage to stage with
``lax.ppermute``.  Here the stages are the
:class:`~repro_torch.parallel.collectives.Shards` of the axis: every stage
in this process, a list on one device (a bare ``Mesh``), or one stage a
rank (a ``DeviceMesh``); the hand-off is their ``ppermute_next``.  The
schedule is the reference's (n_micro + n_stages − 1)-tick loop: tick ``t``
feeds microbatch ``t`` to stage 0, stage ``s`` processes microbatch
``t − s``, and every stage runs at every tick (the bubble's ticks compute
on zeros or on a repeated last microbatch, as the reference's do).  At the
end the stages' records are all-gathered and the last stage's selected,
as the reference broadcasts them.  Bubble fraction = (n_stages −
1)/(n_micro + n_stages − 1).
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import tree
from .collectives import shards


def pipeline_apply(
    stage_fn: Callable,        # (stage_params, x) -> x
    stage_params,              # tree stacked on a leading dim: held stages
    x: torch.Tensor,           # [n_micro, mb, ...] microbatched input
    mesh,
    axis: str = "pipe",
) -> torch.Tensor:
    """Run ``x`` through ``n_stages = mesh.shape[axis]`` pipeline stages;
    returns the ``[n_micro, mb, ...]`` outputs of the last stage.
    ``mesh``: a bare ``Mesh`` (every stage here; ``stage_params`` stacked
    over all of them), or a ``DeviceMesh`` / ``RankShards`` (this rank's
    stage; ``stage_params`` its block of the stacked tree, leading dim 1,
    as ``shard_map`` hands it).  ``x`` is the whole input on every rank,
    and every rank returns the whole output.  As in the reference,
    ``n_micro`` must be a multiple of ``n_stages`` (its microbatches start
    sharded over the stages)."""
    sh = shards(mesh)
    n_stages = sh.mesh.shape[axis]
    n_micro = x.shape[0]
    if n_micro < 1 or n_micro % n_stages:
        raise ValueError(f"{n_micro} microbatches over {n_stages} stages: "
                         "need a positive multiple")
    stages = sh.index(axis)
    held = sorted(set(stages))
    params = [tree.map(lambda p, j=held.index(s): p[j], stage_params)
              for s in stages]
    buf = [torch.zeros_like(x[0]) for _ in stages]            # stage inputs
    done: list[list] = [[] for _ in stages]
    for t in range(n_micro + n_stages - 1):
        feed = x[min(t, n_micro - 1)]
        out = [stage_fn(p, feed if s == 0 else b)
               for p, s, b in zip(params, stages, buf)]
        if t >= n_stages - 1:        # microbatch t - (n_stages - 1) is done
            for rec, o in zip(done, out):
                rec.append(o)
        buf = sh.ppermute_next(out, axis)
    return sh.all_gather([torch.stack(rec) for rec in done], axis)[0][-1]


def stage_split(n_layers: int, n_stages: int) -> list[int]:
    """Even layer split with remainder on early stages."""
    base, rem = divmod(n_layers, n_stages)
    return [base + (1 if i < rem else 0) for i in range(n_stages)]
