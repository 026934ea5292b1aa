"""Gradient compression: int8 block quantization with error feedback.

The JAX package's ``parallel/compress.py`` on tensors: a gradient is cut
into blocks of 256 float32 values, each stored as int8 with one float32
scale (its largest magnitude / 127), and the quantization error is fed
back into the next step's gradient (error feedback keeps SGD/Adam
convergence — Karimireddy et al., 2019).  The payloads and scales are
the reference's byte for byte: the same float32 division, and
``torch.round`` rounds half to even as ``jnp.round`` does.

:func:`compressed_allreduce_mean` is the reference's int8 all-reduce: each
participant's tensor is quantized, the int8 payloads and float32 scales
are all-gathered, and every participant dequantizes and averages.  Given
a process group it takes this rank's tensor and gathers across the ranks
(:mod:`.dist`); given a list of every participant's tensor it runs them
all here, on one device (:mod:`.collectives`).

:func:`ef_compress_sharded` is :func:`ef_compress` of the whole leaves
computed on one participant's blocks of them: the int8 blocks and their
scales are those of each whole leaf's flattened order, the scales taken by
a max over ``"model"`` of each participant's partial maxima (a max is
exact, so they are the unsharded scales bit for bit).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from .. import tree
from .collectives import ListShards
from .sharding import shard_slices

BLOCK = 256
#: Positions a participant's block is quantized in at a time: the int64
#: block ids of at most this many elements are held at once.
CHUNK = 1 << 22


class Quantized(NamedTuple):
    q: torch.Tensor       # int8 payload [blocks, BLOCK], zero-padded
    scale: torch.Tensor   # float32 per-block scales [blocks]
    size: int             # original (unpadded) length


def quantize(x: torch.Tensor, block: int = BLOCK) -> Quantized:
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    flat = torch.nn.functional.pad(flat, (0, (-n) % block)).reshape(-1, block)
    scale = flat.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return Quantized(q=q, scale=scale[:, 0], size=n)


def dequantize(qt: Quantized, shape, dtype=torch.float32) -> torch.Tensor:
    flat = (qt.q.float() * qt.scale[:, None]).reshape(-1)[: qt.size]
    return flat.reshape(shape).to(dtype)


def quantization_error(x: torch.Tensor) -> torch.Tensor:
    return x.float() - dequantize(quantize(x), x.shape)


def compressed_allreduce_mean(x, group=None) -> torch.Tensor:
    """The mean of the participants' tensors (one shape) as every
    participant computes it from the int8 wire format: the gathered
    payloads dequantized, averaged in float32, cut back to the tensor's
    size and cast to its dtype.  ``x``: this rank's tensor, and ``group``
    the process group of the participants (the reference's ``(x,
    axis_name)``); or, with no ``group``, a sequence of every
    participant's tensor, all here."""
    if group is None:
        xs, sh = list(x), ListShards.over(len(x))
    else:
        from .dist import RankShards
        xs, sh = [x], RankShards.of_group(group)
    qts = [quantize(t) for t in xs]
    qg = sh.all_gather([qt.q for qt in qts], "group")[0]          # int8
    sg = sh.all_gather([qt.scale for qt in qts], "group")[0]      # float32
    n, size = qg.shape[0], qts[0].size
    deq = (qg.float() * sg[..., None]).reshape(n, -1)[:, :size]
    return deq.mean(dim=0).reshape(xs[0].shape).to(xs[0].dtype)


def ef_init(grads: Any) -> Any:
    return tree.map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def ef_compress(grads: Any, residual: Any) -> tuple[Any, Any]:
    """``(quantize-dequantized grads, new residual)``: the residual carries
    this step's quantization error into the next step."""
    deq, res = [], []
    for g, r in zip(tree.leaves(grads), tree.leaves(residual), strict=True):
        corrected = g.float() + r
        d = dequantize(quantize(corrected), g.shape)
        deq.append(d.to(g.dtype))
        res.append(corrected - d)
    return tree.unflatten(grads, deq), tree.unflatten(grads, res)


def block_runs(shape, slices) -> tuple[list[int], int]:
    """The block ``slices`` of a leaf of ``shape`` as runs of consecutive
    positions of the leaf's flattened (row-major) order: their offsets, in
    the block's own row-major order, and their common length.  A run spans
    the dimensions from the last cut one on."""
    cut = [d for d, (s, n) in enumerate(zip(slices, shape))
           if (s.start, s.stop) != (0, n)]
    if not cut:
        return [0], math.prod(shape)
    d = cut[-1]
    inner = math.prod(shape[d + 1:])
    offsets = [slices[d].start * inner]
    for j in reversed(range(d)):
        stride = math.prod(shape[j + 1:])
        offsets = [i * stride + o for i in range(slices[j].start,
                                                 slices[j].stop)
                   for o in offsets]
    return offsets, (slices[d].stop - slices[d].start) * inner


def _chunks(offsets: torch.Tensor, length: int, n: int):
    """``(lo, hi, block ids)`` over the ``n`` positions of a block made of
    runs at ``offsets`` of ``length``: each position's global int8 block,
    ``CHUNK`` positions at a time."""
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        i = torch.arange(lo, hi, device=offsets.device)
        yield lo, hi, (offsets[i // length] + i % length) // BLOCK


def ef_compress_sharded(grads: Any, residual: Any, shardings: Any,
                        like: Any, part) -> tuple[Any, Any]:
    """:func:`ef_compress` on this participant's blocks (``grads``,
    ``residual``) of leaves whose whole shapes ``like`` holds, cut by
    ``shardings`` (:func:`~.sharding.shard_tree`): the result is
    ``ef_compress`` of the whole leaves cut to the blocks, byte for byte.
    A leaf the participant holds whole is quantized as ``ef_compress``
    does.  For a cut leaf, each participant takes the largest magnitude of
    its elements in every 256-element block of the whole leaf (its
    elements are runs of consecutive positions, :func:`block_runs`, so
    the block ids come from each run's offset, ``CHUNK`` positions at a
    time, never from an index of the whole leaf); one
    ``part.max_model`` of every cut leaf's maxima gives each block's
    scale; the participant quantizes its own elements with them."""
    gs, rs = tree.leaves(grads), tree.leaves(residual)
    corrected = [g.float() + r for g, r in zip(gs, rs, strict=True)]
    cuts = []
    for c, sh, whole in zip(corrected, tree.leaves(shardings),
                            tree.leaves(like), strict=True):
        shape = tuple(whole.shape)
        offsets, length = block_runs(shape, shard_slices(
            shape, sh, part.coord))
        cuts.append(None if length == math.prod(shape) else (
            torch.tensor(offsets, dtype=torch.int64, device=c.device),
            length, -(-math.prod(shape) // BLOCK)))
    partial = []
    for c, cut in zip(corrected, cuts):
        if cut is None:
            continue
        offsets, length, n_blocks = cut
        amax = torch.zeros(n_blocks, dtype=torch.float32, device=c.device)
        flat = c.reshape(-1)
        for lo, hi, ids in _chunks(offsets, length, flat.numel()):
            amax.scatter_reduce_(0, ids, flat[lo:hi].abs(), "amax")
        partial.append(amax)
    amaxes = (part.max_model(torch.cat(partial)).split(
        [a.numel() for a in partial]) if partial else [])
    deq, res, k = [], [], 0
    for g, c, cut in zip(gs, corrected, cuts):
        if cut is None:
            d = dequantize(quantize(c), g.shape)
        else:
            offsets, length, _ = cut
            scale = torch.clamp(amaxes[k] / 127.0, min=1e-12)
            k += 1
            flat = c.reshape(-1)
            d = torch.empty_like(flat)
            for lo, hi, ids in _chunks(offsets, length, flat.numel()):
                s = scale[ids]
                q = torch.clamp(torch.round(flat[lo:hi] / s), -127,
                                127).to(torch.int8)
                d[lo:hi] = q.float() * s
            d = d.reshape(g.shape)
        deq.append(d.to(g.dtype))
        res.append(c - d)
    return tree.unflatten(grads, deq), tree.unflatten(grads, res)
