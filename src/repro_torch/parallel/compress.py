"""Gradient compression: int8 block quantization with error feedback.

The JAX package's ``parallel/compress.py`` on tensors: a gradient is cut
into blocks of 256 float32 values, each stored as int8 with one float32
scale (its largest magnitude / 127), and the quantization error is fed
back into the next step's gradient (error feedback keeps SGD/Adam
convergence — Karimireddy et al., 2019).  The payloads and scales are
the reference's byte for byte: the same float32 division, and
``torch.round`` rounds half to even as ``jnp.round`` does.

:func:`compressed_allreduce_mean` is the reference's int8 all-reduce over
a list of the participants' tensors on one device (the collectives of
:mod:`.collectives`): each is quantized, the int8 payloads and float32
scales are gathered, and every participant dequantizes and averages.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

from .. import tree
from .collectives import all_gather

BLOCK = 256


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


def compressed_allreduce_mean(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The mean of the participants' ``xs`` (one tensor each, of one
    shape) as every participant computes it from the int8 wire format:
    the gathered payloads dequantized, averaged in float32, cut back to
    the tensor's size and cast to its dtype."""
    qts = [quantize(x) for x in xs]
    qg = all_gather([qt.q for qt in qts])          # int8 on the wire
    sg = all_gather([qt.scale for qt in qts])      # float32 scales
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
