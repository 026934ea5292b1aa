"""The kernels in the model layout.

The entry points the models call on their kernel paths, with the
signatures of the JAX package's ``repro/kernels/ops.py`` less its block
sizes and interpret switch: the kernels choose their own tiles, and a
tensor on the CPU takes the kernel's plain version.

- ``mha_flash`` / ``mha_decode`` (``attention_impl == "cuda"``): unlike the
  reference, nothing transposes or reshapes; the kernels read the model
  layout ``[B, S, heads, D]`` through its strides, so a decode step does
  not copy the cache.
- ``moe_gmm_ffn`` (``moe_impl == "gmm"``): three grouped-matmul launches
  over the expert-sorted rows, with no padding and no dropped rows.
- ``ssd_chunked_cuda`` (``ssm_impl == "cuda"``): one SSD intra-chunk
  launch plus the inter-chunk recurrence in plain PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .moe_gmm import grouped_matmul
from .ssd_scan import CHUNK_MULTIPLE, ssd_intra_chunk


def mha_flash(q, k, v, *, causal: bool = True):
    """q ``[B,S,H,D]``; k/v ``[B,S,KV,D]`` → ``[B,S,H,D]`` (GQA folded into
    the kernel)."""
    return flash_attention(q, k, v, causal=causal)


def mha_decode(q, k_cache, v_cache, cache_len):
    """q ``[B,1,H,D]``; caches ``[B,S,KV,D]`` → ``[B,1,H,D]``; positions
    ``<= cache_len`` are attended."""
    return decode_attention(q[:, 0], k_cache, v_cache, cache_len)[:, None]


def mha_decode_stats(q, k_cache, v_cache, cache_len):
    """:func:`mha_decode`'s statistics form over one block of a cache:
    float32 ``(o [B,H,D], m [B,H], l [B,H])``; ``cache_len`` may be -1."""
    return decode_attention(q[:, 0], k_cache, v_cache, cache_len, stats=True)


def ssd_chunked_cuda(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """The contract of ``models.ssd.ssd_chunked``: x ``[B,S,H,P]``, dt
    ``[B,S,H]`` (float32, after the softplus), A ``[H]`` (float32), Bm/Cm
    ``[B,S,G,N]``, h0 ``[B,H,P,N]`` or None → (y ``[B,S,H,P]`` in x's
    dtype, final state ``[B,H,P,N]`` float32).

    One kernel launch computes the intra-chunk part (``y_intra`` kept in
    float32, as the reference's chunked form keeps it, and each chunk's
    state and ``seg``); the recurrence over the ``S / chunk`` chunks and
    the ``y_inter`` product stay plain PyTorch, as the reference leaves
    them to XLA.  Group ``g`` of B/C serves heads ``g·H/G ..``: the kernel
    and the ``y_inter`` product index groups, so B and C are never
    repeated over heads.

    A sequence shorter than the chunk is one chunk of S steps, and the
    kernel takes whole 16-step tiles: such an S is padded at the end with
    steps of ``dt = 0`` and zero x, B and C.  They change nothing: their
    decay is 1, they add nothing to y or to the state, and their y rows
    are cut off."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq len {S} not divisible by chunk {Q}")
    if Q == S and S % CHUNK_MULTIPLE:
        pad = -S % CHUNK_MULTIPLE
        padded = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                  for t in (x, dt, Bm, Cm)]
        y, h = ssd_chunked_cuda(padded[0], padded[1], A, padded[2],
                                padded[3], S + pad, h0=h0)
        return y[:, :S], h
    Nc = S // Q
    y_intra, states, seg = ssd_intra_chunk(x, dt, A, Bm, Cm, Q)
    chunk_decay = torch.exp(seg[..., -1])                    # [B, H, Nc]
    h = (torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_before = torch.empty((B_, H, Nc, P, N), dtype=torch.float32,
                           device=x.device)
    for c in range(Nc):
        h_before[:, :, c] = h
        h = h * chunk_decay[:, :, c, None, None] \
            + states[:, :, c].transpose(-1, -2)
    # y_inter[q, p] = exp(seg_q) · Σ_n C[q, n] · h_before[p, n], per group.
    ch = torch.einsum("bcqgn,bgrcpn->bcqgrp",
                      Cm.float().reshape(B_, Nc, Q, G, N),
                      h_before.reshape(B_, G, rep, Nc, P, N))
    in_decay = torch.exp(seg).permute(0, 2, 3, 1).reshape(B_, Nc, Q, G, rep, 1)
    y = y_intra.view(B_, Nc, Q, G, rep, P) + ch * in_decay
    return y.reshape(B_, S, H, P).to(x.dtype), h


def moe_gmm_ffn(xs, group_sizes, w_gate, w_up, w_down):
    """xs ``[T, d]`` rows sorted by expert; group_sizes ``[E]`` (on xs's
    device, summing to T); expert weights ``[E, d, f]``, ``[E, d, f]``,
    ``[E, f, d]`` in xs's dtype → ``[T, d]`` expert-FFN outputs, same
    order: ``(silu(xs·w_gate) · (xs·w_up)) · w_down`` per expert, three
    grouped-matmul launches.

    The reference's padded wrapper (``repro/kernels/ops.py:110``) sizes
    every expert's capacity to the mean group size and returns zeros for
    the rows past it; here no row is dropped, so the result is that of the
    reference's default ``ragged`` path (``jax.lax.ragged_dot``)."""
    g = grouped_matmul(xs, w_gate, group_sizes)
    u = grouped_matmul(xs, w_up, group_sizes)
    return grouped_matmul(F.silu(g) * u, w_down, group_sizes)
