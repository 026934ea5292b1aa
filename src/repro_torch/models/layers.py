"""Shared model layers: RMSNorm, RoPE, GQA attention (kernel / dense /
blocked / decode), SwiGLU MLP.  Plain functions over nested dicts of
tensors with the JAX package's keys, so parameters carry across key for
key.

``cfg.attention_impl`` picks the attention form: ``"cuda"`` calls the
hand-written kernels through :mod:`repro_torch.kernels.ops` (flash
attention for a full sequence, split-K decode attention against the
cache), ``"dense"`` and ``"blocked"`` are the JAX package's own plain forms.

Given a :class:`~repro_torch.parallel.tensor.Participant` (``part``), the
full-sequence attention and the MLP run on its block of the weights
(``parallel/sharding.py``'s rules): its query heads (``wq`` / ``bq`` by
column, ``wo`` by row), its kv heads (``wk`` / ``wv`` by column where the
kv heads divide the model axis, else the columns of the kv heads its
query heads read, from the replicated weights), its ``d_ff`` columns, in
a region of :func:`~repro_torch.parallel.tensor.enter_model_region` and
:func:`~repro_torch.parallel.tensor.leave_model_region`; the
encoder-decoder's cross-attention so too, its k / v projected from the
encoder's output on the kv heads its query heads read.  With a cache,
the participant keeps its block of it in the layout
``parallel/sharding.py``'s ``cache_layout`` names: its kv heads (``"head"``:
a decode step runs the decode kernel over them), a ``head_dim`` block of
every kv head (``"hd"``), or, where the batch does not divide over the
data axes, a block of the positions (``"seq"``: whole heads, the decode
kernel's statistics form over the block; ``"seq_hd"``: its ``head_dim``
block of them), whose softmax is combined across the data axes
(:func:`attention_decode_sharded`).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.decode_attention import (
    combine_blocks,
    decode_attention_stats_torch,
)
from ..parallel.sharding import kv_shardable
from ..parallel.tensor import enter_model_region, leave_model_region_product

Params = dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16`` and so on."""
    return getattr(torch, name)


def _normal(gen, shape, scale, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device).mul_(scale).to(dtype)


def _kept(name: str, t: torch.Tensor) -> torch.Tensor:
    """The init functions' default ``leaf``: the drawn leaf itself."""
    return t


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """Apply RoPE. x: [B, S, H, D]; positions: [B, S] (absolute indices)."""
    half = x.shape[-1] // 2
    freq = 1.0 / (theta ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].float() * freq  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def attention_shapes(cfg) -> dict[str, tuple]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"norm_scale": (d,), "wq": (d, h * hd), "wk": (d, kv * hd),
              "wv": (d, kv * hd), "wo": (h * hd, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(h * hd,), bk=(kv * hd,), bv=(kv * hd,))
    return shapes


def attention_init(gen, cfg, n_blocks: int, device, leaf=_kept) -> Params:
    """Parameters of ``n_blocks`` attention layers, stacked on axis 0, each
    passed through ``leaf(name, tensor)`` as it is drawn (the layer
    inits' common hook: :func:`repro_torch.models.lm.init_params`)."""
    pdt = dtype_of(cfg.param_dtype)
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    p: Params = {}
    for name, shape in attention_shapes(cfg).items():
        shape = (n_blocks, *shape)
        if name == "norm_scale":
            t = torch.ones(shape, dtype=pdt, device=device)
        elif name.startswith("b"):
            t = torch.zeros(shape, dtype=pdt, device=device)
        else:
            t = _normal(gen, shape, out_scale if name == "wo" else 0.02, pdt,
                        device)
        p[name] = leaf(name, t)
    return p


def _project_qkv(p: Params, x, x_kv, cfg):
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cdt = dtype_of(cfg.dtype)
    q = x @ p["wq"].to(cdt)
    k = x_kv @ p["wk"].to(cdt)
    v = x_kv @ p["wv"].to(cdt)
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    B, S = x.shape[0], x.shape[1]
    Skv = x_kv.shape[1]
    return (q.reshape(B, S, h, hd), k.reshape(B, Skv, kv, hd),
            v.reshape(B, Skv, kv, hd))


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    B, S, kv, hd = k.shape
    return k[:, :, :, None, :].expand(B, S, kv, n_rep, hd).reshape(
        B, S, kv * n_rep, hd)


def dense_attention(q, k, v, causal: bool, q_offset: int = 0):
    """Reference O(S²) attention. q: [B,Sq,H,D], k/v: [B,Sk,H,D]."""
    Sq, D = q.shape[1], q.shape[3]
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Sk, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def blocked_attention(q, k, v, causal: bool, kv_chunk: int = 1024,
                      q_offset: int = 0):
    """Flash-style attention in plain PyTorch: a loop over KV chunks with
    an online softmax (running max / denominator), numerically the same as
    :func:`dense_attention` (same f32 softmax)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if Sk % kv_chunk:
        kv_chunk = math.gcd(Sk, kv_chunk) or Sk
    scale = 1.0 / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for start in range(0, Sk, kv_chunk):
        kb = k[:, start:start + kv_chunk]
        vb = v[:, start:start + kv_chunk]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, kb).float() * scale
        if causal:
            kpos = start + torch.arange(kv_chunk, device=q.device)[None, :]
            logits = torch.where(qpos >= kpos, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)  # [B, Sq, H, D]


def attention_apply(p: Params, x, cfg, *, positions, causal: bool = True,
                    x_kv=None, kv_positions=None, use_rope: bool = True,
                    part=None):
    """Full-sequence attention (prefill without cache, forward); with a
    participant ``part``, on its block (module doc): self-attention with
    rope, or cross-attention without it (``x_kv``, the encoder's output)."""
    if part is not None:
        if (x_kv is None) != use_rope or kv_positions is not None:
            raise NotImplementedError("sharded attention is self-attention "
                                      "with rope or cross-attention without "
                                      "it")
        return _attention_sharded(p, x, cfg, positions, causal, part,
                                  x_kv=x_kv)
    x_kv = x if x_kv is None else x_kv
    q, k, v = _project_qkv(p, x, x_kv, cfg)
    if use_rope:
        kv_pos = positions if kv_positions is None else kv_positions
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, kv_pos, cfg.rope_theta)
    out = attend(q, k, v, cfg, causal)
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(out.dtype)


def _kv_heads_read(cfg, part) -> tuple[int, int, tuple | None]:
    """``(kv_lo, kv_hi, pick)``: the kv heads ``part``'s query heads
    ``part.block(H)`` read, and where the block straddles kv groups
    unevenly ``pick = (first, n_rep)``: each query head's own kv head is
    taken from them repeated ``n_rep`` times, from ``first`` on (else
    None)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    h_lo, h_hi = part.block(H)
    n_rep = H // KV
    kv_lo, kv_hi = h_lo // n_rep, (h_hi - 1) // n_rep + 1
    even = kv_hi - kv_lo == 1 or (
        h_lo % n_rep == 0 and (h_hi - h_lo) % n_rep == 0)
    return kv_lo, kv_hi, None if even else (h_lo - kv_lo * n_rep, n_rep)


def _picked(t, pick, n_q: int):
    """The kv heads ``t [B, S, KV', hd]`` that ``n_q`` query heads read
    one each (``pick`` of :func:`_kv_heads_read`; ``t`` where None)."""
    if pick is None:
        return t
    first, n_rep = pick
    return _repeat_kv(t, n_rep)[:, :, first:first + n_q]


def local_kv(k, v, cfg, part):
    """From every kv head ``k`` / ``v [B, S, KV, hd]`` (the kv heads do not
    divide the model axis), those ``part``'s query heads read, as
    :func:`attend` takes them against its ``q [B, S, H/m, hd]``."""
    h_lo, h_hi = part.block(cfg.n_heads)
    kv_lo, kv_hi, pick = _kv_heads_read(cfg, part)
    return tuple(_picked(t[:, :, kv_lo:kv_hi].contiguous(), pick,
                         h_hi - h_lo) for t in (k, v))


def _attention_sharded(p: Params, x, cfg, positions, causal: bool, part,
                       kv_out: bool = False, x_kv=None):
    """Self-attention over ``part``'s query heads ``part.block(H)``.  With
    ``wk`` / ``wv`` replicated, the kv heads those query heads read are
    projected from their columns: one kv head for all of them (glm4-9b at
    a model axis of 4: 8 heads over one, so n_rep 8), or, where the block
    straddles kv groups unevenly, each query head's own (n_rep 1).

    ``x_kv``: cross-attention over it instead (the encoder's output,
    replicated over ``"model"``; the caller has passed it through
    :func:`~repro_torch.parallel.tensor.enter_model_region`, once for
    every layer that reads it): no rope, and :func:`attend_cross`.

    ``kv_out``: also return k (after rope) and v, ``(out, k, v)``: this
    participant's kv heads where they shard, else every kv head at the
    whole ``head_dim`` (projected from the replicated ``wk`` / ``wv``;
    rope pairs column ``i`` with ``i + hd/2``, which another
    participant's ``head_dim`` block holds, so the cache block is cut
    after it, by :func:`kv_cache_blocks`)."""
    H, hd = cfg.n_heads, cfg.head_dim
    cdt = dtype_of(cfg.dtype)
    h_lo, h_hi = part.block(H)
    x = enter_model_region(x, part)
    src = x if x_kv is None else x_kv
    B, S = x.shape[:2]
    Skv = src.shape[1]
    shardable = kv_shardable(cfg, part.m)
    cols = slice(None)              # its kv heads, or (kv_out) every one
    if not (shardable or kv_out):   # the kv heads q reads
        kv_lo, kv_hi, pick = _kv_heads_read(cfg, part)
        cols = slice(kv_lo * hd, kv_hi * hd)
    q = x @ p["wq"].to(cdt)
    k = src @ p["wk"][:, cols].to(cdt)
    v = src @ p["wv"][:, cols].to(cdt)
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"][cols].to(cdt)
        v = v + p["bv"][cols].to(cdt)
    q = q.reshape(B, S, h_hi - h_lo, hd)
    k = k.reshape(B, Skv, -1, hd)
    v = v.reshape(B, Skv, -1, hd)
    if x_kv is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if shardable:
        k_att, v_att = k, v
    elif kv_out:
        k_att, v_att = local_kv(k, v, cfg, part)
    else:
        k_att, v_att = (_picked(t, pick, h_hi - h_lo) for t in (k, v))
    if x_kv is None:
        out = attend(q, k_att, v_att, cfg, causal)
    else:
        out = attend_cross(q, k_att, v_att, cfg)
    out = out.reshape(B, S, (h_hi - h_lo) * hd)
    out = leave_model_region_product(torch.matmul, part, out,
                                     p["wo"].to(out.dtype))
    return (out, k, v) if kv_out else out


def kv_cache_blocks(k, v, cfg, part, layout: str):
    """A participant's blocks of k and v ``[B, S, KV', hd]`` (from
    :func:`_attention_sharded` or a decode step's projection) as its cache
    keeps them in ``layout``, every position: as they are in ``"head"``
    and ``"seq"`` (its kv heads; every one at a model axis of one), else
    its ``head_dim`` columns ``part.block(hd)`` of every kv head.  Where
    the kv heads shard (``"seq_hd"`` only) they are first gathered over
    ``"model"``, k and v in one gather."""
    if layout in ("head", "seq"):
        return k, v
    if kv_shardable(cfg, part.m):
        kv = part.all_gather_model(torch.stack([k, v]))
        k, v = torch.cat(list(kv.unbind(0)), dim=-2).unbind(0)
    lo, hi = part.block(cfg.head_dim)
    return k[..., lo:hi], v[..., lo:hi]


def attend(q, k, v, cfg, causal: bool):
    """q ``[B,S,H,D]``, k/v ``[B,S,KV,D]`` (not repeated) through the form
    ``cfg.attention_impl`` names."""
    if cfg.attention_impl == "cuda":
        return ops.mha_flash(q, k, v, causal=causal)
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if cfg.attention_impl == "dense":
        return dense_attention(q, k, v, causal)
    return blocked_attention(q, k, v, causal)


def attend_cross(q, k, v, cfg, cross_len=None):
    """Cross-attention of q ``[B, S, H, D]`` over the encoder's k / v
    ``[B, T, KV, D]`` (not repeated), every position valid: under
    ``"cuda"`` the flash kernel (non-causal, ``Sq = S``, ``Sk = T``) or,
    with ``cross_len`` (a decode step; ``T - 1`` on the device), the decode
    kernel over all ``T`` positions (its mask is inclusive); otherwise the
    reference's dense form, which its cross-attention always takes."""
    if cfg.attention_impl != "cuda":
        n_rep = q.shape[2] // k.shape[2]
        return dense_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                               causal=False)
    if cross_len is None:
        return ops.mha_flash(q, k, v, causal=False)
    return ops.mha_decode(q, k, v, cross_len)


def check_cache_index(cache_len, s_max: int) -> None:
    """Raise ``IndexError`` where the JAX package's ``dynamic_update_slice``
    would clamp: a write at ``cache_len`` outside ``[0, s_max)``.  Checks an
    ``int`` or a host tensor; a device tensor is the caller's to check on
    its host mirror (reading it here would synchronise every decode step)."""
    if isinstance(cache_len, torch.Tensor):
        if cache_len.device.type != "cpu":
            return
        cache_len = int(cache_len)
    if not 0 <= cache_len < s_max:
        raise IndexError(
            f"cache index {cache_len} is outside a cache of {s_max} positions"
        )


def attention_decode(p: Params, x, cfg, k_cache, v_cache, cache_len, *,
                     use_rope: bool = True, update_cache: bool = True):
    """Single-token decode against a KV cache.  ``x [B, 1, d]``, caches
    ``[B, S_max, kv, hd]``, ``cache_len`` a 0-d int32 tensor on x's device
    (the current fill level).  Writes the new K/V into the caches in place
    at ``cache_len`` and returns ``(out, k_cache, v_cache)``."""
    B = x.shape[0]
    S_max = k_cache.shape[1]
    q, k, v = _project_qkv(p, x, x, cfg)          # q: [B,1,H,hd], k/v: [B,1,kv,hd]
    if use_rope:
        pos = cache_len.reshape(1, 1).expand(B, 1)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    if update_cache:
        check_cache_index(cache_len, S_max)
        index = cache_len.reshape(1).long()
        k_cache.index_copy_(1, index, k.to(k_cache.dtype))
        v_cache.index_copy_(1, index, v.to(v_cache.dtype))
    out = _attend_cache(q, k_cache, v_cache, cache_len, cfg)
    out = out.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"].to(out.dtype), k_cache, v_cache


def _attend_cache(q, k_cache, v_cache, cache_len, cfg):
    """q ``[B,1,H,hd]`` against whole-head caches ``[B,S,KV,hd]``,
    positions ``<= cache_len``: the decode kernel under ``"cuda"``, else
    the reference's plain decode."""
    if cfg.attention_impl == "cuda":
        return ops.mha_decode(q, k_cache, v_cache, cache_len)
    n_rep = q.shape[2] // k_cache.shape[2]
    kk = _repeat_kv(k_cache, n_rep)
    vv = _repeat_kv(v_cache, n_rep)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * scale
    valid = torch.arange(k_cache.shape[1], device=q.device) <= cache_len
    logits = torch.where(valid, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv)


def attention_decode_sharded(p: Params, x, cfg, k_cache, v_cache,
                             cache_len, part, layout: str = "head",
                             s_lo: int = 0, write: bool = True):
    """:func:`attention_decode` on ``part``'s block of the weights and of
    the cache (``x [B, 1, d]`` its rows, replicated over ``"model"``):
    its query heads ``part.block(H)``, roped at ``cache_len``, then by
    the cache's ``layout`` (``parallel/sharding.py``'s ``cache_layout``):

    - ``"head"`` (the kv heads divide the model axis): its kv heads
      projected, roped and written at ``cache_len`` into its cache ``[B,
      S, KV/m, hd]``, and the decode kernel over them;
    - ``"hd"``: every kv head projected from the replicated ``wk`` /
      ``wv`` and roped at the whole ``head_dim`` before its columns
      ``part.block(hd)`` are written into its cache ``[B, S, KV, hd/m]``;
      then :func:`_attend_hd_block`;
    - ``"seq"`` and ``"seq_hd"``: the cache holds the positions ``[s_lo,
      s_lo + S)`` of every row, whole heads or a ``head_dim`` block as
      above; the new k / v are projected and written, at ``cache_len -
      s_lo``, only where ``write`` (the caller's host mirror of the
      position says that this block holds it); then :func:`_attend_seq_block` or
      :func:`_attend_hd_block` over the block, the blocks' softmax
      combined across the data axes.

    Then ``wo``'s rows of its heads, summed over ``"model"``."""
    H, hd = cfg.n_heads, cfg.head_dim
    cdt = dtype_of(cfg.dtype)
    h_lo, h_hi = part.block(H)
    x = enter_model_region(x, part)
    B = x.shape[0]
    q = x @ p["wq"].to(cdt)
    if "bq" in p:
        q = q + p["bq"].to(cdt)
    pos = cache_len.reshape(1, 1).expand(B, 1)
    q = rope(q.reshape(B, 1, h_hi - h_lo, hd), pos, cfg.rope_theta)
    if write:
        k = x @ p["wk"].to(cdt)
        v = x @ p["wv"].to(cdt)
        if "bk" in p:
            k = k + p["bk"].to(cdt)
            v = v + p["bv"].to(cdt)
        k = rope(k.reshape(B, 1, -1, hd), pos, cfg.rope_theta)
        v = v.reshape(B, 1, -1, hd)
        local = cache_len - s_lo if s_lo else cache_len
        check_cache_index(local, k_cache.shape[1])
        index = local.reshape(1).long()
        k, v = kv_cache_blocks(k, v, cfg, part, layout)
        k_cache.index_copy_(1, index, k.to(k_cache.dtype))
        v_cache.index_copy_(1, index, v.to(v_cache.dtype))
    if layout == "head":
        out = _attend_cache(q, k_cache, v_cache, cache_len, cfg)
    elif layout == "seq":
        out = _attend_seq_block(q, k_cache, v_cache, cache_len, s_lo, cfg,
                                part)
    else:
        out = _attend_hd_block(q, k_cache, v_cache, cache_len, cfg, part,
                               s_lo if layout == "seq_hd" else None)
    out = out.reshape(B, 1, (h_hi - h_lo) * hd)
    return leave_model_region_product(torch.matmul, part, out,
                                      p["wo"].to(out.dtype))


def sum_partial_scores(scores: torch.Tensor, part) -> torch.Tensor:
    """The hd-sharded layout's partial scores summed over ``"model"``: a
    gather summed in shard order, so every participant holds the same
    bits."""
    return part.psum_model(scores)


def block_cache_len(cache_len, s_lo: int, n: int) -> torch.Tensor:
    """The index of the current token in a block of ``n`` positions that
    starts at ``s_lo``, on the device: ``cache_len - s_lo`` clamped to
    ``[-1, n - 1]`` (-1: the block starts past the token and holds no
    valid position)."""
    return (cache_len - s_lo).clamp(-1, n - 1).to(torch.int32)


def combine_over_dp(o, m, l, part) -> torch.Tensor:
    """Every data participant's block statistics ``(o [..., D], m, l
    [...])`` gathered in one gather (packed as ``[..., D + 2]`` float32)
    and combined in block order (:func:`combine_blocks`): the same bits on
    every participant."""
    D = o.shape[-1]
    packed = torch.cat([o.float(), m.float()[..., None], l.float()[..., None]],
                       dim=-1)
    g = part.all_gather_dp(packed)
    return combine_blocks(g[..., :D], g[..., D], g[..., D + 1])


def _attend_seq_block(q, k_cache, v_cache, cache_len, s_lo: int, cfg, part):
    """One-token attention of the fully-seq layout's whole-head form (a
    model axis of one): q ``[B, 1, H, hd]`` against this participant's
    block of positions ``[B, S, KV, hd]`` starting at ``s_lo``, the token
    at its block index :func:`block_cache_len`; the decode kernel's
    statistics form under ``"cuda"`` (launched on a block with no valid
    position too), else its plain version; the blocks combined across the
    data axes (:func:`combine_over_dp`), cast to q's dtype."""
    local = block_cache_len(cache_len, s_lo, k_cache.shape[1])
    if cfg.attention_impl == "cuda":
        o, m, l = ops.mha_decode_stats(q, k_cache, v_cache, local)
    else:
        o, m, l = decode_attention_stats_torch(q[:, 0], k_cache, v_cache,
                                               local)
    return combine_over_dp(o, m, l, part).to(q.dtype)[:, None]


def _attend_hd_block(q, k_cache, v_cache, cache_len, cfg, part,
                     s_lo: int | None = None):
    """One-token attention over a ``head_dim`` block of the cache ``[B, S,
    KV, hd/m]`` (every kv head, this participant's ``head_dim``
    columns): the reference's two decode products
    (``src/repro/models/layers.py:227-232``) cut along ``head_dim``.

    1. q of every head (all-gathered over ``"model"``, after rope at the
       whole ``head_dim``), its block of columns;
    2. float32 partial scores ``[B, H, S]`` against the cache block,
       summed over ``"model"`` (:func:`sum_partial_scores`);
    3. the scale ``1/sqrt(head_dim)`` of the whole head, the inclusive
       mask ``pos <= cache_len`` over the positions' global index;
    4. the hd-sharded layout (``s_lo`` None: the block is every
       position): the softmax, the probabilities (rounded to the cache's
       dtype) times the v block ``[B, H, hd/m]``; the fully-seq layout
       (the block starts at ``s_lo``): the block's ``m`` (max), ``l = Σ
       p`` and ``Σ round(p)·v / l`` with ``p = exp(score − m)``, combined
       across the data axes (:func:`combine_over_dp`);
    5. all-gathered over ``"model"``, the blocks joined along ``head_dim``
       in model order, this participant's heads kept.

    The decode kernel does not run here: its function is whole-head
    attention (and it takes ``head_dim`` 64 or 128 only).  Returns
    ``[B, 1, H/m, hd]``."""
    B, S, KV, _ = k_cache.shape
    H, hd = cfg.n_heads, cfg.head_dim
    lo, hi = part.block(hd)
    h_lo, h_hi = part.block(H)
    q_all = torch.cat(list(part.all_gather_model(q[:, 0]).unbind(0)), dim=1)
    qb = q_all[..., lo:hi].float().reshape(B, KV, H // KV, hi - lo)
    scores = torch.einsum("bgrd,bsgd->bgrs", qb, k_cache.float())
    scores = sum_partial_scores(scores, part) * (1.0 / math.sqrt(hd))
    valid = (torch.arange(S, device=q.device) + (s_lo or 0)) <= cache_len
    scores = torch.where(valid, scores, -1e30)
    if s_lo is None:
        probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
        o = torch.einsum("bgrs,bsgd->bgrd", probs.float(), v_cache.float())
    else:
        m = scores.amax(dim=-1)
        p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
        l = p.sum(dim=-1)
        o = torch.einsum("bgrs,bsgd->bgrd", p.to(v_cache.dtype).float(),
                         v_cache.float()) / l.clamp_min(1e-30)[..., None]
        o = combine_over_dp(o, m, l, part)
    o = o.reshape(B, H, hi - lo).to(q.dtype)
    o = torch.cat(list(part.all_gather_model(o).unbind(0)), dim=-1)
    return o[:, None, h_lo:h_hi]


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_shapes(cfg, d_ff: int | None = None) -> dict[str, tuple]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    return {"norm_scale": (d,), "w_gate": (d, ff), "w_up": (d, ff),
            "w_down": (ff, d)}


def mlp_init(gen, cfg, n_blocks: int, device, d_ff: int | None = None,
             leaf=_kept):
    pdt = dtype_of(cfg.param_dtype)
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    p: Params = {}
    for name, shape in mlp_shapes(cfg, d_ff).items():
        shape = (n_blocks, *shape)
        if name == "norm_scale":
            t = torch.ones(shape, dtype=pdt, device=device)
        else:
            t = _normal(gen, shape, out_scale if name == "w_down" else 0.02,
                        pdt, device)
        p[name] = leaf(name, t)
    return p


def mlp_apply(p: Params, x, part=None):
    """SwiGLU; with a participant ``part``, over its ``d_ff`` columns."""
    if part is not None:
        x = enter_model_region(x, part)
    cdt = x.dtype
    g = x @ p["w_gate"].to(cdt)
    u = x @ p["w_up"].to(cdt)
    if part is None:
        return (F.silu(g) * u) @ p["w_down"].to(cdt)
    return leave_model_region_product(torch.matmul, part, F.silu(g) * u,
                                      p["w_down"].to(cdt))
