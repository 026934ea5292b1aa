"""Encoder-decoder assembly (seamless-m4t backbone).

The JAX package's ``models/encdec.py`` over PyTorch tensors, with its
parameter keys, so its parameters carry across key for key
(:func:`repro_torch.convert.lm_params_from_numpy`).  The audio frontend is
a stub, as in the reference: the encoder takes precomputed frame
embeddings ``[B, T_enc, d]``.  Encoder layers are bidirectional
self-attention (with RoPE) + MLP; decoder layers are causal
self-attention + cross-attention over the encoder output (no RoPE) + MLP,
all with the config's GQA geometry.  Serving: :func:`init_cache` encodes
once and projects every decoder layer's cross K/V, then :func:`prefill`
and :func:`decode_step` run the decoder against the self-attention cache
and the static cross cache.

Under ``attention_impl="cuda"`` every attention runs a kernel: the flash
kernel (K2) for the encoder (non-causal, ``Sq = Sk = T_enc``), the
decoder's self-attention in ``forward`` and ``prefill`` (causal) and its
cross-attention there (non-causal, ``Sq = S``, ``Sk = T_enc``); a decode
step's self-attention runs the decode kernel (K3) over the self cache and
its cross-attention K3 over the cross cache with ``cache_len = T_enc − 1``
(K3's mask is inclusive: all ``T_enc`` positions), writing nothing.  The
reference never reaches its kernels on these paths: its cross-attention
is ``dense_attention`` and its prefill's self-attention dense or blocked,
which the port's ``"dense"`` / ``"blocked"`` keep.

The cache holds ``"len"`` (a 0-d int32 on the device) and ``"pos"`` (the
same number on the host, which bounds the writes without reading the
device), ``"self"`` and ``"cross"`` (``k`` / ``v`` stacked over the
decoder's layers, ``[L, B, S, KV, hd]``) and ``"cross_len"`` (``T_enc −
1``, the cross cache's last index, as a 0-d int32 on the device).

Every entry point also runs as one participant of a data × model mesh
(``part``, a :class:`~repro_torch.parallel.tensor.Participant`), as
:mod:`.lm` does: its block of every parameter (``parallel/sharding.py``'s
rules, which cut this tree's leaves by name), its rows of the batch
(``batch_specs(..., encdec=True)`` splits ``enc_embeds`` over the data
axes as it does the tokens).  The encoder's self-attention (non-causal,
rope), the decoder's self-attention and every MLP run on the
participant's heads and ``d_ff`` columns in model regions; its
cross-attention takes the participant's query heads and projects k / v
from the encoder's output (replicated over ``"model"``, its gradient
summed over it) on the kv heads they read; the embedding, the head and
the loss are vocabulary-parallel (``lm.embed_inputs``,
``lm.head_logits``, ``vocab_parallel_cross_entropy``).  Serving:
``init_cache`` encodes the participant's rows and keeps its block of the
cache as ``cache_shardings`` cuts it (``k`` / ``v`` of ``"self"`` and of
``"cross"`` alike take the attention layout ``cache_layout`` names:
its kv heads in ``"head"``, a ``head_dim`` block of every kv head in
``"hd"``); ``prefill`` and ``decode_step`` take the whole batch and return
its rows' logits over the whole vocabulary.  In ``"hd"`` the prefill's
cross-attention gathers the cross cache's blocks of its layer over
``"model"`` (K2 takes whole heads) and a step's runs the reference's
decode products cut along ``head_dim`` (``layers._attend_hd_block``).

A batch that no data axis divides takes the fully-seq layout (``"seq"``
at a model axis of one, ``"seq_hd"`` above it), as :mod:`.lm` does: every
participant takes every row (``lm.rows_part``), and both caches split
their positions over the data axes: the self cache its ``max_len``
positions, the cross cache its *encoder* positions (the reference's spec
``P(None, None, dp, None, "model" | None)`` for every ``k`` / ``v``).  A
sharded cache also holds ``"max_len"`` and ``"frames"``, the two whole
lengths.  ``init_cache`` projects every decoder layer's cross k / v over
all frames and keeps its block (:func:`cross_block`); the prefill writes
the prompt positions that fall in its self block and, since K2 takes
whole heads and every position, gathers each layer's cross blocks over
the data axes (and over ``"model"`` in ``"seq_hd"``); a step writes its
token where the host mirror says its self block holds the position and
runs both attentions over its blocks, the cross one from the block's
start, by the decode kernel's statistics form (``"seq"``) or the
``head_dim`` products (``"seq_hd"``), the blocks' softmax combined
across the data axes (``layers.combine_over_dp``).  A length that would
leave a block of either cache empty raises ``ValueError`` before any
collective.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import cache_layout, cache_shardings, shard_slices
from ..parallel.tensor import (
    enter_model_region,
    leave_model_region_product,
    vocab_parallel_cross_entropy,
)
from .config import ModelConfig
from .layers import (
    _attend_hd_block,
    _attend_seq_block,
    _attention_sharded,
    _project_qkv,
    attend,
    attend_cross,
    attention_apply,
    attention_decode,
    attention_decode_sharded,
    attention_init,
    attention_shapes,
    check_cache_index,
    dtype_of,
    kv_cache_blocks,
    local_kv,
    mlp_apply,
    mlp_init,
    mlp_shapes,
    rmsnorm,
    rope,
)
from .lm import (
    FULLY_SEQ,
    _positions,
    _step_logits,
    batch_block,
    check_seq_blocks,
    check_shardable,
    cross_entropy,
    embed_inputs,
    head_logits,
    meta_tree,
    rows_part,
)
from .moe import MoeAux

Params = dict[str, Any]


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes, keyed as :func:`init_params` keys it
    (the reference's keys; the head is never tied)."""
    def stacked(shapes, n):
        return {k: (n, *s) for k, s in shapes.items()}
    attn, mlp = attention_shapes(cfg), mlp_shapes(cfg)
    d, V = cfg.d_model, cfg.vocab_padded
    return {
        "embed": (V, d), "head": (d, V),
        "enc_final_norm": (d,), "final_norm": (d,),
        "enc_blocks": {"attn": stacked(attn, cfg.enc_layers),
                       "mlp": stacked(mlp, cfg.enc_layers)},
        "dec_blocks": {"self_attn": stacked(attn, cfg.n_layers),
                       "cross_attn": stacked(attn, cfg.n_layers),
                       "mlp": stacked(mlp, cfg.n_layers)},
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device, leaf=None) -> Params:
    """Random parameters in ``cfg.param_dtype`` on ``device``, drawn from
    ``generator`` (the reference's scales; not its numbers); ``leaf`` as
    :func:`repro_torch.models.lm.init_params` takes it."""
    pdt = dtype_of(cfg.param_dtype)
    d, V = cfg.d_model, cfg.vocab_padded
    put = leaf or (lambda path, t: t)

    def normal(shape):
        return torch.randn(shape, generator=generator,
                           device=device).mul_(0.02).to(pdt)

    def slot(blocks, key, init, n):
        return init(generator, cfg, n, device,
                    leaf=lambda name, t: put((blocks, key, name), t))
    enc, dec = cfg.enc_layers, cfg.n_layers
    return {
        "embed": put(("embed",), normal((V, d))),
        "head": put(("head",), normal((d, V))),
        "enc_final_norm": put(("enc_final_norm",), torch.ones(
            d, dtype=pdt, device=device)),
        "final_norm": put(("final_norm",), torch.ones(
            d, dtype=pdt, device=device)),
        "enc_blocks": {"attn": slot("enc_blocks", "attn", attention_init,
                                    enc),
                       "mlp": slot("enc_blocks", "mlp", mlp_init, enc)},
        "dec_blocks": {
            "self_attn": slot("dec_blocks", "self_attn", attention_init,
                              dec),
            "cross_attn": slot("dec_blocks", "cross_attn", attention_init,
                               dec),
            "mlp": slot("dec_blocks", "mlp", mlp_init, dec)},
    }


def _layer(blocks: Params, i: int) -> Params:
    return {k: {n: t[i] for n, t in slot.items()}
            for k, slot in blocks.items()}


def _enc_block(params: Params, cfg: ModelConfig, i: int, x, positions,
               part=None):
    bp = _layer(params["enc_blocks"], i)
    h = rmsnorm(x, bp["attn"]["norm_scale"], cfg.norm_eps)
    x = x + attention_apply(bp["attn"], h, cfg, positions=positions,
                            causal=False, part=part)
    h = rmsnorm(x, bp["mlp"]["norm_scale"], cfg.norm_eps)
    return x + mlp_apply(bp["mlp"], h, part)


def encode(params: Params, cfg: ModelConfig, enc_embeds: torch.Tensor,
           part=None) -> torch.Tensor:
    """The encoder over the frame embeddings ``[B, T_enc, d]``; with
    ``cfg.remat`` and gradients enabled, each layer under
    ``torch.utils.checkpoint`` (as :func:`repro_torch.models.lm.forward`).
    With ``part`` (module doc), on its block of the weights; the output
    is replicated over ``"model"``."""
    x = enc_embeds.to(dtype_of(cfg.dtype))
    positions = _positions(x.shape[0], x.shape[1], x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.enc_layers):
        if remat:
            x = checkpoint(_enc_block, params, cfg, i, x, positions, part,
                           use_reentrant=False)
        else:
            x = _enc_block(params, cfg, i, x, positions, part)
    return rmsnorm(x, params["enc_final_norm"], cfg.norm_eps)


def _dec_block(params: Params, cfg: ModelConfig, i: int, x, enc_out,
               positions, part=None):
    bp = _layer(params["dec_blocks"], i)
    h = rmsnorm(x, bp["self_attn"]["norm_scale"], cfg.norm_eps)
    x = x + attention_apply(bp["self_attn"], h, cfg, positions=positions,
                            part=part)
    h = rmsnorm(x, bp["cross_attn"]["norm_scale"], cfg.norm_eps)
    x = x + attention_apply(bp["cross_attn"], h, cfg, positions=positions,
                            causal=False, x_kv=enc_out, use_rope=False,
                            part=part)
    h = rmsnorm(x, bp["mlp"]["norm_scale"], cfg.norm_eps)
    return x + mlp_apply(bp["mlp"], h, part)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            enc_embeds: torch.Tensor, part=None):
    """Decoder logits ``[B, S_dec, V]`` over ``tokens [B, S_dec]`` given
    the frame embeddings, and zero MoE aux terms (as the reference).  With
    ``part`` (module doc), its rows' logits, its block of the vocabulary."""
    if part is not None:
        check_shardable(cfg, part.m)
    enc_out = encode(params, cfg, enc_embeds, part)
    if part is not None:        # read by every layer's cross-attention
        enc_out = enter_model_region(enc_out, part)
    x = embed_inputs(params, cfg, tokens, part=part)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        if remat:
            x = checkpoint(_dec_block, params, cfg, i, x, enc_out, positions,
                           part, use_reentrant=False)
        else:
            x = _dec_block(params, cfg, i, x, enc_out, positions, part)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return head_logits(params, cfg, x, part), MoeAux(
        zero, zero, torch.zeros(1, device=x.device))


def loss_fn(params: Params, cfg: ModelConfig, batch: dict, part=None):
    """Next-token cross-entropy over the decoder tokens; labels < 0 are
    ignored.  Returns ``(loss, {"loss", "ce"})``.  With ``part`` (module
    doc), as :func:`repro_torch.models.lm.loss_fn` takes it: the
    participant's part of the loss (the vocabulary-parallel
    cross-entropy, the denominator the whole batch's valid labels) and
    the whole batch's metrics."""
    logits, _ = forward(params, cfg, batch["tokens"], batch["enc_embeds"],
                        part)
    labels = batch["labels"]
    valid = labels >= 0
    if part is None:
        nll = cross_entropy(logits, labels.clamp_min(0))
        ce = torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)
        return ce, {"loss": ce, "ce": ce}
    nll = vocab_parallel_cross_entropy(logits, labels.clamp_min(0), part,
                                       cfg.vocab_padded)
    denom = part.psum_dp(valid.sum()).clamp_min(1)
    ce = torch.where(valid, nll, 0.0).sum() * part.dp / denom
    whole = part.pmean_dp(ce.detach()[None])[0]
    return ce, {"loss": whole, "ce": whole}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _project_kv(p: Params, x_kv, cfg):
    """The K and V projections of :func:`~.layers._project_qkv` (on a
    participant's block of ``wk`` / ``wv``: its columns' kv heads)."""
    cdt = dtype_of(cfg.dtype)
    k, v = x_kv @ p["wk"].to(cdt), x_kv @ p["wv"].to(cdt)
    if "bk" in p:
        k, v = k + p["bk"].to(cdt), v + p["bv"].to(cdt)
    B, S = x_kv.shape[:2]
    return (k.reshape(B, S, -1, cfg.head_dim),
            v.reshape(B, S, -1, cfg.head_dim))


def cross_block(part, frames: int) -> tuple[int, int]:
    """``[lo, hi)``: the encoder positions of the cross cache that ``part``
    holds in the fully-seq layout (its data block, as ``cache_shardings``
    cuts the whole cross cache)."""
    return part.dp_block(frames)


def cache_size(cache: dict) -> int:
    """The whole length of the self cache (a participant's block may hold
    fewer positions)."""
    return cache.get("max_len", cache["self"]["k"].shape[2])


def init_cache(params: Params, cfg: ModelConfig, enc_embeds: torch.Tensor,
               max_len: int, part=None) -> dict:
    """Encode, project every decoder layer's cross K/V once, and allocate
    the decoder's self-attention cache.  With ``part`` (module doc), given
    every row of ``enc_embeds``: its rows encoded, its block of the cross
    and self caches."""
    n, frames = enc_embeds.shape[:2]
    layout = None
    if part is not None:
        check_shardable(cfg, part.m)
        layout = cache_layout(cfg, part.mesh, n)
        if layout in FULLY_SEQ:
            check_seq_blocks(max_len, part, "a self cache")
            check_seq_blocks(frames, part, "a cross cache")
        part = rows_part(part, n)
        enc_embeds = batch_block(enc_embeds, part)
    enc_out = encode(params, cfg, enc_embeds, part)
    B, T = enc_out.shape[:2]
    cdt, dev = dtype_of(cfg.dtype), enc_out.device
    lo, hi = cross_block(part, T) if layout in FULLY_SEQ else (0, T)
    L = cfg.n_layers
    ks, vs = [], []
    for i in range(L):
        p = {n: t[i] for n, t in params["dec_blocks"]["cross_attn"].items()}
        k, v = _project_kv(p, enc_out, cfg)
        if part is not None:
            k, v = kv_cache_blocks(k, v, cfg, part, layout)
        ks.append(k[:, lo:hi].to(cdt))
        vs.append(v[:, lo:hi].to(cdt))
    cross = {"k": torch.stack(ks), "v": torch.stack(vs)}
    self_shape = (L, B, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {"len": torch.zeros((), dtype=torch.int32, device=dev), "pos": 0}
    if part is not None:
        whole = torch.empty((L, n, max_len, cfg.n_kv_heads, cfg.head_dim),
                            dtype=cdt, device="meta")
        sh = cache_shardings(cfg, part.mesh, {"k": whole}, n)
        self_shape = tuple(sl.stop - sl.start for sl in shard_slices(
            whole.shape, sh["k"], part.coord))
        cache.update(max_len=max_len, frames=T)
    return {
        **cache,
        "self": {n: torch.zeros(self_shape, dtype=cdt, device=dev)
                 for n in ("k", "v")},
        "cross": cross,
        "cross_len": torch.full((), T - 1, dtype=torch.int32, device=dev),
    }


def _whole_cross(k, v, part, layout: str, frames: int):
    """A layer's whole cross k / v ``[B, frames, KV, hd]`` from the
    participants' blocks: joined along ``head_dim`` over ``"model"`` (in
    ``"hd"`` and ``"seq_hd"``), then along the encoder positions over the
    data axes (in the fully-seq layouts; each block padded to the
    ceil-divided length first), k and v in one gather each."""
    kv = torch.stack([k, v])
    if layout in ("hd", "seq_hd"):
        kv = torch.cat(list(part.all_gather_model(kv).unbind(0)), dim=-1)
    if layout in FULLY_SEQ:
        c = -(-frames // part.dp)
        kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, c - kv.shape[2]))
        kv = torch.cat(list(part.all_gather_dp(kv).unbind(0)),
                       dim=2)[:, :, :frames]
    return kv.unbind(0)


def _cross_attend(p: Params, h, cfg: ModelConfig, k, v, cross_len=None,
                  part=None, layout: str | None = None,
                  frames: int | None = None):
    """Cross-attention of ``h [B, S, d]`` over a layer's cross cache
    ``[B, T_enc, KV, hd]`` (:func:`~.layers.attend_cross`: the flash
    kernel, or with ``cross_len`` (a decode step) the decode kernel over
    all ``T_enc`` positions, under ``"cuda"``; otherwise the reference's
    dense form).  With ``part``, its query heads over its block of the
    cross cache in ``layout`` (module doc; ``frames`` the whole cache's
    encoder positions), ``wo``'s rows summed over ``"model"``."""
    cdt = h.dtype
    B, S = h.shape[:2]
    if part is None:
        q = (h @ p["wq"].to(cdt)).reshape(B, S, cfg.n_heads, cfg.head_dim)
        out = attend_cross(q, k, v, cfg, cross_len)
        return out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"].to(
            cdt)
    h_lo, h_hi = part.block(cfg.n_heads)
    h = enter_model_region(h, part)
    q = (h @ p["wq"].to(cdt)).reshape(B, S, h_hi - h_lo, cfg.head_dim)
    if layout == "head":
        out = attend_cross(q, k, v, cfg, cross_len)
    elif cross_len is None:            # K2 takes whole heads: gather them
        k, v = _whole_cross(k, v, part, layout, frames)
        out = attend_cross(q, *local_kv(k, v, cfg, part), cfg)
    else:
        s_lo = cross_block(part, frames)[0] if layout in FULLY_SEQ else None
        if layout == "seq":
            out = _attend_seq_block(q, k, v, cross_len, s_lo, cfg, part)
        else:
            out = _attend_hd_block(q, k, v, cross_len, cfg, part, s_lo)
    out = out.reshape(B, S, (h_hi - h_lo) * cfg.head_dim)
    return leave_model_region_product(torch.matmul, part, out,
                                      p["wo"].to(cdt))


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: dict, part=None):
    """The decoder prompt against the cross cache, filling the self cache
    in place (K/V at ``[:S]``, zeros after).  Returns the last position's
    logits and the cache.  With ``part`` (module doc), its rows of the
    whole batch ``tokens`` into its cache block, and its rows' logits
    over the whole vocabulary (in the fully-seq layout every row, and the
    prompt positions that fall in its self block)."""
    layout, size = None, cache_size(cache)
    if part is not None:
        check_shardable(cfg, part.m)
        layout = cache_layout(cfg, part.mesh, tokens.shape[0])
        part = rows_part(part, tokens.shape[0])
        tokens = batch_block(tokens, part)
    x = embed_inputs(params, cfg, tokens, part=part)
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    if S > size:
        raise ValueError(f"prompt of {S} tokens does not fit a cache of "
                         f"{size}")
    lo, hi = part.dp_block(size) if layout in FULLY_SEQ else (0, size)
    n = min(max(S - lo, 0), hi - lo)
    for i in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], i)
        h = rmsnorm(x, bp["self_attn"]["norm_scale"], cfg.norm_eps)
        if part is None:
            q, k, v = _project_qkv(bp["self_attn"], h, h, cfg)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
            out = attend(q, k, v, cfg, causal=True)
            out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
            x = x + out @ bp["self_attn"]["wo"].to(out.dtype)
        else:
            out, k, v = _attention_sharded(bp["self_attn"], h, cfg,
                                           positions, True, part,
                                           kv_out=True)
            x = x + out
            k, v = kv_cache_blocks(k, v, cfg, part, layout)
        for name, t in (("k", k), ("v", v)):
            cache["self"][name][i, :, :n] = t[:, lo:lo + n]
            cache["self"][name][i, :, n:] = 0
        h = rmsnorm(x, bp["cross_attn"]["norm_scale"], cfg.norm_eps)
        x = x + _cross_attend(bp["cross_attn"], h, cfg,
                              cache["cross"]["k"][i], cache["cross"]["v"][i],
                              part=part, layout=layout,
                              frames=cache.get("frames"))
        h = rmsnorm(x, bp["mlp"]["norm_scale"], cfg.norm_eps)
        x = x + mlp_apply(bp["mlp"], h, part)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _step_logits(params, cfg, x[:, -1:, :], part)
    cache["len"] = torch.full((), S, dtype=torch.int32, device=x.device)
    cache["pos"] = S
    return logits, cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict, part=None):
    """One decoder step: ``tokens [B, 1]`` → logits ``[B, 1, V]``, the new
    K/V written into the self cache at ``len`` and ``len`` advanced.
    Raises ``IndexError`` when the self cache is full (the reference
    clamps the write index; a participant checks its host mirror, the
    same on every one, against the whole length).  With ``part`` (module
    doc), its rows of ``tokens`` and its rows' logits over the whole
    vocabulary; in the fully-seq layout the new k / v are written only by
    the participants whose self block holds the position."""
    size = cache_size(cache)
    check_cache_index(cache["pos"], size)
    layout, lo, write = None, 0, True
    if part is not None:
        check_shardable(cfg, part.m)
        layout = cache_layout(cfg, part.mesh, tokens.shape[0])
        part = rows_part(part, tokens.shape[0])
        tokens = batch_block(tokens, part)
        if layout in FULLY_SEQ:
            lo, hi = part.dp_block(size)
            write = lo <= cache["pos"] < hi
    x = embed_inputs(params, cfg, tokens, part=part)
    cache_len = cache["len"]
    for i in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], i)
        h = rmsnorm(x, bp["self_attn"]["norm_scale"], cfg.norm_eps)
        k_i, v_i = cache["self"]["k"][i], cache["self"]["v"][i]
        if part is None:
            out, _, _ = attention_decode(bp["self_attn"], h, cfg, k_i, v_i,
                                         cache_len)
        else:
            out = attention_decode_sharded(bp["self_attn"], h, cfg, k_i,
                                           v_i, cache_len, part, layout, lo,
                                           write)
        x = x + out
        h = rmsnorm(x, bp["cross_attn"]["norm_scale"], cfg.norm_eps)
        x = x + _cross_attend(bp["cross_attn"], h, cfg,
                              cache["cross"]["k"][i], cache["cross"]["v"][i],
                              cache["cross_len"], part, layout,
                              cache.get("frames"))
        h = rmsnorm(x, bp["mlp"]["norm_scale"], cfg.norm_eps)
        x = x + mlp_apply(bp["mlp"], h, part)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _step_logits(params, cfg, x, part)
    cache["len"] = cache_len + 1
    cache["pos"] += 1
    return logits, cache


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameter tree as ``meta`` tensors (shapes and dtypes, no
    allocation)."""
    return meta_tree(param_shapes(cfg), dtype_of(cfg.param_dtype))
