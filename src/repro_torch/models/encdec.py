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
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from .config import ModelConfig
from .layers import (
    _project_qkv,
    _repeat_kv,
    attend,
    attention_apply,
    attention_decode,
    attention_init,
    attention_shapes,
    check_cache_index,
    dense_attention,
    dtype_of,
    mlp_apply,
    mlp_init,
    mlp_shapes,
    rmsnorm,
    rope,
)
from .lm import (
    _positions,
    cross_entropy,
    embed_inputs,
    head_logits,
    meta_tree,
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
                device: torch.device) -> Params:
    """Random parameters in ``cfg.param_dtype`` on ``device``, drawn from
    ``generator`` (the reference's scales; not its numbers)."""
    pdt = dtype_of(cfg.param_dtype)
    d, V = cfg.d_model, cfg.vocab_padded

    def normal(shape):
        return torch.randn(shape, generator=generator,
                           device=device).mul_(0.02).to(pdt)
    enc, dec = cfg.enc_layers, cfg.n_layers
    return {
        "embed": normal((V, d)), "head": normal((d, V)),
        "enc_final_norm": torch.ones(d, dtype=pdt, device=device),
        "final_norm": torch.ones(d, dtype=pdt, device=device),
        "enc_blocks": {"attn": attention_init(generator, cfg, enc, device),
                       "mlp": mlp_init(generator, cfg, enc, device)},
        "dec_blocks": {
            "self_attn": attention_init(generator, cfg, dec, device),
            "cross_attn": attention_init(generator, cfg, dec, device),
            "mlp": mlp_init(generator, cfg, dec, device)},
    }


def _layer(blocks: Params, i: int) -> Params:
    return {k: {n: t[i] for n, t in slot.items()}
            for k, slot in blocks.items()}


def _enc_block(params: Params, cfg: ModelConfig, i: int, x, positions):
    bp = _layer(params["enc_blocks"], i)
    h = rmsnorm(x, bp["attn"]["norm_scale"], cfg.norm_eps)
    x = x + attention_apply(bp["attn"], h, cfg, positions=positions,
                            causal=False)
    h = rmsnorm(x, bp["mlp"]["norm_scale"], cfg.norm_eps)
    return x + mlp_apply(bp["mlp"], h)


def encode(params: Params, cfg: ModelConfig,
           enc_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder over the frame embeddings ``[B, T_enc, d]``; with
    ``cfg.remat`` and gradients enabled, each layer under
    ``torch.utils.checkpoint`` (as :func:`repro_torch.models.lm.forward`)."""
    x = enc_embeds.to(dtype_of(cfg.dtype))
    positions = _positions(x.shape[0], x.shape[1], x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.enc_layers):
        if remat:
            x = checkpoint(_enc_block, params, cfg, i, x, positions,
                           use_reentrant=False)
        else:
            x = _enc_block(params, cfg, i, x, positions)
    return rmsnorm(x, params["enc_final_norm"], cfg.norm_eps)


def _dec_block(params: Params, cfg: ModelConfig, i: int, x, enc_out,
               positions):
    bp = _layer(params["dec_blocks"], i)
    h = rmsnorm(x, bp["self_attn"]["norm_scale"], cfg.norm_eps)
    x = x + attention_apply(bp["self_attn"], h, cfg, positions=positions)
    h = rmsnorm(x, bp["cross_attn"]["norm_scale"], cfg.norm_eps)
    x = x + attention_apply(bp["cross_attn"], h, cfg, positions=positions,
                            causal=False, x_kv=enc_out, use_rope=False)
    h = rmsnorm(x, bp["mlp"]["norm_scale"], cfg.norm_eps)
    return x + mlp_apply(bp["mlp"], h)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            enc_embeds: torch.Tensor):
    """Decoder logits ``[B, S_dec, V]`` over ``tokens [B, S_dec]`` given
    the frame embeddings, and zero MoE aux terms (as the reference)."""
    enc_out = encode(params, cfg, enc_embeds)
    x = embed_inputs(params, cfg, tokens)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        if remat:
            x = checkpoint(_dec_block, params, cfg, i, x, enc_out, positions,
                           use_reentrant=False)
        else:
            x = _dec_block(params, cfg, i, x, enc_out, positions)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return head_logits(params, cfg, x), MoeAux(
        zero, zero, torch.zeros(1, device=x.device))


def loss_fn(params: Params, cfg: ModelConfig, batch: dict):
    """Next-token cross-entropy over the decoder tokens; labels < 0 are
    ignored.  Returns ``(loss, {"loss", "ce"})``."""
    logits, _ = forward(params, cfg, batch["tokens"], batch["enc_embeds"])
    labels = batch["labels"]
    valid = labels >= 0
    nll = cross_entropy(logits, labels.clamp_min(0))
    ce = torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)
    return ce, {"loss": ce, "ce": ce}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _project_kv(p: Params, x_kv, cfg):
    """The K and V projections of :func:`~.layers._project_qkv`."""
    cdt = dtype_of(cfg.dtype)
    k, v = x_kv @ p["wk"].to(cdt), x_kv @ p["wv"].to(cdt)
    if "bk" in p:
        k, v = k + p["bk"].to(cdt), v + p["bv"].to(cdt)
    B, S = x_kv.shape[:2]
    return (k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim))


def init_cache(params: Params, cfg: ModelConfig, enc_embeds: torch.Tensor,
               max_len: int) -> dict:
    """Encode, project every decoder layer's cross K/V once, and allocate
    the decoder's self-attention cache."""
    enc_out = encode(params, cfg, enc_embeds)
    B, T = enc_out.shape[:2]
    cdt, dev = dtype_of(cfg.dtype), enc_out.device
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    cross = {n: torch.empty((L, B, T, kv, hd), dtype=cdt, device=dev)
             for n in ("k", "v")}
    for i in range(L):
        p = {n: t[i] for n, t in params["dec_blocks"]["cross_attn"].items()}
        cross["k"][i], cross["v"][i] = _project_kv(p, enc_out, cfg)
    self_shape = (L, B, max_len, kv, hd)
    return {
        "len": torch.zeros((), dtype=torch.int32, device=dev), "pos": 0,
        "self": {n: torch.zeros(self_shape, dtype=cdt, device=dev)
                 for n in ("k", "v")},
        "cross": cross,
        "cross_len": torch.full((), T - 1, dtype=torch.int32, device=dev),
    }


def _cross_attend(p: Params, h, cfg: ModelConfig, k, v, cross_len=None):
    """Cross-attention of ``h [B, S, d]`` over a layer's cross cache
    ``[B, T_enc, KV, hd]``.  ``"cuda"``: the flash kernel, or with
    ``cross_len`` (a decode step) the decode kernel over all ``T_enc``
    positions; otherwise the reference's dense form."""
    cdt = h.dtype
    B, S = h.shape[:2]
    q = (h @ p["wq"].to(cdt)).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.attention_impl != "cuda":
        n_rep = cfg.n_heads // cfg.n_kv_heads
        out = dense_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                              causal=False)
    elif cross_len is None:
        out = ops.mha_flash(q, k, v, causal=False)
    else:
        out = ops.mha_decode(q, k, v, cross_len)
    return out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"].to(cdt)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: dict):
    """The decoder prompt against the cross cache, filling the self cache
    in place (K/V at ``[:S]``, zeros after).  Returns the last position's
    logits and the cache."""
    x = embed_inputs(params, cfg, tokens)
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    if S > cache["self"]["k"].shape[2]:
        raise ValueError(f"prompt of {S} tokens does not fit a cache of "
                         f"{cache['self']['k'].shape[2]}")
    for i in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], i)
        h = rmsnorm(x, bp["self_attn"]["norm_scale"], cfg.norm_eps)
        q, k, v = _project_qkv(bp["self_attn"], h, h, cfg)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        out = attend(q, k, v, cfg, causal=True)
        out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
        x = x + out @ bp["self_attn"]["wo"].to(out.dtype)
        for name, t in (("k", k), ("v", v)):
            cache["self"][name][i, :, :S] = t
            cache["self"][name][i, :, S:] = 0
        h = rmsnorm(x, bp["cross_attn"]["norm_scale"], cfg.norm_eps)
        x = x + _cross_attend(bp["cross_attn"], h, cfg,
                              cache["cross"]["k"][i], cache["cross"]["v"][i])
        h = rmsnorm(x, bp["mlp"]["norm_scale"], cfg.norm_eps)
        x = x + mlp_apply(bp["mlp"], h)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(params, cfg, x[:, -1:, :])
    cache["len"] = torch.full((), S, dtype=torch.int32, device=x.device)
    cache["pos"] = S
    return logits, cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict):
    """One decoder step: ``tokens [B, 1]`` → logits ``[B, 1, V]``, the new
    K/V written into the self cache at ``len`` and ``len`` advanced.
    Raises ``IndexError`` when the self cache is full (the reference
    clamps the write index)."""
    check_cache_index(cache["pos"], cache["self"]["k"].shape[2])
    x = embed_inputs(params, cfg, tokens)
    cache_len = cache["len"]
    for i in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], i)
        h = rmsnorm(x, bp["self_attn"]["norm_scale"], cfg.norm_eps)
        out, _, _ = attention_decode(bp["self_attn"], h, cfg,
                                     cache["self"]["k"][i],
                                     cache["self"]["v"][i], cache_len)
        x = x + out
        h = rmsnorm(x, bp["cross_attn"]["norm_scale"], cfg.norm_eps)
        x = x + _cross_attend(bp["cross_attn"], h, cfg,
                              cache["cross"]["k"][i], cache["cross"]["v"][i],
                              cache["cross_len"])
        h = rmsnorm(x, bp["mlp"]["norm_scale"], cfg.norm_eps)
        x = x + mlp_apply(bp["mlp"], h)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = head_logits(params, cfg, x)
    cache["len"] = cache_len + 1
    cache["pos"] += 1
    return logits, cache


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameter tree as ``meta`` tensors (shapes and dtypes, no
    allocation)."""
    return meta_tree(param_shapes(cfg), dtype_of(cfg.param_dtype))
