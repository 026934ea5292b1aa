"""Decoder-only LM assembly (dense / GQA / MoE / SSM / hybrid).

Layers run as a Python loop over *pattern blocks* (``cfg.pattern()``
repeated ``cfg.n_blocks`` times) with per-slot parameters stacked on a
leading ``[n_blocks]`` axis — the JAX package's layout, so its parameters
carry across key for key (:func:`repro_torch.convert.lm_params_from_numpy`).
A slot is a mixer (``attn`` or ``ssm``) or an FFN (``mlp`` or ``moe``).

Entry points:
  init_params(cfg, generator, device)     → params dict
  forward(params, cfg, tokens, ...)       → (logits, MoeAux)  (train/eval)
  loss_fn(params, cfg, batch)             → (loss, metrics)
  init_cache(cfg, batch, max_len, device) → decode cache dict
  prefill(params, cfg, tokens, cache, ...)→ (logits, cache)
  decode_step(params, cfg, tokens, cache) → (logits, cache)
  abstract_params(cfg)                    → the params as ``meta`` tensors

The cache holds ``"len"`` (a 0-d int32 tensor on the device, the fill
level the kernels read), ``"pos"`` (the same number on the host, which
bounds the writes without reading the device) and ``"slots"``: K/V caches
for attention slots, the conv shift registers and the float32 SSD state
for SSM slots.  Prefill and decode write them in place and return the same
dict.  Only attention slots bound the length.

``forward`` and ``loss_fn`` also run as one participant of a data × model
mesh (``part``, a :class:`~repro_torch.parallel.tensor.Participant`):
its block of every parameter (``parallel/sharding.py``'s rules), its rows
of the batch.  The embedding is vocabulary-sharded (a masked lookup of
the participant's rows, summed over ``"model"``), the logits too (the
head's columns, or the tied embedding's rows), and the loss is the
vocabulary-parallel cross-entropy over them; the layers run their blocks
in model regions (:mod:`.layers`, :mod:`.moe`, :mod:`.ssd`).  The loss a
participant returns is its part of the whole batch's: its mean over the
data axes is that loss, and so is its gradients' mean.  Without ``part``
the code and its bits are the unsharded ones.

``init_cache``, ``prefill`` and ``decode_step`` run so too, as the JAX
package's ``prefill_step`` / ``decode_step`` cells jitted with
``cache_shardings``: the participant allocates and fills its block of
every cache slot, takes its rows of the (whole) batch it is given, and
returns its rows' logits over the whole vocabulary (gathered over
``"model"``).  The attention cache takes the layout ``cache_layout``
names: head-sharded where the kv heads divide the model axis, else
sharded over ``head_dim``; where the batch does not divide over the data
axes, fully-seq: every participant takes every row (``batch_specs``
replicates them), and its cache block is a block of the positions
(``[s_lo, s_hi)`` of ``part.dp_block``), whole heads or a ``head_dim``
block.  A sharded cache also holds ``"max_len"``, its whole length.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree
from ..parallel.sharding import cache_layout, cache_shardings, shard_slices
from ..parallel.tensor import (
    enter_model_region,
    gather_vocab,
    leave_model_region,
    vocab_parallel_cross_entropy,
)
from .config import ModelConfig
from .layers import (
    _attention_sharded,
    _project_qkv,
    attend,
    attention_apply,
    attention_decode,
    attention_decode_sharded,
    attention_init,
    attention_shapes,
    check_cache_index,
    dtype_of,
    kv_cache_blocks,
    mlp_apply,
    mlp_init,
    mlp_shapes,
    rmsnorm,
    rope,
)
from .moe import MoeAux, check_part, moe_apply, moe_init, moe_shapes
from .ssd import SsmState, ssm_apply, ssm_decode, ssm_init, ssm_shapes

Params = dict[str, Any]

_SHAPES = {"attn": attention_shapes, "mlp": mlp_shapes, "moe": moe_shapes,
           "ssm": ssm_shapes}
_INIT = {"attn": attention_init, "mlp": mlp_init, "moe": moe_init,
         "ssm": ssm_init}


def _slot_keys(cfg: ModelConfig) -> list[tuple[str, str, str]]:
    """[(key, kind, role)] per pattern slot: mixer then ffn."""
    out = []
    for i, slot in enumerate(cfg.pattern()):
        out.append((f"L{i}_{slot.mixer}", slot.mixer, "mixer"))
        if slot.ffn:
            out.append((f"L{i}_{slot.ffn}", slot.ffn, "ffn"))
    return out


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes, keyed as :func:`init_params` keys it."""
    shapes: dict = {"embed": (cfg.vocab_padded, cfg.d_model),
                    "final_norm": (cfg.d_model,), "blocks": {}}
    if not cfg.tie_embeddings:
        shapes["head"] = (cfg.d_model, cfg.vocab_padded)
    for skey, kind, _role in _slot_keys(cfg):
        shapes["blocks"][skey] = {
            k: (cfg.n_blocks, *s) for k, s in _SHAPES[kind](cfg).items()
        }
    return shapes


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device, leaf=None) -> Params:
    """Random parameters in ``cfg.param_dtype`` on ``device``, drawn from
    ``generator`` (whose device must be ``device``).  The JAX package draws
    from ``jax.random``: the two give different numbers from one seed.
    ``leaf(path, tensor)``: applied to each leaf (``path`` its tuple of
    keys) as soon as it is drawn, before the next is: the tree holds what
    it returns, the same draws whatever it does (a participant keeps its
    block of a model whose whole tree would not fit)."""
    pdt = dtype_of(cfg.param_dtype)
    put = leaf or (lambda path, t: t)
    params: Params = {
        "embed": put(("embed",), torch.randn(
            (cfg.vocab_padded, cfg.d_model), generator=generator,
            device=device).mul_(0.02).to(pdt)),
        "final_norm": put(("final_norm",), torch.ones(
            cfg.d_model, dtype=pdt, device=device)),
        "blocks": {},
    }
    if not cfg.tie_embeddings:
        params["head"] = put(("head",), torch.randn(
            (cfg.d_model, cfg.vocab_padded), generator=generator,
            device=device).mul_(0.02).to(pdt))
    for skey, kind, _role in _slot_keys(cfg):
        params["blocks"][skey] = _INIT[kind](
            generator, cfg, cfg.n_blocks, device,
            leaf=lambda name, t, skey=skey: put(("blocks", skey, name), t))
    return params


def _block(params: Params, i: int) -> Params:
    return {k: {n: t[i] for n, t in slot.items()}
            for k, slot in params["blocks"].items()}


# ---------------------------------------------------------------------------
# full-sequence forward (training / evaluation)
# ---------------------------------------------------------------------------
def head_logits(params: Params, cfg: ModelConfig, x: torch.Tensor,
                part=None):
    """Final projection; padded vocab columns are masked to -1e30.  With
    ``part``, its block of the columns (the global index is masked)."""
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    lo = 0
    if part is not None:
        x = enter_model_region(x, part)
        lo = part.block(cfg.vocab_padded)[0]
    logits = x @ head.to(x.dtype)
    if cfg.vocab_padded != cfg.vocab:
        col = lo + torch.arange(logits.shape[-1], device=x.device)
        logits = torch.where(col >= cfg.vocab,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=x.device), logits)
    return logits


def embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 embeds: torch.Tensor | None = None,
                 part=None) -> torch.Tensor:
    """Token embedding; modality frontends prepend precomputed embeddings.
    Rows are gathered before the cast (the same values as the reference's
    cast-then-gather, without casting the whole table).  With ``part``,
    each model participant looks up the tokens its rows hold, zeros
    elsewhere, and the rows are summed over ``"model"``."""
    cdt = dtype_of(cfg.dtype)
    if part is None:
        x = params["embed"][tokens.long()].to(cdt)
    else:
        lo, hi = part.block(cfg.vocab_padded)
        ids = tokens.long() - lo
        mine = (ids >= 0) & (ids < hi - lo)
        rows = params["embed"][ids.clamp(0, max(hi - lo - 1, 0))].to(cdt)
        x = leave_model_region(torch.where(mine[..., None], rows, 0.0),
                               part)
    if embeds is not None:
        x = torch.cat([embeds.to(cdt), x], dim=1)
    return x


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _block_forward(params: Params, cfg: ModelConfig, i: int, x, aux,
                   positions, part=None):
    """Block ``i``: every slot of the pattern on the residual stream ``x``,
    the MoE aux terms added to ``aux`` in slot order."""
    bp = _block(params, i)
    for skey, kind, _role in _slot_keys(cfg):
        p = bp[skey]
        h = rmsnorm(x, p["norm_scale"], cfg.norm_eps)
        if kind == "attn":
            x = x + attention_apply(p, h, cfg, positions=positions,
                                    part=part)
        elif kind == "ssm":
            x = x + ssm_apply(p, h, cfg, part=part)
        elif kind == "mlp":
            x = x + mlp_apply(p, h, part)
        else:
            y, a = moe_apply(p, h, cfg, part)
            x = x + y
            aux = MoeAux(*(s + t for s, t in zip(aux, a)))
    return x, aux


def check_shardable(cfg: ModelConfig, m: int) -> None:
    """Raise where a model axis of ``m`` does not divide a dimension the
    sharded layers split by whole units: attention heads, the SSD's
    ``d_inner`` channels, ``d_ff`` columns, experts, the padded vocabulary
    (``shard_tree`` cuts any leaf; the layers run only whole blocks).  The
    SSD heads need not divide it: a participant runs its block of
    channels (:mod:`.ssd`)."""
    pattern = cfg.pattern()
    dims = {"vocab_padded": cfg.vocab_padded}
    if any(s.mixer == "attn" for s in pattern):
        dims["n_heads"] = cfg.n_heads
    if any(s.mixer == "ssm" for s in pattern):
        dims["d_inner"] = cfg.d_inner
    if any(s.ffn == "mlp" for s in pattern):
        dims["d_ff"] = cfg.d_ff
    if any(s.ffn == "moe" for s in pattern):
        dims["moe_experts"] = cfg.moe_experts
    uneven = {k: v for k, v in dims.items() if v % m}
    if uneven:
        raise NotImplementedError(f"{cfg.name}: a model axis of {m} does not "
                                  f"divide {uneven}")


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            embeds: torch.Tensor | None = None, part=None):
    """Full-sequence logits and the MoE aux terms, averaged over the MoE
    layers (zeros when there are none).  With ``part`` (module doc), the
    logits are its vocabulary block.

    With ``cfg.remat`` and gradients enabled, each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are not
    kept, and the backward pass recomputes the block from its input — the
    reference's ``jax.checkpoint`` per block.  It changes memory, not
    values; the recompute launches the block's kernels a second time."""
    if part is not None:
        check_part(cfg, part, tokens.shape[1] + (
            0 if embeds is None else embeds.shape[1]))
        check_shardable(cfg, part.m)
    x = embed_inputs(params, cfg, tokens, embeds, part)
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = MoeAux(zero, zero, torch.zeros(max(cfg.moe_experts, 1),
                                         device=x.device))
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_blocks):
        if remat:
            x, aux = checkpoint(_block_forward, params, cfg, i, x, aux,
                                positions, part, use_reentrant=False)
        else:
            x, aux = _block_forward(params, cfg, i, x, aux, positions, part)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    n_moe = sum(s.ffn == "moe" for s in cfg.pattern()) * cfg.n_blocks
    if n_moe:
        aux = MoeAux(*(t / n_moe for t in aux))
    return head_logits(params, cfg, x, part), aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood in float32, in the reference's
    iota-select form: the label's logit is selected by comparing a column
    index with the label (no gather), and the max subtracted before the
    exponent carries no gradient."""
    logits32 = logits.float()
    m = logits32.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits32 - m).sum(dim=-1)) + m[..., 0]
    col = torch.arange(logits.shape[-1], device=logits.device)
    label_logit = torch.where(col == labels[..., None], logits32,
                              0.0).sum(dim=-1)
    return lse - label_logit


def loss_fn(params: Params, cfg: ModelConfig, batch: dict,
            lb_coef: float = 0.01, z_coef: float = 1e-3, part=None):
    """Next-token cross-entropy; labels < 0 are ignored (modality
    prefixes).  Returns ``(loss, metrics)``, the metrics as 0-d tensors
    keyed as the reference keys them.  With ``part`` (module doc) the
    loss is the participant's part, the cross-entropy's denominator the
    whole batch's valid labels, and the metrics (detached) the whole
    batch's."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          embeds=batch.get("embeds"), part=part)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:   # modality prefix positions
        pad = torch.full((labels.shape[0], logits.shape[1] - labels.shape[1]),
                         -1, dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    valid = labels >= 0
    if part is None:
        nll = cross_entropy(logits, labels.clamp_min(0))
        denom = valid.sum().clamp_min(1)
        ce = torch.where(valid, nll, 0.0).sum() / denom
    else:
        nll = vocab_parallel_cross_entropy(logits, labels.clamp_min(0), part,
                                           cfg.vocab_padded)
        denom = part.psum_dp(valid.sum()).clamp_min(1)
        ce = torch.where(valid, nll, 0.0).sum() * part.dp / denom
    loss = ce + lb_coef * aux.load_balance_loss + z_coef * aux.router_z_loss
    metrics = {
        "loss": loss,
        "ce": ce,
        "lb_loss": aux.load_balance_loss,
        "z_loss": aux.router_z_loss,
        "expert_load_max": (aux.expert_load.max() if cfg.moe_experts
                            else torch.zeros((), device=loss.device)),
    }
    if part is not None:
        names = ("loss", "ce", "lb_loss", "z_loss")
        whole = part.pmean_dp(torch.stack([metrics[k].detach()
                                           for k in names]))
        metrics.update(zip(names, whole.unbind(0)))
        metrics["expert_load_max"] = metrics["expert_load_max"].detach()
    return loss, metrics


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device, part=None) -> dict:
    """Zero caches of a batch of ``batch_size`` and ``max_len`` positions.
    With ``part``, its block of every slot by ``cache_shardings``: the
    shapes ``shard_tree`` would cut from the whole cache (``"len"``
    replicated, ``"pos"`` its host mirror, ``"max_len"`` the whole
    length; the fully-seq layout's last block is the shorter, and a
    length that would leave a block empty raises)."""
    if part is not None:
        return _init_cache_block(cfg, batch_size, max_len, device, part)
    cdt = dtype_of(cfg.dtype)
    cache: dict = {"len": torch.zeros((), dtype=torch.int32, device=device),
                   "pos": 0, "slots": {}}
    nb = cfg.n_blocks
    for skey, kind, _role in _slot_keys(cfg):
        if kind == "attn":
            shape = (nb, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
            cache["slots"][skey] = {
                "k": torch.zeros(shape, dtype=cdt, device=device),
                "v": torch.zeros(shape, dtype=cdt, device=device),
            }
        elif kind == "ssm":
            gn2 = 2 * cfg.ssm_groups * cfg.ssm_state
            cache["slots"][skey] = {
                "conv_x": torch.zeros(
                    (nb, batch_size, cfg.ssm_conv - 1, cfg.d_inner),
                    dtype=cdt, device=device),
                "conv_bc": torch.zeros(
                    (nb, batch_size, cfg.ssm_conv - 1, gn2), dtype=cdt,
                    device=device),
                "ssm": torch.zeros(
                    (nb, batch_size, cfg.ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state), dtype=torch.float32, device=device),
            }
    return cache


def serve_layout(cfg: ModelConfig, part, batch_size: int) -> str | None:
    """The attention cache's layout for a batch of ``batch_size`` on
    ``part``'s mesh (``cache_layout``; None where no slot attends).
    Raises ``NotImplementedError`` for a layout the sharded layers do not
    run."""
    if not any(s.mixer == "attn" for s in cfg.pattern()):
        return None
    return cache_layout(cfg, part.mesh, batch_size)


#: The fully-seq layouts (``cache_layout``): the cache's positions split
#: over the data axes, every row on every participant.
FULLY_SEQ = ("seq", "seq_hd")


def check_seq_blocks(n: int, part, what: str = "a cache") -> None:
    """Raise ``ValueError`` where ``n`` positions split over ``part``'s
    data axes (ceil-divided, as ``shard_tree`` cuts them) leave a block
    empty: a check on the host, before any collective."""
    if -(-n // part.dp) * (part.dp - 1) >= n:
        raise ValueError(f"{what} of {n} positions leaves a block of the "
                         f"{part.dp} data participants empty")


def _init_cache_block(cfg: ModelConfig, batch_size: int, max_len: int,
                      device, part) -> dict:
    layout = serve_layout(cfg, part, batch_size)
    if layout in FULLY_SEQ:
        check_seq_blocks(max_len, part)
    whole = init_cache(cfg, batch_size, max_len, "meta")
    sh = cache_shardings(cfg, part.mesh, whole["slots"], batch_size)

    def block(leaf, s):
        shape = [sl.stop - sl.start
                 for sl in shard_slices(leaf.shape, s, part.coord)]
        return torch.zeros(shape, dtype=leaf.dtype, device=device)
    return {"len": torch.zeros((), dtype=torch.int32, device=device),
            "pos": 0, "max_len": max_len,
            "slots": tree.map(block, whole["slots"], sh)}


def rows_part(part, batch_size: int):
    """``part`` as it takes a batch of ``batch_size``: its data block of
    the rows, or every row where the batch does not divide over the data
    axes (``batch_specs``' replicated batch; :meth:`whole_rows`)."""
    return part if batch_size % part.dp == 0 else part.whole_rows()


def batch_block(t: torch.Tensor, part) -> torch.Tensor:
    """``part``'s rows of a whole batch ``t`` (``batch_specs``: the
    batch's ``dp`` blocks in row-major order over the data axes, or every
    row where ``part`` holds every row: :func:`rows_part`)."""
    if not part.rows_split:
        return t
    n = t.shape[0] // part.dp
    return t[part.di * n:(part.di + 1) * n]


def cache_size(cache: dict) -> int | None:
    """The whole length of a cache's attention slots (a participant's
    block may hold fewer positions); None where no slot attends."""
    if "max_len" in cache:
        return cache["max_len"]
    return next((s["k"].shape[2] for s in _kv_slots(cache)), None)


def _kv_slots(cache: dict) -> list[dict]:
    """The attention slots of a cache: the only ones with a length."""
    return [slot for slot in cache["slots"].values() if "k" in slot]


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: dict, embeds: torch.Tensor | None = None, part=None):
    """Run the prompt through the model, filling the cache. Returns logits
    of the last position and the cache (written in place: K/V at
    ``[:S]``, zeros after, as the reference's padded copy; SSM slots hold
    the state after the last prompt step).  With ``part`` (module doc),
    its rows of ``tokens`` (and ``embeds``) into its cache block, and its
    rows' logits: in the fully-seq layout every row, and the positions of
    its cache block."""
    layout, size = None, cache_size(cache)
    if part is not None:
        check_part(cfg, rows_part(part, tokens.shape[0]), tokens.shape[1]
                   + (0 if embeds is None else embeds.shape[1]))
        check_shardable(cfg, part.m)
        layout = serve_layout(cfg, part, tokens.shape[0])
        part = rows_part(part, tokens.shape[0])
        tokens = batch_block(tokens, part)
        if embeds is not None:
            embeds = batch_block(embeds, part)
    x = embed_inputs(params, cfg, tokens, embeds, part)
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    if size is not None and S > size:
        raise ValueError(f"prompt of {S} tokens does not fit a cache of "
                         f"{size}")
    lo, hi = part.dp_block(size) if layout in FULLY_SEQ else (0, size)
    n = min(max(S - lo, 0), hi - lo) if size is not None else 0
    for i in range(cfg.n_blocks):
        bp = _block(params, i)
        for skey, kind, _role in _slot_keys(cfg):
            p = bp[skey]
            h = rmsnorm(x, p["norm_scale"], cfg.norm_eps)
            if kind == "attn":
                if part is None:
                    q, k, v = _project_qkv(p, h, h, cfg)
                    q = rope(q, positions, cfg.rope_theta)
                    k = rope(k, positions, cfg.rope_theta)
                    out = attend(q, k, v, cfg, causal=True)
                    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
                    x = x + out @ p["wo"].to(out.dtype)
                else:
                    out, k, v = _attention_sharded(p, h, cfg, positions,
                                                   True, part, kv_out=True)
                    x = x + out
                    k, v = kv_cache_blocks(k, v, cfg, part, layout)
                c = cache["slots"][skey]
                for name, t in (("k", k), ("v", v)):
                    c[name][i, :, :n] = t[:, lo:lo + n]
                    c[name][i, :, n:] = 0
            elif kind == "ssm":
                out, st = ssm_apply(p, h, cfg, return_state=True, part=part)
                x = x + out
                _write_state(cache["slots"][skey], i, st)
            elif kind == "mlp":
                x = x + mlp_apply(p, h, part)
            else:
                x = x + moe_apply(p, h, cfg, part)[0]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _step_logits(params, cfg, x[:, -1:, :], part)
    cache["len"] = torch.full((), S, dtype=torch.int32, device=x.device)
    cache["pos"] = S
    return logits, cache


def _step_logits(params: Params, cfg: ModelConfig, x, part):
    """The head's logits; with ``part``, its block gathered over
    ``"model"`` into the whole vocabulary."""
    logits = head_logits(params, cfg, x, part)
    if part is None:
        return logits
    return gather_vocab(logits, part, cfg.vocab_padded)


def _write_state(slot: dict, i: int, st: SsmState) -> None:
    """Block ``i``'s SSM state into its cache slot, in place."""
    slot["conv_x"][i] = st.conv_x
    slot["conv_bc"][i] = st.conv_bc
    slot["ssm"][i] = st.ssm


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict, part=None):
    """One decode step. tokens: [B, 1] → logits [B, 1, V], the cache with
    the new K/V written at ``len`` and ``len`` advanced by one.  Raises
    ``IndexError`` when the cache is full (the JAX package clamps the
    write index instead; a participant checks its host mirror, the same
    on every one, against the whole length).  With ``part`` (module doc),
    its rows of ``tokens`` and its rows' logits; in the fully-seq layout
    the new k / v are written only by the participants whose block holds
    the position, which the host mirror says."""
    size = cache_size(cache)
    if size is not None:
        check_cache_index(cache["pos"], size)
    layout, lo, write = None, 0, True
    if part is not None:
        check_part(cfg, rows_part(part, tokens.shape[0]), tokens.shape[1])
        check_shardable(cfg, part.m)
        layout = serve_layout(cfg, part, tokens.shape[0])
        part = rows_part(part, tokens.shape[0])
        tokens = batch_block(tokens, part)
        if layout in FULLY_SEQ:
            lo, hi = part.dp_block(size)
            write = lo <= cache["pos"] < hi
    x = embed_inputs(params, cfg, tokens, part=part)
    cache_len = cache["len"]
    for i in range(cfg.n_blocks):
        bp = _block(params, i)
        for skey, kind, _role in _slot_keys(cfg):
            p = bp[skey]
            h = rmsnorm(x, p["norm_scale"], cfg.norm_eps)
            if kind == "attn":
                c = cache["slots"][skey]
                if part is None:
                    out, _, _ = attention_decode(p, h, cfg, c["k"][i],
                                                 c["v"][i], cache_len)
                else:
                    out = attention_decode_sharded(
                        p, h, cfg, c["k"][i], c["v"][i], cache_len, part,
                        layout, lo, write)
                x = x + out
            elif kind == "ssm":
                c = cache["slots"][skey]
                out, st = ssm_decode(p, h, cfg, SsmState(
                    c["conv_x"][i], c["conv_bc"][i], c["ssm"][i]), part)
                x = x + out
                _write_state(c, i, st)
            elif kind == "mlp":
                x = x + mlp_apply(p, h, part)
            else:
                x = x + moe_apply(p, h, cfg, part)[0]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _step_logits(params, cfg, x, part)
    cache["len"] = cache_len + 1
    cache["pos"] += 1
    return logits, cache


def meta_tree(shapes: dict, dtype: torch.dtype) -> Params:
    """A parameter tree of ``meta`` tensors from its shapes: ``dtype``
    everywhere but ``A_log``, which the SSM keeps in float32."""
    return {k: meta_tree(v, dtype) if isinstance(v, dict) else torch.empty(
        v, dtype=torch.float32 if k == "A_log" else dtype, device="meta")
        for k, v in shapes.items()}


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameter tree as ``meta`` tensors (shapes and dtypes, no
    allocation) — the dry-run path."""
    return meta_tree(param_shapes(cfg), dtype_of(cfg.param_dtype))
