"""The model API of the JAX package, over PyTorch tensors: one call surface
for every architecture.

    model = Model(cfg)
    params = model.init(generator)          # or model.init(device="cpu")
    loss, metrics = model.loss(params, batch)
    cache = model.init_cache(params, batch, max_len)
    logits, cache = model.prefill(params, batch, cache)
    logits, cache = model.decode(params, tokens, cache)

Decoder-only configs (dense / GQA attention, MoE, Mamba2 (SSM), hybrid
layer patterns, the VLM backbone) run through :mod:`.lm`, encoder-decoder
configs (``enc_layers > 0``) through :mod:`.encdec`.

``loss`` and ``forward`` take the shard context as an argument,
``shards``: one participant of a data × model mesh (a
:class:`~repro_torch.parallel.tensor.Participant`, or the ``Shards`` /
``DeviceMesh`` it is made from), given its block of the parameters
(:func:`repro_torch.parallel.sharding.shard_tree`) and its rows of the
batch.  ``init_cache``, ``prefill`` and ``decode`` take it too: there the
participant is given the whole batch, as the reference's jitted serving
cells are, keeps its block of the cache in the layout the batch takes
(``parallel/sharding.py``'s ``cache_layout``; a batch that does not divide
over the data axes takes the fully-seq one, every row on every
participant) (:func:`repro_torch.convert.gather_cache` gathers it whole)
and returns its rows' logits over the whole vocabulary.  The
encoder-decoder runs so too (:mod:`.encdec`: the encoder on the
participant's rows of ``enc_embeds`` and its heads, the cross cache's
block projected on its kv heads), except in the fully-seq layout, which
raises ``NotImplementedError``.  ``moe_impl="ep"`` runs each
participant's ep layer
(:func:`repro_torch.parallel.ep_moe.ep_moe_apply_sharded`); its decode
step at a model axis above one raises ``ValueError``, as the reference
asserts.  Without ``shards`` every call is the unsharded one.
"""
from __future__ import annotations

from typing import Any

import torch

from ..device import resolve_device
from ..parallel.tensor import gather_vocab, participant
from . import encdec, lm
from .config import ModelConfig

Params = dict[str, Any]


class Model:
    def __init__(self, cfg: ModelConfig) -> None:
        self.cfg = cfg.validate()
        self.is_encdec = cfg.enc_layers > 0

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator | None = None, *,
             device=None, leaf=None) -> Params:
        """Parameters on ``device`` (default: the generator's device, else
        the GPU; :func:`repro_torch.device.resolve_device`), drawn from
        ``generator`` (default: a new one seeded 0 on that device);
        ``leaf(path, tensor)`` applied to each as it is drawn
        (:func:`repro_torch.models.lm.init_params`)."""
        if device is None and generator is not None:
            device = generator.device
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        mod = encdec if self.is_encdec else lm
        return mod.init_params(self.cfg, generator, device, leaf)

    def abstract_params(self) -> Params:
        """The parameters as ``meta`` tensors: shapes and dtypes, no
        allocation."""
        mod = encdec if self.is_encdec else lm
        return mod.abstract_params(self.cfg)

    # -- training -------------------------------------------------------------
    def loss(self, params: Params, batch: dict, shards=None):
        """``(loss, metrics)``; with ``shards``, the participant's part of
        the loss (its mean over the data axes is the whole batch's) and
        the whole batch's metrics (:func:`repro_torch.models.lm.loss_fn`)."""
        part = participant(shards)
        if self.is_encdec:
            return encdec.loss_fn(params, self.cfg, batch, part=part)
        return lm.loss_fn(params, self.cfg, batch, part=part)

    def forward(self, params: Params, batch: dict, shards=None):
        """``(logits, aux)``; with ``shards``, the participant's rows of
        the logits, every column (gathered over ``"model"``)."""
        part = participant(shards)
        if self.is_encdec:
            logits, aux = encdec.forward(params, self.cfg, batch["tokens"],
                                         batch["enc_embeds"], part=part)
        else:
            logits, aux = lm.forward(params, self.cfg, batch["tokens"],
                                     embeds=batch.get("embeds"), part=part)
        if part is not None:
            logits = gather_vocab(logits, part, self.cfg.vocab_padded)
        return logits, aux

    # -- serving --------------------------------------------------------------
    def init_cache(self, params: Params, batch: dict, max_len: int,
                   shards=None) -> dict:
        """A zero cache for ``batch``; with ``shards``, the participant's
        block of it (``cache_shardings``)."""
        part = participant(shards)
        if self.is_encdec:
            return encdec.init_cache(params, self.cfg, batch["enc_embeds"],
                                     max_len, part=part)
        bsz = batch["tokens"].shape[0]
        return lm.init_cache(self.cfg, bsz, max_len, params["embed"].device,
                             part=part)

    def prefill(self, params: Params, batch: dict, cache: dict,
                shards=None):
        part = participant(shards)
        if self.is_encdec:
            # the encoder output is already in the cache (init_cache
            # encodes); prefill runs the decoder prompt into the self cache
            return encdec.prefill(params, self.cfg, batch["tokens"], cache,
                                  part=part)
        return lm.prefill(params, self.cfg, batch["tokens"], cache,
                          embeds=batch.get("embeds"), part=part)

    def decode(self, params: Params, tokens, cache: dict, shards=None):
        part = participant(shards)
        if self.is_encdec:
            return encdec.decode_step(params, self.cfg, tokens, cache,
                                      part=part)
        return lm.decode_step(params, self.cfg, tokens, cache, part=part)

    # -- bookkeeping ----------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        return self.cfg.param_count(active_only=active_only)
