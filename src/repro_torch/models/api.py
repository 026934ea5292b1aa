"""The model API of the JAX package, over PyTorch tensors.

    model = Model(cfg)
    params = model.init(generator)          # or model.init(device="cpu")
    loss, metrics = model.loss(params, batch)
    cache = model.init_cache(params, batch, max_len)
    logits, cache = model.prefill(params, batch, cache)
    logits, cache = model.decode(params, tokens, cache)

Decoder-only configs run — dense / GQA attention, MoE, Mamba2 (SSM) and
hybrid layer patterns; encoder-decoder configs raise (they wait for a
later slice of the port).
"""
from __future__ import annotations

from typing import Any

import torch

from ..device import resolve_device
from . import lm
from .config import ModelConfig

Params = dict[str, Any]


class Model:
    def __init__(self, cfg: ModelConfig) -> None:
        if cfg.enc_layers > 0:
            raise NotImplementedError(
                f"{cfg.name}: encoder-decoder models wait for a later slice "
                "of the port"
            )
        self.cfg = cfg.validate()

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator | None = None, *,
             device=None) -> Params:
        """Parameters on ``device`` (default: the generator's device, else
        the GPU; :func:`repro_torch.device.resolve_device`), drawn from
        ``generator`` (default: a new one seeded 0 on that device)."""
        if device is None and generator is not None:
            device = generator.device
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return lm.init_params(self.cfg, generator, device)

    # -- training -------------------------------------------------------------
    def loss(self, params: Params, batch: dict):
        return lm.loss_fn(params, self.cfg, batch)

    def forward(self, params: Params, batch: dict):
        return lm.forward(params, self.cfg, batch["tokens"],
                          embeds=batch.get("embeds"))

    # -- serving --------------------------------------------------------------
    def init_cache(self, params: Params, batch: dict, max_len: int) -> dict:
        bsz = batch["tokens"].shape[0]
        return lm.init_cache(self.cfg, bsz, max_len, params["embed"].device)

    def prefill(self, params: Params, batch: dict, cache: dict):
        return lm.prefill(params, self.cfg, batch["tokens"], cache,
                          embeds=batch.get("embeds"))

    def decode(self, params: Params, tokens, cache: dict):
        return lm.decode_step(params, self.cfg, tokens, cache)

    # -- bookkeeping ----------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        return self.cfg.param_count(active_only=active_only)
