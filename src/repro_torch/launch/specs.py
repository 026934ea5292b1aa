"""input_specs(): ``meta`` tensor stand-ins for every (arch × shape) cell.

Shapes and dtypes, no allocation — what the dry run steps on.  The JAX
package's rules (its ``launch/specs.py``): VLM cells split the sequence
into ``frontend_tokens`` patch embeddings + text; enc-dec cells use
``T_enc = seq_len / 4`` frame embeddings.
"""
from __future__ import annotations

import torch

from ..configs import ShapeSpec
from ..models.config import ModelConfig

F32 = torch.float32
I32 = torch.int32


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.enc_layers:                       # enc-dec: frames + decoder tokens
        t_enc = max(S // 4, 1)
        return {
            "tokens": sds((B, S), I32),
            "labels": sds((B, S), I32),
            "enc_embeds": sds((B, t_enc, cfg.d_model), F32),
        }
    if cfg.frontend_tokens:                  # VLM: patches + text
        text = S - cfg.frontend_tokens
        assert text > 0, f"{cfg.name}: seq {S} too short for frontend"
        return {
            "tokens": sds((B, text), I32),
            "labels": sds((B, text), I32),
            "embeds": sds((B, cfg.frontend_tokens, cfg.d_model), F32),
        }
    return {"tokens": sds((B, S), I32), "labels": sds((B, S), I32)}


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend_tokens:
        return {
            "tokens": sds((B, S - cfg.frontend_tokens), I32),
            "embeds": sds((B, cfg.frontend_tokens, cfg.d_model), F32),
        }
    return {"tokens": sds((B, S), I32)}


def decode_token_specs(cfg: ModelConfig, shape: ShapeSpec) -> torch.Tensor:
    return sds((shape.global_batch, 1), I32)


def abstract_cache(model, cfg: ModelConfig, shape: ShapeSpec,
                   max_len: int | None = None) -> dict:
    """The decode cache on ``meta``: ``lm.init_cache`` on the meta device,
    or for enc-dec ``init_cache`` (the encoder and the cross K/V) over the
    meta parameters and frames.  It holds ``max_len`` positions (default
    the cell's ``seq_len``).  Besides the reference's leaves it holds the
    port's ``"pos"`` (the host mirror of ``"len"``, an ``int``) and, for
    enc-dec, ``"cross_len"``."""
    B, S = shape.global_batch, shape.seq_len
    max_len = max_len or S
    if cfg.enc_layers:
        t_enc = max(S // 4, 1)
        enc = sds((B, t_enc, cfg.d_model), F32)
        return model.init_cache(model.abstract_params(), {"enc_embeds": enc},
                                max_len)
    from ..models import lm

    return lm.init_cache(cfg, B, max_len, "meta")


def input_specs(model, cfg: ModelConfig, shape: ShapeSpec,
                max_len: int | None = None) -> dict:
    """All abstract inputs for the cell's step function (a cache of
    ``max_len`` positions, default ``seq_len``)."""
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {
            "batch": prefill_batch_specs(cfg, shape),
            "cache": abstract_cache(model, cfg, shape, max_len),
        }
    if shape.kind == "decode":
        return {
            "tokens": decode_token_specs(cfg, shape),
            "cache": abstract_cache(model, cfg, shape, max_len),
        }
    raise ValueError(shape.kind)
