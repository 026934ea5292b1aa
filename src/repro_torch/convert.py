"""Carry parameters and state from their numpy forms onto a device.

The numpy forms are the canonical storage layout shared with the JAX
package (``forecast_init``'s parameter dict, the forecaster's carried
state arrays, the packed gate batch, a language model's parameter tree
and its training state),
so the same arrays can be handed to both packages and must produce the
same results.
"""
from __future__ import annotations

import numpy as np
import torch

from . import tree
from .device import resolve_device
from .models.forecast_ssd import ForecastCell
from .models import encdec, lm
from .parallel.collectives import shards as as_shards
from .parallel.sharding import (
    cache_shardings,
    gather_tree,
    param_shardings,
    shard_tree,
)
from .train.optimizer import AdamWState

_GATE_FIELDS = ("v", "peer_vsum", "inter_cnt", "intra_cnt", "rowmask",
                "vsum", "q", "numok", "floor")


def _tensor(a, device: torch.device, dtype=torch.float64) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a))
    ).to(device=device, dtype=dtype)


def forecast_params_from_numpy(params, device=None) -> ForecastCell:
    """The twelve arrays of ``forecast_init`` (float64; ``bo`` is 0-d) as
    a :class:`~repro_torch.models.forecast_ssd.ForecastCell` on
    ``device``."""
    return ForecastCell(params, resolve_device(device))


def forecaster_state_from_numpy(index, h, seen, last_tick, anchors,
                                device=None) -> dict:
    """A forecaster's carried recurrence state as the port keeps it: the
    ``[S, H, N]`` state on ``device``, the bookkeeping on the host.

    Returns a dict with keys ``index`` (``{(stage_id, node): row}``),
    ``h`` (float64 tensor), ``seen`` / ``last_tick`` (int64 numpy) and
    ``anchors`` (list of newest task ids);
    :meth:`repro_torch.core.forecast.Forecaster.load_state` installs it."""
    h_t = _tensor(h, resolve_device(device))
    rows = h_t.shape[0]
    seen = np.array(seen, dtype=np.int64)
    last_tick = np.array(last_tick, dtype=np.int64)
    anchors = list(anchors)
    index = {(str(s), str(n)): int(i) for (s, n), i in dict(index).items()}
    if not (len(seen) == len(last_tick) == len(anchors) == rows
            == len(index)):
        raise ValueError("forecaster state arrays disagree on the row count")
    return {"index": index, "h": h_t, "seen": seen,
            "last_tick": last_tick, "anchors": anchors}


def gate_batch_from_numpy(batch_like, device=None) -> tuple:
    """The nine gate inputs of any object with the fields of
    :class:`~repro_torch.core.fleet.FleetGateBatch` (the JAX package's
    packed batch included) as float64 tensors on ``device``, in the
    argument order of
    :func:`repro_torch.kernels.bigroots_gates.gates_launch`."""
    dev = resolve_device(device)
    return tuple(_tensor(getattr(batch_like, f), dev) for f in _GATE_FIELDS)


def _lm_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: the port owns its tensors
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 has no torch twin
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def param_shapes(cfg) -> dict:
    """The shapes of ``cfg``'s parameter tree: the encoder-decoder tree
    for ``enc_layers > 0``, else the decoder-only one."""
    return (encdec if cfg.enc_layers else lm).param_shapes(cfg)


def lm_params_from_numpy(params, cfg, device=None) -> dict:
    """A model's parameter tree from the JAX package
    (``jax.tree.map(np.asarray, params)``: nested dicts of numpy arrays)
    as the port's nested dict of tensors on ``device``, key for key, in the
    same dtypes.  Raises when a key or a shape differs from what
    :meth:`repro_torch.models.Model.init` makes for ``cfg`` (decoder-only
    or encoder-decoder)."""
    dev = resolve_device(device)

    def carry(tree, shapes, path):
        if set(tree) != set(shapes):
            raise ValueError(f"{path or 'params'}: keys {sorted(tree)} != "
                             f"{sorted(shapes)}")
        out = {}
        for key, want in shapes.items():
            if isinstance(want, dict):
                out[key] = carry(tree[key], want, f"{path}{key}/")
                continue
            t = _lm_tensor(tree[key], dev)
            if tuple(t.shape) != want:
                raise ValueError(f"{path}{key}: shape {tuple(t.shape)} != "
                                 f"{want}")
            out[key] = t
        return out

    return carry(params, param_shapes(cfg), "")


def lm_shard_from_numpy(params, cfg, mesh, coord: dict,
                        device=None) -> dict:
    """The block of a model's parameters that the participant at
    ``coord`` (``{axis: index}``) of ``mesh`` holds, from the JAX package's
    numpy tree: the port's whole tree (:func:`lm_params_from_numpy`), cut
    by the sharding rules (``param_shardings``, ``shard_tree``)."""
    full = lm_params_from_numpy(params, cfg, device)
    return shard_tree(full, param_shardings(full, cfg, mesh), coord)


def gather_cache(cache: dict, cfg, shards, batch_size: int) -> dict:
    """A participant's decode cache (``lm.init_cache(..., part=)``, or the
    encoder-decoder's ``encdec.init_cache(..., part=)``) whole: every slot
    (the encoder-decoder's ``"self"`` and ``"cross"``) gathered
    (``gather_tree`` over ``cache_shardings``) from the blocks the
    participants of ``shards`` (a ``Participant``, or what it is made
    from) hold (sequence blocks too, in the fully-seq layout: the
    encoder-decoder's self blocks joined into its ``"max_len"`` positions
    and its cross blocks into its ``"frames"``); ``"len"``, ``"pos"`` and
    ``"cross_len"`` as this one holds them.  Every
    participant receives the same tree, of new tensors (a later step
    writes the cache in place)."""
    sh = as_shards(getattr(shards, "shards", shards))
    if "slots" not in cache:                       # the encoder-decoder's
        blocks = {n: cache[n] for n in ("self", "cross")}
        sizes = {"self": cache.get("max_len"), "cross": cache.get("frames")}
        like = {n: {k: torch.empty((t.shape[0], batch_size,
                                    sizes[n] or t.shape[2],
                                    cfg.n_kv_heads, cfg.head_dim),
                                   dtype=t.dtype, device="meta")
                    for k, t in blocks[n].items()} for n in blocks}
        whole = gather_tree(blocks, cache_shardings(
            cfg, sh.mesh, like, batch_size), sh, like)
        return {"len": cache["len"].clone(), "pos": cache["pos"],
                "cross_len": cache["cross_len"].clone(),
                **tree.map(torch.clone, whole)}
    like = lm.init_cache(cfg, batch_size, lm.cache_size(cache) or 1,
                         "meta")["slots"]
    slots = gather_tree(cache["slots"], cache_shardings(
        cfg, sh.mesh, like, batch_size), sh, like)
    return {"len": cache["len"].clone(), "pos": cache["pos"],
            "slots": tree.map(torch.clone, slots)}


def lm_params_to_numpy(params) -> dict:
    """The inverse of :func:`lm_params_from_numpy`: a nested dict of
    tensors (parameters, or a tree shaped like them: AdamW moments, an
    error-feedback residual, gradients) as host numpy arrays, key for key,
    in the same dtypes (numpy has no bfloat16: such a leaf raises)."""
    return {k: lm_params_to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy().copy() for k, v in params.items()}


def train_state_from_numpy(state, cfg, device=None) -> dict:
    """A training state of the JAX package (``{"params", "opt", ["ef"]}``
    with ``opt`` an AdamW state of fields ``m``, ``v``, ``step``, after
    ``jax.tree.map(np.asarray, state)``) as the port's
    :data:`repro_torch.train.TrainState` on ``device``: every tree checked
    against ``cfg``'s parameter shapes, the step an int32 0-d tensor."""
    dev = resolve_device(device)
    opt = state["opt"]
    out = {
        "params": lm_params_from_numpy(state["params"], cfg, dev),
        "opt": AdamWState(
            m=lm_params_from_numpy(opt.m, cfg, dev),
            v=lm_params_from_numpy(opt.v, cfg, dev),
            step=torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                              device=dev)),
    }
    if "ef" in state:
        out["ef"] = lm_params_from_numpy(state["ef"], cfg, dev)
    return out
