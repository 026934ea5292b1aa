"""Train-step builder: forward + backward + AdamW, with optional gradient
accumulation and int8 gradient compression (error feedback).

The JAX package's ``train/step.py`` on tensors.  The gradient is
``torch.autograd.grad`` of ``model.loss`` over every parameter leaf,
without ``allow_unused``: a parameter the loss does not reach (a kernel
whose output carried no gradient, say) raises instead of training the
wrong function.  :func:`abstract_state` gives the state as ``meta``
tensors and :func:`state_shardings` its shardings on a mesh
(:mod:`repro_torch.parallel.sharding`), ZeRO-1 included.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import tree
from ..models.api import Model
from ..parallel.compress import ef_init, ef_compress
from ..parallel.sharding import (
    NamedSharding,
    dp_axes,
    dp_size,
    param_shardings,
    spec,
)
from .optimizer import AdamWConfig, AdamWState, adamw_init, adamw_update

TrainState = dict  # {"params": ..., "opt": AdamWState, ["ef": residual]}


def init_state(model: Model, generator: torch.Generator | None,
               opt_cfg: AdamWConfig, compress: bool = False, *,
               device=None) -> TrainState:
    """Fresh parameters (:meth:`Model.init`), zero AdamW moments and, with
    ``compress``, a zero error-feedback residual."""
    params = model.init(generator, device=device)
    state: TrainState = {"params": params, "opt": adamw_init(params)}
    if compress:
        state["ef"] = ef_init(params)
    return state


def abstract_state(model: Model, opt_cfg: AdamWConfig,
                   compress: bool = False) -> TrainState:
    """:func:`init_state`'s tree as ``meta`` tensors (shapes and dtypes, no
    allocation)."""
    params = model.abstract_params()

    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    state: TrainState = {"params": params, "opt": AdamWState(
        m=tree.map(f32, params), v=tree.map(f32, params),
        step=torch.empty((), dtype=torch.int32, device="meta"))}
    if compress:
        state["ef"] = tree.map(f32, params)
    return state


def state_shardings(abstract: TrainState, cfg, mesh, zero_opt: bool = False):
    """Shardings of the whole train state.

    Default: AdamW's ``m`` / ``v`` follow their parameters (sharded over
    the model axis only, replicated across data).  ``zero_opt=True`` also
    shards ``m`` / ``v`` over the data axes (ZeRO-1): each data-parallel
    rank owns a slice of the optimizer state — memory ÷ dp size, at the
    cost of a gather / scatter around the update."""
    def zero_shard(shardings, moments):
        """The dp axes on the first unsharded, divisible dim of each leaf."""
        dp, n = dp_axes(mesh), dp_size(mesh)

        def one(s: NamedSharding, leaf):
            entries = list(s.spec) + [None] * (leaf.dim() - len(s.spec))
            for i, (ax, dim) in enumerate(zip(entries, leaf.shape)):
                if ax is None and dim % n == 0 and dim > 0:
                    entries[i] = dp
                    return NamedSharding(mesh, spec(*entries))
            return s
        return tree.map(one, shardings, moments)

    m_sh = param_shardings(abstract["opt"].m, cfg, mesh)
    v_sh = param_shardings(abstract["opt"].v, cfg, mesh)
    if zero_opt:
        m_sh = zero_shard(m_sh, abstract["opt"].m)
        v_sh = zero_shard(v_sh, abstract["opt"].v)
    out: TrainState = {
        "params": param_shardings(abstract["params"], cfg, mesh),
        "opt": AdamWState(m=m_sh, v=v_sh,
                          step=NamedSharding(mesh, spec())),
    }
    if "ef" in abstract:
        out["ef"] = param_shardings(abstract["ef"], cfg, mesh)
    return out


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    accum: int = 1,
    compress: bool = False,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Returns ``train_step(state, batch) → (state, metrics)``.

    ``accum > 1`` splits the batch into ``accum`` microbatches along its
    first axis, one forward and backward each, and sums their float32
    gradients and their metrics before dividing by ``accum``.
    ``compress=True`` quantize-dequantizes the gradients (int8 + error
    feedback) before the optimizer.  The state is not modified: the step
    returns a new one."""

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        loss, metrics = model.loss(tree.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, tree.unflatten(params, list(grads))

    def train_step(state: TrainState, batch: dict):
        params = state["params"]
        if accum <= 1:
            metrics, grads = grad_fn(params, batch)
        else:
            grads = tree.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            metrics = None
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                m, g = grad_fn(params, mb)
                grads = tree.map(lambda a, b: a + b.float(), grads, g)
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
            grads = tree.map(lambda g: g / accum, grads)
            metrics = {k: v / accum for k, v in metrics.items()}

        new_state: TrainState = {}
        if compress:
            grads, new_state["ef"] = ef_compress(grads, state["ef"])
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state["opt"], params, opt_cfg)
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        return new_state, {**metrics, **opt_metrics}

    return train_step
