"""Train-step builder: forward + backward + AdamW, with optional gradient
accumulation and int8 gradient compression (error feedback).

The JAX package's ``train/step.py`` on tensors.  The gradient is
``torch.autograd.grad`` of ``model.loss`` over every parameter leaf,
without ``allow_unused``: a parameter the loss does not reach (a kernel
whose output carried no gradient, say) raises instead of training the
wrong function.  The reference's ``abstract_state`` and
``state_shardings`` (shapes without allocation, mesh shardings) wait for
the port of ``parallel/sharding`` and ``launch/dryrun``.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import tree
from ..models.api import Model
from ..parallel.compress import ef_init, ef_compress
from .optimizer import AdamWConfig, adamw_init, adamw_update

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
