"""AdamW + gradient clipping + LR schedules over nested dicts of tensors.

The JAX package's ``train/optimizer.py`` as plain functions on tensors:
the optimizer state is shaped like the parameters (``m``, ``v`` in
float32) plus a step counter, trees are walked in the reference's order
(:mod:`repro_torch.tree`), and every update is computed in float32 in the
reference's operation order.  Nothing is updated in place: an update
returns new parameters and a new state, as the reference's does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from .. import tree


class AdamWState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor    # [] int32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"       # "cosine" | "linear" | "constant"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def make_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """``step`` (an integer tensor) → the learning rate (float32 0-d)."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        frac = torch.clamp(
            (step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
                1 + torch.cos(math.pi * frac))
        elif cfg.schedule == "linear":
            decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
        else:
            decay = torch.ones((), dtype=torch.float32, device=step.device)
        return cfg.lr * warm * decay

    return sched


def global_norm(grads: Any, reduce_sums: Callable | None = None
                ) -> torch.Tensor:
    """The float32 norm of all leaves together.  ``reduce_sums`` (the
    sharded step's) maps the leaves' sums of squares, in flatten order, to
    those of the whole leaves before they are added."""
    sums = [torch.sum(torch.square(g.float())) for g in tree.leaves(grads)]
    if reduce_sums is not None:
        sums = reduce_sums(sums)
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: Any, max_norm: float,
                        reduce_sums: Callable | None = None):
    """``(grads scaled to at most max_norm, the norm before)``."""
    norm = global_norm(grads, reduce_sums)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree.map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def adamw_init(params: Any) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    some = tree.leaves(params)[0]
    return AdamWState(m=tree.map(zeros, params), v=tree.map(zeros, params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=some.device))


def _decay_mask(path: tuple, leaf) -> bool:
    """Weight decay for matrices, by the last key of the path: norms,
    biases and vectors are exempt (the reference's rule, its names)."""
    name = str(path[-1])
    return leaf.dim() >= 2 and "norm" not in name and not name.startswith("b")


def adamw_update(grads: Any, state: AdamWState, params: Any,
                 cfg: AdamWConfig):
    """One AdamW step after clipping: ``(new params, new state, metrics)``
    with ``metrics = {"grad_norm", "lr"}``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    new_params, new_state, lr = adamw_step(grads, state, params, cfg)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


def adamw_step(grads: Any, state: AdamWState, params: Any,
               cfg: AdamWConfig):
    """The AdamW step on clipped gradients, elementwise (so slices of
    every tree give the slice of the result): ``(new params, new state,
    lr)``."""
    step = state.step + 1
    lr = make_schedule(cfg)(step)
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)

    def upd(p, g, m, v, decay):
        g32 = g.float()
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if_decay = cfg.weight_decay if decay else 0.0
        p32 = p.float()
        p_new = p32 - lr * (delta + if_decay * p32)
        return p_new.to(p.dtype), m, v

    out = [upd(p, g, m, v, _decay_mask(path, p)) for (path, p), g, m, v in
           zip(tree.leaves_with_path(params), tree.leaves(grads),
               tree.leaves(state.m), tree.leaves(state.v), strict=True)]
    new_params = tree.unflatten(params, [o[0] for o in out])
    new_m = tree.unflatten(params, [o[1] for o in out])
    new_v = tree.unflatten(params, [o[2] for o in out])
    return new_params, AdamWState(m=new_m, v=new_v, step=step), lr
