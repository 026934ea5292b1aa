"""AdamW with clipping by the global norm and a cosine schedule with
linear warm-up, in float32, written from its definition (Loshchilov and
Hutter, arXiv:1711.05101): weight decay on matrices only (leaves of two or
more dimensions whose name holds no ``norm`` and does not start with
``b``)."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1

    def lr_at(self, step: int) -> float:
        warm = min(step / max(self.warmup_steps, 1), 1.0)
        frac = min(max((step - self.warmup_steps)
                       / max(self.total_steps - self.warmup_steps, 1), 0.0),
                   1.0)
        decay = self.min_lr_ratio + (1 - self.min_lr_ratio) * 0.5 * (
            1 + math.cos(math.pi * frac))
        return self.lr * warm * decay


def decayed(name: str, leaf: torch.Tensor) -> bool:
    return leaf.dim() >= 2 and "norm" not in name and not name.startswith("b")


@torch.no_grad()
def clip(grads: dict, cfg: AdamW) -> dict:
    """The gradients scaled so that their global norm is at most
    ``cfg.grad_clip``, in float32."""
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g.float() * scale for k, g in grads.items()}


class AdamWRun:
    """The optimizer's state over a flat ``{path: leaf}`` of float32
    parameters; :meth:`update` takes the raw gradients, clips them and
    steps, and returns the clipped gradients it used."""

    def __init__(self, cfg: AdamW, params: dict[str, torch.Tensor]) -> None:
        self.cfg = cfg
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.step = 0

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> dict:
        c = self.cfg
        clipped = clip(grads, c)
        self.step += 1
        lr = c.lr_at(self.step)
        bc1 = 1.0 - c.b1 ** self.step
        bc2 = 1.0 - c.b2 ** self.step
        for k, p in params.items():
            g = clipped[k]
            self.m[k].mul_(c.b1).add_((1 - c.b1) * g)
            self.v[k].mul_(c.b2).add_((1 - c.b2) * g * g)
            delta = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + c.eps)
            wd = c.weight_decay if decayed(k.rsplit("/", 1)[-1], p) else 0.0
            p.sub_(lr * (delta + wd * p))
        return clipped
