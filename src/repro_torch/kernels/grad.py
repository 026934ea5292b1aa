"""The gradient of a forward kernel: its plain version's, by autograd.

The JAX package differentiates its models by XLA's autodiff of the plain
``jnp`` forms; none of its Pallas kernels has a backward kernel
(no ``custom_vjp``).  The port's forward kernels (flash attention, the SSD
intra-chunk, the grouped matmul) write fresh tensors through ``ctypes``
and so carry no ``grad_fn`` of their own.  :class:`PlainGradient` gives
them one: its forward is the kernel launch, its backward recomputes the
kernel's plain PyTorch version on the saved inputs under
``torch.enable_grad()`` and returns that function's gradient — the
counterpart of the reference's autodiff.  It is no fallback: the forward
still runs the kernel, and a failed build or launch still raises.

On CPU tensors a wrapper passes the plain version as ``launch`` too, so the
CPU tests exercise the same save / recompute / backward path as the card.
The grouped matmul's bfloat16 CUDA calls have a gradient of kernels of
their own (``moe_gmm.KernelGradient``); its other calls take this one.
"""
from __future__ import annotations

from typing import Callable

import torch


class PlainGradient(torch.autograd.Function):
    """``PlainGradient.apply(launch, plain, *inputs)``: ``launch(*inputs)``
    forward (a tensor or a tuple of tensors), the gradient of
    ``plain(*inputs)`` backward.  ``launch`` and ``plain`` take the same
    positional tensors (keywords bound beforehand) and return the same
    structure."""

    @staticmethod
    def forward(ctx, launch: Callable, plain: Callable, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        return launch(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [leaf for leaf, need in zip(leaves, needs) if need]
        if not (pairs and wrt):
            return (None,) * (2 + len(needs))
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True))
        return (None, None,
                *(next(got) if need else None for need in needs))
