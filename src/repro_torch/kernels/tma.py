"""What a TMA tensor map can describe: the rule the wgmma kernels' wrappers
apply to their bfloat16 inputs before a launch.

The Hopper kernels (``csrc/flash_attention.cu``, ``csrc/moe_gmm.cu``) load
their bfloat16 tiles with the Tensor Memory Accelerator, whose tensor maps
(``cuTensorMapEncodeTiled``) take a base address on 16 bytes, a contiguous
innermost axis and, for every other axis, a stride that is a multiple of
16 bytes.  An input that breaks the rule is refused, never copied: a copy
would hide a layout the caller should know costs a pass over memory.
"""
from __future__ import annotations

import math

import torch

#: Alignment, in bytes, of a tensor map's base address and strides.
TMA_ALIGN = 16


def check_tma(t: torch.Tensor, name: str) -> None:
    """Raise ``ValueError`` unless a TMA tensor map can describe ``t``.
    Axes of one element are not checked: their stride is never used."""
    elt = t.element_size()
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"{name}: base address {t.data_ptr():#x} is not on "
                         f"{TMA_ALIGN} bytes (TMA)")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: the last axis must be contiguous (TMA)")
    for ax in range(t.dim() - 1):
        if t.shape[ax] > 1 and (t.stride(ax) * elt) % TMA_ALIGN:
            raise ValueError(
                f"{name}: stride {t.stride(ax)} of axis {ax} is not a "
                f"multiple of {TMA_ALIGN} bytes (TMA)")


def tma_strides(t: torch.Tensor) -> list[int]:
    """Element strides of every axis but the last, as a tensor map takes
    them: an axis of one element gets the stride it would have in a
    contiguous tensor, rounded up to 16 bytes, since its own may be any."""
    per = TMA_ALIGN // t.element_size()
    return [s if n > 1 else per * -(-math.prod(t.shape[ax + 1:]) // per)
            for ax, (n, s) in enumerate(zip(t.shape[:-1], t.stride()[:-1]))]
