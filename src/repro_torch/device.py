"""The one device resolver of the package.

Every entry point of the port (``BigRootsAnalyzer``, ``WhatIfReplayer``,
``Forecaster`` and, through them, ``FleetAggregator`` / ``Diagnosis``)
takes ``device=None`` and resolves it here.  The port runs on the GPU
unless the caller asks for the CPU by name, as the CPU test-suite does:
nothing on the path probes for a GPU and quietly carries on without one.
"""
from __future__ import annotations

import functools

import torch

#: Streaming multiprocessors of an H100 SXM: the kernels' plans take the
#: card's own count (:func:`sm_count`); this is their default for shapes
#: planned off the card.
H100_SMS = 132


def resolve_device(device=None) -> torch.device:
    """``None`` → ``torch.device("cuda")`` (raises when there is no CUDA
    device); anything else is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "explicitly to run on the host"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False"
        )
    return device


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (read once per
    device)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _sm_count(index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
