"""The one device resolver of the package.

Every entry point of the port (``BigRootsAnalyzer``, ``WhatIfReplayer``,
``Forecaster`` and, through them, ``FleetAggregator`` / ``Diagnosis``)
takes ``device=None`` and resolves it here.  The port runs on the GPU
unless the caller asks for the CPU by name, as the CPU test-suite does:
nothing on the path probes for a GPU and quietly carries on without one.
"""
from __future__ import annotations

import torch


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
