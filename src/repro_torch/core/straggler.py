"""Straggler detection (paper §II-A / §III-A).

A straggler is a task whose duration exceeds ``threshold`` (default 1.5,
Mantri's definition, shared by refs [4, 6, 8]) times the *median* task
duration of its stage.
"""
from __future__ import annotations

import numpy as np

DEFAULT_STRAGGLER_THRESHOLD = 1.5


def straggler_mask(durations: np.ndarray, threshold: float = DEFAULT_STRAGGLER_THRESHOLD) -> np.ndarray:
    """Boolean mask of stragglers among ``durations`` (one stage's tasks)."""
    durations = np.asarray(durations, dtype=np.float64)
    if durations.size == 0:
        return np.zeros(0, dtype=bool)
    return durations > threshold * float(np.median(durations))


def straggler_scale(durations: np.ndarray) -> np.ndarray:
    """Paper Fig. 3-6 y-axis: task duration / median task duration."""
    durations = np.asarray(durations, dtype=np.float64)
    med = float(np.median(durations)) if durations.size else 1.0
    if med <= 0.0:
        med = 1.0
    return durations / med
