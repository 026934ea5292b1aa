"""Serving traffic: a closed loop of clients whose requests arrive in
batches.  Prompt lengths go round a fixed cycle, its order drawn from the
seed, so that every seed serves the same set of sizes; token ids are
uniform over the vocabulary, drawn from (seed, batch)."""
from __future__ import annotations

import numpy as np


def length_cycle(seed: int, lengths: list[int]) -> list[int]:
    order = np.random.default_rng([seed, 11]).permutation(len(lengths))
    return [int(lengths[i]) for i in order]


def prompt_length(seed: int, lengths: list[int], batch: int) -> int:
    return length_cycle(seed, lengths)[batch % len(lengths)]


def prompts(seed: int, batch: int, clients: int, length: int,
            vocab: int, warm: bool = False) -> np.ndarray:
    """The ``clients`` prompts of batch ``batch`` [clients, length] (of
    the warm-up rounds' own stream with ``warm``)."""
    rng = np.random.default_rng([seed, 14 if warm else 13, batch])
    return rng.integers(0, vocab, (clients, length), dtype=np.int32)
