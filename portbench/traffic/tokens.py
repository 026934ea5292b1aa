"""Training token batches, as the port's synthetic host loader makes them
(a frozen copy of its arithmetic): uniform token ids over the vocabulary,
labels the next token (the last 0), one generator a (seed, host, step)."""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np


@dataclass
class BatchMeta:
    read_bytes: float
    locality: int
    load_time: float


def batch_at(seed: int, step: int, batch: int, seq: int, vocab: int,
             host: int = 0) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, host, step]))
    tokens = rng.integers(0, vocab, (batch, seq), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    return {"tokens": tokens, "labels": labels}


class TokenLoader:
    """One host's batches, with the ``batch_at(step) -> (batch, meta)``
    surface the program's prefetcher reads."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int,
                 rows: int | None = None) -> None:
        self.seed, self.batch, self.seq, self.vocab = seed, batch, seq, vocab
        #: rows handed on of each batch (all of them unless a fault is
        #: planted: a batch cut to its first ``rows``).
        self.rows = batch if rows is None else rows

    def batch_at(self, step: int):
        t0 = time.perf_counter()
        b = batch_at(self.seed, step, self.batch, self.seq, self.vocab)
        b = {k: v[:self.rows] for k, v in b.items()}
        nbytes = float(sum(v.nbytes for v in b.values()))
        return b, BatchMeta(nbytes, 0, time.perf_counter() - t0)
