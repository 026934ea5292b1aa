"""Synthetic host-sharded data pipeline.

Deterministic (seeded per host × step — restart-safe: resuming at step k
reproduces the exact batch), with controllable *skew* and *locality* knobs
that exercise the BigRoots data-skew and locality root causes end-to-end:

- ``skew_host``/``skew_factor``: one host's shards carry ×factor bytes (its
  ``read_bytes`` telemetry feature inflates and its load time grows).
- ``remote_prob``: probability a shard must be fetched "remotely" (locality
  code 2 + simulated fetch latency), feeding Eq. 7.

A background :class:`Prefetcher` overlaps host-side generation with device
compute (double buffering), which is what makes ``data_load_time`` a real
stall signal rather than a constant.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch_per_host: int
    seed: int = 0
    # skew / locality simulation
    skew_host: int | None = None
    skew_factor: float = 1.0
    remote_prob: float = 0.0
    remote_delay_s: float = 0.0
    # frontend stubs
    embed_tokens: int = 0      # VLM patch count
    d_model: int = 0
    enc_frames: int = 0        # enc-dec encoder length


@dataclass
class BatchMeta:
    read_bytes: float
    locality: int
    load_time: float


class HostDataLoader:
    """One host's shard of the global batch."""

    def __init__(self, cfg: DataConfig, host_id: int, num_hosts: int) -> None:
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts

    def batch_at(self, step: int) -> tuple[dict, BatchMeta]:
        cfg = self.cfg
        t0 = time.perf_counter()
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, self.host_id, step])
        )
        tokens = rng.integers(
            0, cfg.vocab, (cfg.batch_per_host, cfg.seq_len), dtype=np.int32
        )
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = 0
        batch = {"tokens": tokens, "labels": labels}
        if cfg.embed_tokens:
            batch["embeds"] = rng.normal(
                0, 1, (cfg.batch_per_host, cfg.embed_tokens, cfg.d_model)
            ).astype(np.float32)
        if cfg.enc_frames:
            batch["enc_embeds"] = rng.normal(
                0, 1, (cfg.batch_per_host, cfg.enc_frames, cfg.d_model)
            ).astype(np.float32)

        nbytes = float(sum(v.nbytes for v in batch.values()))
        locality = 0
        if cfg.skew_host is not None and self.host_id == cfg.skew_host:
            # skewed shard: more bytes to parse (simulated by busy-waiting on
            # an extra generation round) — the read_bytes feature records it
            nbytes *= cfg.skew_factor
            _ = rng.integers(0, cfg.vocab,
                             (int(cfg.batch_per_host * (cfg.skew_factor - 1)),
                              cfg.seq_len), dtype=np.int32)
        if cfg.remote_prob > 0 and rng.random() < cfg.remote_prob:
            locality = 2
            if cfg.remote_delay_s:
                time.sleep(cfg.remote_delay_s)
        return batch, BatchMeta(
            read_bytes=nbytes, locality=locality,
            load_time=time.perf_counter() - t0,
        )

    def __iter__(self) -> Iterator[tuple[dict, BatchMeta]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread double buffering over a HostDataLoader."""

    def __init__(self, loader: HostDataLoader, depth: int = 2,
                 start_step: int = 0) -> None:
        self.loader = loader
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        step = self._step
        while not self._stop.is_set():
            item = self.loader.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self, timeout: float = 60.0) -> tuple[dict, BatchMeta]:
        return self.q.get(timeout=timeout)

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
