"""Batched serving engine: prefill once, decode step-by-step.

The engine batches concurrent requests into a fixed decode batch, runs the
model's decode step (greedy or temperature sampling), and emits BigRoots
telemetry per step (the serve analog of per-step train tasks: stragglers
here are slow hosts in a multi-host serving fleet).

With the default implementation switches every prefill runs the
flash-attention kernel once per attention layer, the SSD intra-chunk
kernel once per SSM layer and the grouped-matmul kernel three times per
MoE layer; every decode step runs the split-K decode-attention kernel once
per attention layer and the grouped-matmul kernel three times per MoE
layer (:mod:`repro_torch.kernels`).  The SSM decode step is the plain
recurrent update, and the dense matrix products are PyTorch's.

The engine holds the weight matrices, biases and embeddings cast once to
``cfg.dtype`` on its device (the norm scales and the SSD decay parameters
stay in their own dtype, as the model reads them in float32): the same
values the JAX package's
per-use ``.astype`` gives, read once per step instead of cast again.  The
KV cache's fill level stays a device int32 that the kernels read, so the
decode loop's one host read per step is the tokens'.

In-loop diagnosis is wired through one object: pass
``diagnosis=``\\ :class:`~repro_torch.serve.diagnosis.Diagnosis` built for
the role this engine plays —

- ``Diagnosis.local(analyzer)`` with ``StepTelemetry(streaming=True)``:
  per-host diagnosis, newly confirmed root causes land in
  ``engine.live_root_causes`` while the batch is still decoding;
- ``Diagnosis.fleet(aggregator)`` with ``StepTelemetry(wire=True)``: the
  engine drains its per-step delta into the shared
  :class:`~repro_torch.serve.fleet.FleetAggregator` (or a
  :class:`~repro_torch.serve.fleet.TreeAggregator` mid-tier) and, when
  ``drive=True``, runs the *fleet-wide* merged sweep.  When several
  engines share an aggregator, exactly one party should drive;
- ``Diagnosis.forward(sink)`` with ``StepTelemetry(wire=True)``: the
  engine only ships its delta to another process.

``diagnosis=`` is the only wiring surface: the pre-facade kwargs
(``live_analyzer`` / ``fleet`` / ``fleet_step`` / ``delta_sink`` /
``policy``) are not accepted — passing them raises ``TypeError`` like any
unknown kwarg.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..models.api import Model
from ..models.layers import dtype_of
from ..telemetry.events import StepTelemetry
from .diagnosis import Diagnosis

#: Parameters the model reads in float32 whatever ``cfg.dtype`` is: the
#: norm scales (``rmsnorm`` casts its scale to float32, as the reference's
#: ``models/layers.py:32`` does, ``inner_norm`` included) and the SSD
#: decay parameters ``A_log`` / ``dt_bias`` (the reference's
#: ``models/ssd.py:227-228`` reads them in float32).  Rounding them to bf16
#: would serve another function than the reference.
_KEEP_DTYPE = ("norm_scale", "final_norm", "enc_final_norm", "inner_norm",
               "A_log", "dt_bias")


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)

    return prefill_step


def make_decode_step(model: Model, temperature: float = 0.0) -> Callable:
    """Greedy decoding takes the argmax; sampling draws from ``generator``
    by the Gumbel-max rule, which is what ``jax.random.categorical`` does
    (a ``torch.Generator`` does not give ``jax.random``'s bits)."""
    if temperature > 0:
        def decode_step(params, tokens, cache, generator):
            logits, cache = model.decode(params, tokens, cache)
            scaled = logits[:, 0, :].float() / temperature
            u = torch.rand(scaled.shape, generator=generator,
                           device=scaled.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            nxt = torch.argmax(scaled + gumbel, dim=-1)
            return nxt.to(torch.int32)[:, None], cache
    else:
        def decode_step(params, tokens, cache):
            logits, cache = model.decode(params, tokens, cache)
            nxt = torch.argmax(logits[:, 0, :], dim=-1)
            return nxt.to(torch.int32)[:, None], cache

    return decode_step


def served_dtype(cfg, name: str, own: torch.dtype) -> torch.dtype:
    """The dtype a parameter leaf named ``name`` (of dtype ``own``) is
    served in: ``cfg.dtype``, but those of ``_KEEP_DTYPE`` keep their own."""
    return own if name in _KEEP_DTYPE else dtype_of(cfg.dtype)


def cast_params(params, cfg, device: torch.device, in_place: bool = False):
    """``params`` on ``device`` with every tensor but those of
    ``_KEEP_DTYPE`` in ``cfg.dtype`` (a tensor already so placed and typed is kept, not
    copied).  ``in_place``: each leaf of ``params`` is replaced by its copy
    as the copy is made, so the caller's tree and the copy never coexist
    whole (jamba-v0.1-52b at 8 layers: 53 GB of float32 beside 27 GB of
    bf16 would fill an 80 GB card)."""
    def walk(tree):
        out = tree if in_place else {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            else:
                out[key] = val.to(device=device,
                                  dtype=served_dtype(cfg, key, val.dtype))
        return out

    return walk(params)


@dataclass
class Request:
    request_id: str
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 32
    output: list = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(
        self,
        model: Model,
        params,
        *,
        max_len: int = 512,
        batch_size: int = 8,
        temperature: float = 0.0,
        telemetry: StepTelemetry | None = None,
        eos_id: int | None = None,
        diagnosis: Diagnosis | None = None,
        device=None,
    ) -> None:
        self.model = model
        self.device = resolve_device(device)
        self.params = cast_params(params, model.cfg, self.device)
        self.max_len = max_len
        self.batch_size = batch_size
        self.temperature = temperature
        self.telemetry = telemetry
        self.eos_id = eos_id
        self._prefill = make_prefill_step(model)
        self._decode = make_decode_step(model, temperature)
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        #: rounds served (``run`` calls); the id of the round's spans
        self.rounds = 0
        self.live_root_causes: list = []
        # The one wiring surface: what happens to each step's telemetry
        # (see repro_torch.serve.diagnosis).  bind() validates the telemetry
        # mode up front so misconfiguration fails at construction.
        self.diagnosis = diagnosis
        if diagnosis is not None:
            diagnosis.bind(telemetry)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _decode_once(self, nxt, cache):
        """One decode step; draws random numbers only when sampling."""
        if self.temperature > 0:
            return self._decode(self.params, nxt, cache, self._generator)
        return self._decode(self.params, nxt, cache)

    def _pad_batch(self, requests: list[Request]) -> np.ndarray:
        """Left-align prompts into a rectangular [B, S_max] batch."""
        s_max = max(len(r.prompt) for r in requests)
        toks = np.zeros((self.batch_size, s_max), np.int32)
        for i, r in enumerate(requests):
            toks[i, : len(r.prompt)] = r.prompt  # simple equal-length demo path
        return toks

    def run(self, requests: list[Request], step_offset: int = 0) -> list[Request]:
        """Serve up to batch_size requests to completion (batch-synchronous).

        Records the spans (:mod:`repro_torch.tracing`) ``serve.round``,
        inside it ``serve.prefill`` around the prefill call and, per
        decode step, ``serve.decode`` around the step's enqueue and
        ``serve.token_read`` around the wait for its tokens, each with the
        round's id."""
        if not 0 < len(requests) <= self.batch_size:
            raise ValueError(f"{len(requests)} requests for a batch of "
                             f"{self.batch_size}")
        self.rounds += 1
        rnd = self.rounds
        with tracing.span("serve.round", round=rnd):
            return self._serve(requests, step_offset, rnd)

    def _serve(self, requests: list[Request], step_offset: int,
               rnd: int) -> list[Request]:
        live = list(requests)
        while len(live) < self.batch_size:  # pad with a dummy clone
            live.append(Request("_pad", live[0].prompt, live[0].max_new_tokens))
        toks = torch.from_numpy(self._pad_batch(live)).to(self.device)
        batch = {"tokens": toks}

        cache = self.model.init_cache(self.params, batch, self.max_len)
        t0 = time.time()
        with tracing.span("serve.prefill", round=rnd):
            logits, cache = self._prefill(self.params, batch, cache)
        nxt = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)[:, None]
        self._sync()
        prefill_s = time.time() - t0

        max_new = max(r.max_new_tokens for r in requests)
        for step in range(max_new):
            if self.telemetry is not None:
                step_t0 = time.time()
                with self.telemetry.step(step_offset + step) as scope:
                    with scope.phase("compute"):
                        with tracing.span("serve.decode", round=rnd,
                                          step=step):
                            nxt, cache = self._decode_once(nxt, cache)
                        self._sync()
                    scope.add("read_bytes", float(nxt.numel() * 4))
                if self.diagnosis is not None:
                    self.live_root_causes.extend(self.diagnosis.tick(
                        self.telemetry, step_time=time.time() - step_t0,
                    ))
            else:
                with tracing.span("serve.decode", round=rnd, step=step):
                    nxt, cache = self._decode_once(nxt, cache)
            with tracing.span("serve.token_read", round=rnd, step=step):
                out = nxt[:, 0].cpu().numpy()
            for i, r in enumerate(requests):
                if r.done or len(r.output) >= r.max_new_tokens:
                    r.done = True
                    continue
                tok = int(out[i])
                r.output.append(tok)
                if self.eos_id is not None and tok == self.eos_id:
                    r.done = True
            if all(r.done for r in requests):
                break
        for r in requests:
            r.done = True
        self.last_prefill_seconds = prefill_s
        return requests
