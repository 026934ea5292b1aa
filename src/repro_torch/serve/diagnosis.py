"""One wiring surface for in-loop diagnosis: the :class:`Diagnosis` facade.

The serve engine and the launch entry points take exactly one wiring
object — this facade (the pre-facade ``live_analyzer`` / ``fleet`` /
``delta_sink`` / ``policy`` kwargs are gone).  With tree aggregation
there are *four* roles a process can play — local analyzer, fleet root,
tree aggregator, forwarding host — and one facade expresses all of
them:

- ``Diagnosis.local(analyzer)`` — per-host in-loop diagnosis over the
  telemetry's own streaming window (no fleet).
- ``Diagnosis.fleet(aggregator)`` — ingest into an in-process
  :class:`~repro_torch.serve.fleet.FleetAggregator` (or
  :class:`~repro_torch.serve.fleet.TreeAggregator`) and, when ``drive=True``,
  run the merged sweep each tick.  Exactly one party per aggregator
  should drive (see the engine docstring) — pass ``drive=False`` for the
  others.
- ``Diagnosis.forward(sink)`` — ship the per-step delta to another
  process: anything with ``send(delta)``
  (:class:`~repro_torch.telemetry.transport.DeltaClient`,
  :class:`~repro_torch.telemetry.transport.RingSender`) or an
  :class:`~repro_torch.telemetry.transport.Endpoint`/address string, connected
  for you.

Any mode can carry a ``policy``
(:class:`~repro_torch.ft.policy.PolicyEngine`): each tick's fresh causes are
handed to it with the live-host count — unless the policy object *is*
the aggregator's own (then the aggregator's step already ticked it, and
double-ticking would advance cooldowns twice).

Usage::

    diag = Diagnosis.fleet(TreeAggregator(schema, name="agg0",
                                          parent="root:9100"))
    # one call per step:
    fresh = diag.tick(telem, step_time=dt)
"""
from __future__ import annotations

from ..core.window import RootCauseStream
from ..ft.policy import PolicyEngine


class Diagnosis:
    """Bundle of analyzer / aggregator-or-sink / policy — the one object
    a host passes to its serve engine (or drives
    directly via :meth:`tick`) to say what happens to each step's
    telemetry.  Build via :meth:`local`, :meth:`fleet`, or
    :meth:`forward`."""

    def __init__(
        self,
        *,
        analyzer=None,
        aggregator=None,
        sink=None,
        policy: PolicyEngine | None = None,
        drive: bool = True,
        attribution: bool = False,
        forecaster=None,
    ) -> None:
        modes = sum(x is not None for x in (analyzer, aggregator, sink))
        if modes > 1 or (modes == 0 and policy is None):
            raise ValueError(
                "Diagnosis needs exactly one of analyzer= (local mode), "
                "aggregator= (fleet mode), or sink= (forward mode) — or "
                "policy= alone (policy-only ticks)"
            )
        if sink is not None and not hasattr(sink, "send"):
            # Endpoint / address string: connect it here so launch code
            # and flags can hand strings straight through.
            from ..telemetry.transport import Endpoint
            sink = Endpoint.parse(sink).connect()
        self.analyzer = analyzer
        self.aggregator = aggregator
        self.sink = sink
        self.policy = policy
        self.drive = bool(drive)
        self.attribution = bool(attribution)
        # Opt-in predictive hop (repro_torch.core.forecast.Forecaster): scores
        # the same live windows the gate sweep reads and appends tagged
        # `predicted_straggler` candidate causes to each tick's return —
        # the confirmed stream itself is never touched, so forecaster=None
        # ticks are byte-identical to pre-forecast builds.
        self.forecaster = forecaster
        self._stream: RootCauseStream | None = None

    # -- constructors --------------------------------------------------------
    @classmethod
    def local(cls, analyzer, *, policy: PolicyEngine | None = None,
              attribution: bool = False, forecaster=None) -> "Diagnosis":
        """Per-host diagnosis: run ``analyzer`` over the telemetry's own
        streaming window each tick (needs
        ``StepTelemetry(streaming=True)``).  ``attribution=True`` prices
        each fresh cause with a what-if recovered-time estimate
        (:class:`~repro_torch.core.whatif.WhatIfReplayer`); off by default the
        emitted stream is byte-identical to an unattributed one.
        ``forecaster=`` adds the predictive straggler hop (see
        :class:`~repro_torch.core.forecast.Forecaster`)."""
        return cls(analyzer=analyzer, policy=policy,
                   attribution=attribution, forecaster=forecaster)

    @classmethod
    def fleet(cls, aggregator, *, drive: bool = True,
              policy: PolicyEngine | None = None,
              forecaster=None) -> "Diagnosis":
        """Fleet diagnosis: drain each tick's delta into ``aggregator``
        in-process (needs ``StepTelemetry(wire=True)``); ``drive``
        selects whether this party runs the merged sweep.
        ``forecaster=`` scores the aggregator's live windows each driven
        tick (driving party only — it owns the merged view)."""
        return cls(aggregator=aggregator, drive=drive, policy=policy,
                   forecaster=forecaster)

    @classmethod
    def forward(cls, sink, *,
                policy: PolicyEngine | None = None) -> "Diagnosis":
        """Forwarding host: ship each tick's delta to ``sink`` — an
        object with ``send(delta)``, or an Endpoint/address string to
        connect (needs ``StepTelemetry(wire=True)``)."""
        return cls(sink=sink, policy=policy)

    # -- wiring --------------------------------------------------------------
    @property
    def mode(self) -> str:
        if self.aggregator is not None:
            return "fleet"
        if self.sink is not None:
            return "forward"
        if self.analyzer is not None:
            return "local"
        return "policy"

    def bind(self, telemetry) -> None:
        """Validate ``telemetry`` against the mode and finish wiring
        (idempotent; the engine calls this at construction)."""
        if telemetry is None:
            raise ValueError("diagnosis needs a StepTelemetry to consume")
        if self.mode == "policy":
            return
        if self.mode in ("fleet", "forward"):
            if not getattr(telemetry, "wire", False):
                raise ValueError(
                    "fleet aggregation needs StepTelemetry(wire=True)"
                )
        elif self._stream is None:
            if getattr(telemetry, "live_window", None) is None:
                raise ValueError(
                    "local diagnosis needs StepTelemetry(streaming=True)"
                )
            attributor = None
            if self.attribution:
                from ..core.whatif import WhatIfReplayer

                attributor = WhatIfReplayer(
                    getattr(telemetry, "schema", None),
                    device=getattr(self.analyzer, "device", None),
                )
            self._stream = RootCauseStream(self.analyzer,
                                           telemetry.live_window,
                                           attributor=attributor)

    # -- per-step drive ------------------------------------------------------
    def tick(self, telemetry, step_time: float | None = None) -> list:
        """Consume one step's telemetry and return the tick's freshly
        confirmed causes (empty in forward mode and for non-driving
        fleet parties — the causes live where the sweep runs)."""
        self.bind(telemetry)
        fresh: list = []
        if self.aggregator is not None:
            self.aggregator.ingest_host(telemetry)
            if self.drive:
                fresh = self.aggregator.step(step_time=step_time)
            else:
                # Non-driving tree roles still owe their parent a pump.
                pump = getattr(self.aggregator, "pump", None)
                if pump is not None:
                    pump()
        elif self.sink is not None:
            self.sink.send(telemetry.drain_delta())
        elif self._stream is not None:
            fresh = self._stream.step()
        if self.forecaster is not None:
            # One extra batched launch over the same windows the gate
            # sweep reads; candidates append after the confirmed causes
            # (the stream's dedup state never sees them).  The policy
            # step below receives them too, so rules matching
            # `predicted_straggler` act with lead time — except when the
            # policy is the aggregator's own (already ticked inside the
            # sweep, before forecasts existed this tick).
            if self.aggregator is not None and self.drive:
                windows = list(self.aggregator.store.stages())
            elif self._stream is not None:
                windows = [telemetry.live_window]
            else:
                windows = []
            if windows:
                fresh = list(fresh) + self.forecaster.step(windows)
        if (
            self.policy is not None
            and self.policy is not getattr(self.aggregator, "policy", None)
        ):
            self.policy.step(
                fresh,
                step_time=step_time,
                live_hosts=(self.aggregator.num_live_hosts
                            if self.aggregator is not None else None),
            )
        return fresh

    def flush(self, timeout: float = 30.0) -> bool:
        """End-of-run drain: flush the sink / the aggregator's upstream
        side, whichever exists (True when nothing is left unacked)."""
        target = self.sink if self.sink is not None else self.aggregator
        fl = getattr(target, "flush", None)
        return fl(timeout) if fl is not None else True

    def close(self) -> None:
        for target in (self.sink, self.aggregator):
            cl = getattr(target, "close", None)
            if cl is not None:
                cl()
