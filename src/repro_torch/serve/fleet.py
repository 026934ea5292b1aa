"""Launcher-side fleet aggregation: merged, fleet-wide in-loop diagnosis.

BigRoots' premise is cross-node comparison — a task is only a straggler,
and a cause only a root cause, *relative to its peers* (Eq. 5 peer-mean
gates, Eq. 6 system-feature windows).  N per-host analyzers each looking
at their own window therefore see N one-node stages with no inter-node
peer group at all; the diagnostic signal only exists after the per-host
traces are merged (the sharded-ingest + central-merge architecture of the
what-if straggler and HybridTune studies).

:class:`FleetAggregator` is that central merge point for the streaming
substrate:

- per-host producers run ``StepTelemetry(wire=True)`` and ship
  :class:`~repro_torch.telemetry.events.StepDelta` blocks (columnar wire format
  — bytes across processes, the object in-process);
- the aggregator routes each delta's stage blocks into merged
  :class:`~repro_torch.core.window.SlidingStageWindow`\\ s (one per stage id, so
  hosts sharing a step-window stage pool into one cross-node peer set);
- :meth:`step` drives ``BigRootsAnalyzer.analyze_fleet`` over *all* merged
  windows in one batched gate evaluation and dedups emissions through a
  :class:`~repro_torch.core.window.RootCauseStream` — one fleet-wide in-loop
  diagnosis per tick instead of N per-host ones.

Pre-populated per-host stores (e.g. recovered from a crashed launcher)
enter through :meth:`merge_stores`, which uses the column-level
``SlidingStageWindow.merge`` (exact aggregate recompute + P² re-anchor).

    agg = FleetAggregator(JAX_FEATURES, BigRootsAnalyzer(JAX_FEATURES))
    ... each tick ...
    for host_telem in host_telemetries:
        agg.ingest(host_telem.drain_delta())      # or .to_bytes() payloads
    for cause in agg.step():
        log.warning("fleet straggler %s <- %s", cause.task_id, cause.feature)
"""
from __future__ import annotations

import json
import os
import struct
import time
from dataclasses import dataclass, field

from ..core.analyzer import (
    BigRootsAnalyzer,
    RootCause,
    cause_from_wire,
    synthesize_cause,
)
from ..core.features import FeatureSchema
from ..core.whatif import WhatIfReplayer
from ..core.window import RootCauseStream, StreamingTraceStore
from ..device import resolve_device
from ..ft.policy import PolicyEngine
from ..telemetry.events import (
    MAX_FORWARD_DEPTH,
    ForwardedDelta,
    StageDelta,
    StepDelta,
    StepTelemetry,
    WireFormatError,
)
from ..telemetry.transport import Endpoint

#: Feature name of the synthesized cause a host-dropout escalation emits.
#: Not part of any FeatureSchema — it never gates; it exists so dropout
#: findings flow through the same RootCause pipeline (reports, mitigation
#: planning, dedup) as Eq. 5 findings.
DROPOUT_FEATURE = "host_dropout"


class FleetAggregator:
    """Consume per-host :class:`StepDelta` streams, maintain merged
    per-stage windows, and run one fleet-wide diagnosis per step.

    Parameters
    ----------
    schema:
        Feature schema shared by every producing host.
    analyzer:
        The :class:`~repro_torch.core.analyzer.BigRootsAnalyzer` driving
        :meth:`step` (``analyze_fleet`` when available).  Defaults to a
        plain analyzer over ``schema`` on ``device`` (kernel-batched
        sweeps); pass one with ``timelines`` wired for Eq. 6 edge
        detection, or with ``backend="numpy"`` for in-process gates.
    device:
        Where the sweep's device work runs (the gate kernel, the what-if
        replay): ``None`` takes the passed analyzer's device, else the GPU
        — and raises when there is none; ``"cpu"`` only when asked.
    span, max_rows:
        Per-stage window retention, as for
        :class:`~repro_torch.core.window.SlidingStageWindow`.  ``max_rows`` is
        per merged stage window (the *fleet* row budget, not per host).
    decay_steps, forget_steps:
        Emission dedup/decay policy, as for
        :class:`~repro_torch.core.window.RootCauseStream`.
    attribution:
        When True, a :class:`~repro_torch.core.whatif.WhatIfReplayer` prices
        every freshly confirmed cause with an estimated recovered time
        (counterfactual critical-path replay over the merged windows) —
        each emitted :class:`~repro_torch.core.analyzer.RootCause` carries an
        ``attribution`` and downstream policy ranking/guardrails can
        budget by recovery instead of raw severity.  Off (default), the
        emitted stream is byte-identical to an unattributed aggregator.
    max_stages:
        Retention cap on distinct stage windows: when a new stage would
        exceed it, the oldest-created windows are dropped (an always-on
        loop opens a fresh step-window stage every N steps; exhausted ones
        must not accumulate).  ``None`` disables.
    lease, clock:
        Host-dropout detection: a host whose last accepted delta is more
        than its *effective lease* seconds of wall clock old (``clock``
        defaults to ``time.time``; injectable for tests) is declared
        *dark* at the next :meth:`step` — once per outage, a synthesized
        :class:`~repro_torch.core.analyzer.RootCause` with
        ``feature == DROPOUT_FEATURE`` is appended to the tick's causes,
        with ``severity`` escalated to 2 when the host's nodes carried a
        confirmed cause within the stream's ``decay_steps`` before going
        dark (a host dying *mid-incident* is the finding most worth
        paging on: the straggler signal and its telemetry vanished
        together).  A dark host that reports again rejoins silently
        (``host_rejoins``) — its ``(boot, seq)`` watermarks were kept, so
        redelivered deltas still dedup.  ``lease=None`` (default)
        disables dropout tracking.
    lease_ceiling, lease_multiplier, lease_alpha:
        Adaptive per-host lease: the aggregator keeps an EWMA
        (``lease_alpha`` smoothing) of each host's observed inter-delta
        gap, and a host's *effective* lease is
        ``min(lease_ceiling, max(lease, lease_multiplier × ewma))`` — the
        configured ``lease`` is the floor, ``lease_ceiling`` (default
        ``10 × lease``) the cap, so a slow-cadence host (long checkpoint
        stalls, sparse reporting) isn't falsely declared dropped while a
        fast-cadence host still pages quickly.  Rejoin gaps (the arrival
        that ends an outage) are excluded from the EWMA — an outage is
        not a cadence observation.
    policy:
        Optional :class:`~repro_torch.ft.policy.PolicyEngine` closing the loop:
        every :meth:`step`'s causes are handed to it with the current
        live-host count (so its min-fleet guardrail tracks dropouts), and
        a host that rejoins after a dropout is reported via
        ``note_rejoin`` so the policy's flap damping sees the
        cordon→rejoin→cordon cycle.

    Silent hosts must not freeze retention: every :meth:`step` also
    advances each time-spanned stage window's watermark to the *fleet*
    clock (the max task-end seen across all windows), so stages whose
    hosts went dark keep decaying out of their windows while the rest of
    the fleet moves on, instead of pinning stale rows as eternal peers.

    Duplicate delivery and restarts: deltas carry ``(boot, seq)`` — the
    producer incarnation stamp and its per-drain counter.  The aggregator
    keeps a per-incarnation seq watermark (a small bounded map of recent
    boots per host): a delta whose seq is not newer than its own boot's
    watermark is dropped whole (``duplicate_drops``), so at-least-once
    transports stay safe without idempotence bookkeeping downstream —
    provided delivery is in-order per host (TCP-like FIFO): the watermark
    cannot tell a delayed first delivery from a redelivery, so a
    transport that *reorders* must not be used without resequencing —
    or set ``reorder_window > 0`` and the aggregator resequences
    *bounded* reordering itself: a leaf delta arriving with a seq gap
    (``seq > watermark + 1``; an unseen boot reorders from base 0, so
    even a boot's first frames resequence) is stashed per ``(host, boot)``
    (``reorder_holds``) instead of applied, and drains in seq order as
    the gap fills (an at-least-once transport resends the missing delta,
    so the gap converges).  A stash that outgrows the window gives up on
    the gap and flushes in seq order (``reorder_flushes``) — bounded
    memory beats waiting on a frame the sender shed.  Call
    :meth:`flush_reorders` at end of stream so a trailing gap cannot
    strand stashed rows.  A delta under a boot not seen before is a
    restarted host —
    accepted immediately (``host_restarts``), with no dependence on clock
    direction (a restart after a backward NTP step or snapshot restore is
    not exiled).  Steps a host re-executes after restoring from a
    checkpoint arrive as new rows under the new boot — deliberately:
    re-executed work is re-measured work, and no task-id dedup is
    attempted inside the windows.

    Stage blocks addressed to a stage this aggregator already pruned are
    dropped (``stale_stage_drops``) rather than resurrecting the stage as
    a one-host window with a degenerate peer set.

    Tree ingest: a payload carrying the ``BRDF`` magic is a
    :class:`~repro_torch.telemetry.events.ForwardedDelta` — a downstream
    :class:`TreeAggregator`'s re-stamped envelope around the inner host
    payloads it accepted.  The envelope dedups through the same
    ``(boot, seq)`` watermark as any host (the aggregator *is* a host to
    its parent), then each inner payload is ingested recursively and
    dedups under its **original producer stamp** — so a failed-over
    aggregator re-forwarding payloads an earlier incarnation already
    delivered produces inner ``duplicate_drops``, never duplicate rows,
    and depth-2 tree aggregation stays byte-identical to star ingest.
    Envelope bytes land in ``forwarded_bytes``/``forwarded_frames``;
    ``bytes_ingested`` counts only leaf payloads (no double counting).
    """

    #: Incarnations remembered per host for duplicate detection; beyond
    #: this, the oldest-seen boot's watermark is forgotten (a redelivery
    #: from an incarnation that many generations dead would re-ingest).
    _MAX_BOOTS_PER_HOST = 4

    def __init__(
        self,
        schema: FeatureSchema,
        analyzer: BigRootsAnalyzer | None = None,
        *,
        span: float | None = None,
        max_rows: int | None = None,
        decay_steps: int | None = 256,
        forget_steps: int | None = None,
        max_stages: int | None = 64,
        attribution: bool = False,
        lease: float | None = None,
        lease_ceiling: float | None = None,
        lease_multiplier: float = 4.0,
        lease_alpha: float = 0.25,
        clock=time.time,
        policy: PolicyEngine | None = None,
        reorder_window: int = 0,
        device=None,
    ) -> None:
        self.schema = schema
        if device is None and analyzer is not None:
            device = getattr(analyzer, "device", None)
        self.device = resolve_device(device)
        self.analyzer = (
            analyzer if analyzer is not None
            else BigRootsAnalyzer(schema, device=self.device)
        )
        quantile = getattr(
            getattr(self.analyzer, "thresholds", None), "quantile", 0.9
        )
        self.store = StreamingTraceStore(
            schema, span=span, max_rows=max_rows, quantile=quantile,
        )
        self.attribution = bool(attribution)
        self.stream = RootCauseStream(
            self.analyzer, self.store,
            decay_steps=decay_steps, forget_steps=forget_steps,
            attributor=(
                WhatIfReplayer(schema, device=self.device)
                if attribution else None
            ),
        )
        self.max_stages = max_stages
        self.lease = None if lease is None else float(lease)
        self.lease_ceiling = (
            None if lease_ceiling is None else float(lease_ceiling)
        )
        self.lease_multiplier = float(lease_multiplier)
        self.lease_alpha = float(lease_alpha)
        self._clock = clock
        self.policy = policy
        # host → {boot: last accepted seq}, newest-seen boots last; capped
        # at _MAX_BOOTS_PER_HOST incarnations (see ingest).
        self.host_seq: dict[str, dict[int, int]] = {}
        self.deltas_ingested = 0
        self.rows_ingested = 0
        self.bytes_ingested = 0
        self.forwarded_frames = 0
        self.forwarded_bytes = 0
        self.duplicate_drops = 0
        self.host_restarts = 0
        self.stages_dropped = 0
        self.stale_stage_drops = 0
        # Bounded resequencing of leaf deltas (see class docstring):
        # (host, boot) → {seq: StepDelta} awaiting their gap to fill.
        self.reorder_window = int(reorder_window)
        self._reorder_stash: dict[tuple[str, int], dict[int, StepDelta]] = {}
        self.reorder_holds = 0
        self.reorder_flushes = 0
        # Attributed causes carried in accepted v3 deltas (wire-form
        # dicts), drained into the next step()'s emissions: a leaf's
        # priced findings ride the same payloads as its rows.
        self._remote_causes: list[dict] = []
        self.remote_causes_ingested = 0
        # Insertion-ordered tombstones of pruned stage ids (bounded): a
        # straggling host's late delta must not resurrect a pruned stage.
        self._pruned: dict[str, None] = {}
        # Host-liveness bookkeeping (see the lease parameter).
        self.host_dropouts = 0
        self.host_rejoins = 0
        self.dropped_hosts: set[str] = set()
        self._host_last_wall: dict[str, float] = {}
        self._host_gap_ewma: dict[str, float] = {}
        self._host_nodes: dict[str, set[str]] = {}
        self._host_last_stage: dict[str, str] = {}
        # node → step() index of its last *emitted* cause; feeds the
        # mid-incident severity escalation of dropout findings.
        self._node_last_cause: dict[str, int] = {}
        self._ticks = 0
        # True while a journal recovery replays payloads: replay must
        # not re-journal, re-forward, or feed near-zero gaps to the
        # cadence EWMA (see TreeAggregator._recover).
        self._recovering = False

    # -- ingest ------------------------------------------------------------
    def ingest(self, delta: StepDelta | bytes, *, _depth: int = 0) -> int:
        """Route one host delta (object or wire bytes) into the merged
        windows.  Returns rows ingested (0 for duplicates/empty deltas).
        Wire payloads carrying the forwarded-envelope magic are unwrapped
        recursively (see the class docstring)."""
        raw: bytes | None = None
        if isinstance(delta, (bytes, bytearray, memoryview)):
            raw = bytes(delta)
            if ForwardedDelta.is_forwarded(raw):
                return self._ingest_forwarded(raw, _depth)
            self.bytes_ingested += len(raw)
            delta = StepDelta.from_bytes(raw)
        boots = self.host_seq.setdefault(delta.host, {})
        last_seq = boots.get(delta.boot)
        if last_seq is not None and delta.seq <= last_seq:
            # Redelivery within a known incarnation: drop whole
            # (at-least-once transports are safe).
            self.duplicate_drops += 1
            return 0
        if last_seq is None and boots:
            # Unseen incarnation of a known host: it restarted.  Accept
            # immediately — no starvation while the reborn producer
            # re-earns its pre-crash seq, and no wall-clock comparison (a
            # restart after a backward clock step is not exiled).
            self.host_restarts += 1
        if (self.reorder_window > 0
                and delta.seq > (last_seq or 0) + 1):
            # Seq gap on a reordering transport: stash until the gap
            # fills (the missing delta's resend) or the stash outgrows
            # the window.  An unseen boot reorders from base 0 — seqs
            # start at 1, so a first arrival of seq > 1 means earlier
            # frames may still be in flight; anchoring the watermark on
            # it would drop their resends as duplicates.  A genuine
            # late join (attaching mid-stream) stalls at most one
            # window, then the flush anchors it.
            key = (delta.host, delta.boot)
            stash = self._reorder_stash.setdefault(key, {})
            if delta.seq not in stash:
                stash[delta.seq] = delta
                self.reorder_holds += 1
            if len(stash) > self.reorder_window:
                return self._flush_reorder_key(key)
            return 0
        if self._pruned:
            live_stages = [s for s in delta.stages
                           if s.stage_id not in self._pruned]
            if len(live_stages) != len(delta.stages):
                self.stale_stage_drops += len(delta.stages) - len(live_stages)
                delta = StepDelta(delta.host, delta.seq, live_stages,
                                  boot=delta.boot, causes=delta.causes)
        rows = delta.apply_to(self.store)
        # Commit the watermark only after the delta applied: a delta that
        # raised mid-apply stays un-acked, so its at-least-once retry is
        # re-attempted instead of dropped as a duplicate (a partial first
        # attempt can double-ingest some stage blocks on retry —
        # preferable to losing the rows outright).  Keep only the most
        # recent incarnations per host.
        boots.pop(delta.boot, None)      # re-append as newest-seen
        boots[delta.boot] = delta.seq
        while len(boots) > self._MAX_BOOTS_PER_HOST:
            del boots[next(iter(boots))]
        self.deltas_ingested += 1
        self.rows_ingested += rows
        if delta.causes:
            self._remote_causes.extend(delta.causes)
            self.remote_causes_ingested += len(delta.causes)
        self._note_alive(delta.host, delta.stages)
        self._on_accept(delta, raw)
        self._prune_stages()
        if self._reorder_stash:
            rows += self._drain_reorder(delta.host, delta.boot)
        return rows

    def _ingest_forwarded(self, raw: bytes, depth: int) -> int:
        """Unwrap one forwarded envelope: dedup it under the sending
        aggregator's ``(boot, seq)`` stamp, then ingest the inner
        payloads — each dedups under its own producer stamp, so envelope
        redelivery after an aggregator failover costs inner
        ``duplicate_drops``, never duplicate rows."""
        if depth >= MAX_FORWARD_DEPTH:
            raise WireFormatError(
                f"forwarded envelope nested deeper than {MAX_FORWARD_DEPTH}"
            )
        fwd = ForwardedDelta.from_bytes(raw)
        self.forwarded_frames += 1
        self.forwarded_bytes += len(raw)
        boots = self.host_seq.setdefault(fwd.host, {})
        last_seq = boots.get(fwd.boot)
        if last_seq is not None and fwd.seq <= last_seq:
            self.duplicate_drops += 1
            return 0
        if last_seq is None and boots:
            self.host_restarts += 1
        rows = 0
        for payload in fwd.payloads:
            rows += self.ingest(payload, _depth=depth + 1)
        # Envelope watermark commits only after every inner payload
        # applied — a partial envelope stays redeliverable, and the inner
        # watermarks absorb the overlap on retry.
        boots.pop(fwd.boot, None)
        boots[fwd.boot] = fwd.seq
        while len(boots) > self._MAX_BOOTS_PER_HOST:
            del boots[next(iter(boots))]
        self._note_alive(fwd.host, ())
        return rows

    def _drain_reorder(self, host: str, boot: int) -> int:
        """Apply the stashed delta that the just-committed watermark made
        contiguous, if any (its own ingest chains the next one)."""
        key = (host, boot)
        stash = self._reorder_stash.get(key)
        if not stash:
            self._reorder_stash.pop(key, None)
            return 0
        nxt = stash.pop(self.host_seq[host][boot] + 1, None)
        if not stash:
            del self._reorder_stash[key]
        if nxt is None:
            return 0
        return self.ingest(nxt)

    def _flush_reorder_key(self, key: tuple[str, int]) -> int:
        """Give up on ``key``'s gap: apply its stash in seq order,
        abandoning the missing seqs (counted once in
        ``reorder_flushes``)."""
        stash = self._reorder_stash.pop(key, None)
        if not stash:
            return 0
        self.reorder_flushes += 1
        host, boot = key
        rows = 0
        for seq in sorted(stash):
            boots = self.host_seq.setdefault(host, {})
            last = boots.get(boot)
            if last is None or last < seq - 1:
                # Abandon the gap below this delta.  Anchoring an unseen
                # boot here (last is None) also counts its restart, and
                # keeps the re-ingest below from re-stashing the delta.
                if last is None and boots:
                    self.host_restarts += 1
                boots[boot] = seq - 1
            rows += self.ingest(stash[seq])
        return rows

    def flush_reorders(self) -> int:
        """Apply every stashed out-of-order delta in seq order,
        abandoning unfilled gaps — call at end of stream so a trailing
        gap cannot strand rows.  Returns rows applied."""
        rows = 0
        for key in list(self._reorder_stash):
            rows += self._flush_reorder_key(key)
        return rows

    def _note_alive(self, host: str, stages) -> None:
        """Lease bookkeeping on an accepted delta: last-seen wall clock,
        rejoin detection, and the inter-delta cadence EWMA feeding the
        adaptive effective lease.  The gap that *ends* an outage is not a
        cadence sample — skipped, so one dropout doesn't poison the
        host's learned cadence."""
        if self.lease is not None:
            now = self._clock()
            prev = self._host_last_wall.get(host)
            if host in self.dropped_hosts:
                self.dropped_hosts.discard(host)
                self.host_rejoins += 1
                if self.policy is not None:
                    self.policy.note_rejoin(host)
            elif prev is not None and not self._recovering:
                gap = now - prev
                old = self._host_gap_ewma.get(host)
                self._host_gap_ewma[host] = (
                    gap if old is None
                    else self.lease_alpha * gap + (1 - self.lease_alpha) * old
                )
            self._host_last_wall[host] = now
            nodes = self._host_nodes.setdefault(host, set())
            for s in stages:
                nodes.update(s.nodes)
                self._host_last_stage[host] = s.stage_id

    def effective_lease(self, host: str) -> float | None:
        """The host's adaptive dropout lease:
        ``min(ceiling, max(floor, multiplier × cadence-EWMA))`` with the
        configured ``lease`` as floor and ``lease_ceiling`` (default
        ``10 × lease``) as cap.  ``None`` when leases are disabled."""
        if self.lease is None:
            return None
        ewma = self._host_gap_ewma.get(host)
        if ewma is None:
            return self.lease
        ceiling = (
            self.lease_ceiling if self.lease_ceiling is not None
            else 10.0 * self.lease
        )
        return min(ceiling, max(self.lease, self.lease_multiplier * ewma))

    def _on_accept(self, delta: StepDelta, raw: bytes | None) -> None:
        """Hook fired once per *accepted* leaf delta (post-apply,
        post-watermark).  The base aggregator does nothing;
        :class:`TreeAggregator` journals the payload and queues it for
        upstream forwarding."""

    def ingest_host(self, telem: StepTelemetry) -> int:
        """In-process convenience: drain ``telem``'s pending rows and
        ingest them (no serialization round trip)."""
        return self.ingest(telem.drain_delta())

    def merge_stores(self, *stores: StreamingTraceStore) -> int:
        """Absorb pre-populated per-host streaming stores via the
        column-level window merge (exact aggregate recompute + sketch
        re-anchor per stage).  Returns rows ingested.

        Recovery caveat: stores carry no ``(boot, seq)`` provenance, so
        this does NOT seed the delta dedup watermarks — a launcher
        restoring from recovered stores should also restore its previous
        ``host_seq`` mapping (a plain dict, safe to persist), otherwise
        hosts redelivering their last un-acked deltas will re-ingest rows
        already present in the recovered windows."""
        rows = self.store.merge(*stores)
        self.rows_ingested += rows
        self._prune_stages()
        return rows

    # -- diagnosis ---------------------------------------------------------
    def step(self, *, step_time: float | None = None) -> list:
        """One fleet-wide diagnosis tick over every merged stage window
        (single batched gate evaluation via ``analyze_fleet``).  Returns
        the newly confirmed :class:`~repro_torch.core.analyzer.RootCause`\\ s
        (the stream's emit-once/decay dedup applies), plus one synthesized
        ``DROPOUT_FEATURE`` cause per host whose lease just expired (see
        the class docstring).  Retained time-spanned windows also advance
        to the fleet clock here so silent hosts' stages keep decaying.

        With a ``policy`` (:class:`~repro_torch.ft.policy.PolicyEngine`), the
        tick's causes — dropout escalations included — are handed to the
        policy after diagnosis; a host-dropout finding can thus trigger a
        cordon + re-mesh plan in the same tick it was detected.  Pass the
        caller's measured per-step wall time as ``step_time`` to feed the
        policy's rollback verifier."""
        causes = self.stream.step()
        self._ticks += 1
        for cause in causes:
            self._node_last_cause[cause.node] = self._ticks
        if self._remote_causes:
            # Attributed causes shipped inside v3 deltas: decoded here
            # (not re-diagnosed — the leaf already confirmed and priced
            # them) and surfaced alongside this tick's own emissions.
            remote, self._remote_causes = self._remote_causes, []
            causes.extend(cause_from_wire(d) for d in remote)
        if self.lease is not None:
            causes.extend(self._check_leases())
        self._advance_fleet_clock()
        if self.policy is not None:
            self.policy.step(
                causes, step_time=step_time, live_hosts=self.num_live_hosts
            )
        return causes

    def _check_leases(self) -> list[RootCause]:
        now = self._clock()
        escalated: list[RootCause] = []
        horizon = self.stream.decay_steps or 256
        for host, last in self._host_last_wall.items():
            silent = now - last
            lease = self.effective_lease(host)
            if host in self.dropped_hosts or silent <= lease:
                continue
            self.dropped_hosts.add(host)
            self.host_dropouts += 1
            nodes = sorted(self._host_nodes.get(host, {host}))
            mid_incident = any(
                self._ticks - self._node_last_cause.get(nd, -(horizon + 1))
                <= horizon
                for nd in nodes
            )
            escalated.append(synthesize_cause(
                task_id=f"{host}/dropout",
                stage_id=self._host_last_stage.get(host, ""),
                node=nodes[0] if nodes else host,
                feature=DROPOUT_FEATURE,
                value=float(silent),
                guidance=(
                    f"host {host!r} stopped reporting {silent:.1f}s ago "
                    f"(effective lease {lease:.1f}s, floor {self.lease:.1f}s)"
                    + (" while its nodes carried confirmed straggler "
                       "causes — the incident and its telemetry vanished "
                       "together; treat as a failed host, not a recovery"
                       if mid_incident else
                       "; restart the producer or drop the host from the "
                       "fleet roster")
                ),
                severity=2 if mid_incident else 1,
            ))
        return escalated

    def _advance_fleet_clock(self) -> None:
        """Advance every time-spanned window's watermark to the fleet
        clock (max task-end across windows): a stage whose hosts all went
        dark never sees another ingest-driven ``advance``, and without
        this its rows would sit as eternal peers in retained windows."""
        if self.store.span is None:
            return
        windows = list(self.store.stages())
        now = max((w.t_max for w in windows), default=None)
        if now is None:
            return
        for w in windows:
            w.advance(now)

    @property
    def last_analysis(self):
        return self.stream.last_analysis

    @property
    def num_hosts(self) -> int:
        return len(self.host_seq)

    @property
    def num_live_hosts(self) -> int:
        """Hosts ever seen minus those currently past their lease."""
        return len(self.host_seq) - len(self.dropped_hosts)

    @property
    def num_live_rows(self) -> int:
        return self.store.num_tasks

    # -- retention ---------------------------------------------------------
    def _prune_stages(self) -> None:
        if self.max_stages is None:
            return
        excess = len(self.store.stage_ids()) - self.max_stages
        if excess > 0:
            for stage_id in self.store.stage_ids()[:excess]:
                self.store.drop_stage(stage_id)
                self.stages_dropped += 1
                self._pruned[stage_id] = None
            # Bound the tombstone set: ids older than several retention
            # generations cannot plausibly recur on a live fleet.
            cap = 8 * self.max_stages
            while len(self._pruned) > cap:
                del self._pruned[next(iter(self._pruned))]


# -- aggregator HA journal ---------------------------------------------------

@dataclass
class JournalRecovery:
    """What :meth:`AggregatorJournal.recover` read back from disk.

    ``payloads`` preserves append order as ``(pid, raw, in_image,
    acked)``: ``in_image`` payloads' rows are already inside the window
    snapshot (skip re-ingest, re-forward if unacked); post-snapshot
    payloads need re-ingest too.
    """

    state: dict | None = None
    windows_payload: bytes | None = None
    payloads: list = field(default_factory=list)


class AggregatorJournal:
    """Append-only on-disk journal backing aggregator HA.

    A :class:`TreeAggregator` appends every accepted leaf payload, every
    forward batch, and every parent ack; periodically it *compacts* —
    rewrites the file as one ``SNAPSHOT`` record (aggregator state JSON +
    the merged windows exported as a StepDelta image) plus only the
    still-unacked payloads (flagged *in-image*).  A restarted aggregator
    :meth:`recover`\\ s the snapshot, replays post-snapshot payloads into
    its windows, and re-queues unacked payloads for forwarding — its
    ``host_seq`` watermarks, learned cadence EWMAs, and dedup state
    resume instead of being re-learned (ROADMAP: aggregator HA).

    On-disk layout: magic ``BRJ1``, then records of
    ``u32 body length | u8 type | body``:

    - ``PAYLOAD`` (1): ``u8 flags (bit0 = in-image) | u64 pid | raw payload``
    - ``FORWARD`` (2): ``u64 boot | u64 fwd_seq | u32 n | n × u64 pid``
    - ``ACK``     (3): ``u64 boot | u64 fwd_seq``
    - ``SNAPSHOT`` (4): ``u32 json length | state JSON | windows StepDelta``

    A truncated tail (crash mid-append) is tolerated: recovery stops at
    the first incomplete or malformed record and keeps everything before
    it.  Compaction writes a temp file and ``os.replace``\\ s it — the
    journal is always either the old image or the new one, never a mix.
    ``fsync=True`` makes every append durable against power loss (off by
    default: process-crash durability only, the fleet-demo/CI posture).
    """

    MAGIC = b"BRJ1"
    PAYLOAD, FORWARD, ACK, SNAPSHOT = 1, 2, 3, 4
    _F_IN_IMAGE = 1
    _HEAD = struct.Struct("<IB")

    def __init__(self, path: str, *, fsync: bool = False) -> None:
        self.path = str(path)
        self.fsync = bool(fsync)
        self._f = None
        self._next_pid = 0
        self.size = 0

    # -- append side -------------------------------------------------------
    def _open(self):
        if self._f is None:
            fresh = (
                not os.path.exists(self.path)
                or os.path.getsize(self.path) == 0
            )
            self._f = open(self.path, "ab")
            if fresh:
                self._f.write(self.MAGIC)
                self._f.flush()
            self.size = os.path.getsize(self.path)
        return self._f

    def _append(self, rtype: int, body: bytes) -> None:
        f = self._open()
        f.write(self._HEAD.pack(len(body), rtype))
        f.write(body)
        f.flush()
        if self.fsync:
            os.fsync(f.fileno())
        self.size += self._HEAD.size + len(body)

    def append_payload(self, raw: bytes, *, in_image: bool = False) -> int:
        """Journal one accepted payload; returns its pid (the handle
        FORWARD records reference)."""
        pid = self._next_pid
        self._next_pid += 1
        flags = self._F_IN_IMAGE if in_image else 0
        self._append(self.PAYLOAD, struct.pack("<BQ", flags, pid) + bytes(raw))
        return pid

    def note_forward(self, boot: int, fwd_seq: int, pids) -> None:
        body = struct.pack("<QQI", boot, fwd_seq, len(pids))
        body += b"".join(struct.pack("<Q", int(p)) for p in pids)
        self._append(self.FORWARD, body)

    def note_ack(self, boot: int, fwd_seq: int) -> None:
        self._append(self.ACK, struct.pack("<QQ", boot, fwd_seq))

    # -- compaction --------------------------------------------------------
    def compact(self, state: dict, windows_payload: bytes,
                keep: list) -> None:
        """Atomically rewrite the journal as SNAPSHOT(state, windows) +
        the ``keep`` payloads (``(pid, raw)`` pairs, flagged in-image:
        their rows are inside the snapshot, they are retained only for
        re-forwarding)."""
        tmp = self.path + ".tmp"
        sj = json.dumps(state, separators=(",", ":")).encode()
        with open(tmp, "wb") as f:
            f.write(self.MAGIC)
            body = struct.pack("<I", len(sj)) + sj + bytes(windows_payload)
            f.write(self._HEAD.pack(len(body), self.SNAPSHOT))
            f.write(body)
            for pid, raw in keep:
                pb = struct.pack("<BQ", self._F_IN_IMAGE, int(pid)) + bytes(raw)
                f.write(self._HEAD.pack(len(pb), self.PAYLOAD))
                f.write(pb)
            f.flush()
            os.fsync(f.fileno())
        if self._f is not None:
            self._f.close()
            self._f = None
        os.replace(tmp, self.path)
        self.size = os.path.getsize(self.path)

    # -- recovery ----------------------------------------------------------
    def recover(self) -> JournalRecovery | None:
        """Read the journal back (tolerating a truncated tail); returns
        ``None`` for a missing/empty/foreign file (fresh start).  Leaves
        the instance positioned to append: pids continue after the
        largest recovered pid."""
        if not os.path.exists(self.path):
            return None
        with open(self.path, "rb") as f:
            data = f.read()
        if len(data) < len(self.MAGIC) or not data.startswith(self.MAGIC):
            return None
        rec = JournalRecovery()
        raw_by_pid: dict[int, tuple[bytes, bool]] = {}
        order: list[int] = []
        fwd_pids: dict[tuple[int, int], tuple[int, ...]] = {}
        acked: set[int] = set()
        off = len(self.MAGIC)
        while off + self._HEAD.size <= len(data):
            ln, rtype = self._HEAD.unpack_from(data, off)
            if off + self._HEAD.size + ln > len(data):
                break  # truncated tail: crash mid-append
            body = data[off + self._HEAD.size: off + self._HEAD.size + ln]
            off += self._HEAD.size + ln
            try:
                if rtype == self.PAYLOAD:
                    if len(body) < 9:
                        break
                    flags, pid = struct.unpack_from("<BQ", body)
                    raw_by_pid[pid] = (
                        body[9:], bool(flags & self._F_IN_IMAGE)
                    )
                    if pid not in order:
                        order.append(pid)
                elif rtype == self.FORWARD:
                    if len(body) < 20:
                        break
                    boot, seq, n = struct.unpack_from("<QQI", body)
                    if len(body) != 20 + 8 * n:
                        break
                    fwd_pids[(boot, seq)] = struct.unpack_from(
                        f"<{n}Q", body, 20
                    ) if n else ()
                elif rtype == self.ACK:
                    if len(body) != 16:
                        break
                    boot, seq = struct.unpack_from("<QQ", body)
                    acked.update(fwd_pids.get((boot, seq), ()))
                elif rtype == self.SNAPSHOT:
                    if len(body) < 4:
                        break
                    (jlen,) = struct.unpack_from("<I", body)
                    if 4 + jlen > len(body):
                        break
                    rec.state = json.loads(body[4: 4 + jlen].decode())
                    win = body[4 + jlen:]
                    rec.windows_payload = win if win else None
                else:
                    break  # unknown record type: stop (forward-compat)
            except (struct.error, ValueError):
                break
        self._next_pid = max(raw_by_pid, default=-1) + 1
        rec.payloads = [
            (pid, raw_by_pid[pid][0], raw_by_pid[pid][1], pid in acked)
            for pid in order
        ]
        return rec

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


# -- tree aggregation --------------------------------------------------------

class TreeAggregator(FleetAggregator):
    """A fan-in tree node: a :class:`FleetAggregator` over its sub-fleet
    that *also* forwards everything it accepts upstream as re-stamped
    :class:`~repro_torch.telemetry.events.ForwardedDelta` envelopes.

    Downstream it is served exactly like a root (point a
    :class:`~repro_torch.telemetry.transport.DeltaServer` at it and
    ``drain_into``); upstream it is a host: envelopes carry ``name`` as
    the host id and this incarnation's ``(boot, fwd_seq)`` stamp, so the
    parent's watermark dedup needs no new machinery.  Inner payloads are
    forwarded **verbatim** — the exact bytes accepted from children, each
    keeping its original producer stamp — which is what keeps depth-N
    aggregation byte-identical to star ingest (the associative-merge
    property) and makes failover safe: a restarted aggregator
    re-forwarding already-delivered payloads costs the root inner
    duplicate drops, never duplicate rows.

    Parameters (beyond :class:`FleetAggregator`'s)
    ----------------------------------------------
    name:
        Fleet-unique aggregator identity — the ``host`` field of its
        envelopes.  Stable across restarts (the new incarnation keeps the
        name, gets a fresh ``boot``).
    parent:
        Where to forward: an :class:`~repro_torch.telemetry.transport.Endpoint`
        / address string (connected lazily via ``Endpoint.connect()``),
        an object with ``send_bytes(payload, boot, seq)`` (e.g. a
        :class:`~repro_torch.telemetry.transport.DeltaClient` — anything with
        ``take_acks()`` gets journal acks wired through), or ``None`` for
        a journaled *root* (HA without forwarding).
    journal:
        ``None`` (no HA), a path string, or an :class:`AggregatorJournal`.
        With a journal, construction recovers: snapshot state + windows
        restore, post-snapshot payloads replay, unacked payloads re-queue
        for forwarding.  Recovered hosts get a fresh lease grace (their
        last-seen clock re-anchors to now) but keep their learned cadence
        EWMAs.
    forward_batch:
        Max inner payloads per envelope.
    journal_compact_bytes:
        Journal size that triggers compaction at the next :meth:`pump`.

    Drive :meth:`pump` every tick (``step()`` does it for roles that also
    run local diagnosis) — it processes parent acks, sends pending
    envelopes, and compacts the journal.
    """

    def __init__(
        self,
        schema: FeatureSchema,
        analyzer: BigRootsAnalyzer | None = None,
        *,
        name: str,
        parent=None,
        journal: AggregatorJournal | str | None = None,
        forward_batch: int = 64,
        journal_compact_bytes: int = 1 << 20,
        fsync: bool = False,
        boot: int | None = None,
        **kwargs,
    ) -> None:
        super().__init__(schema, analyzer, **kwargs)
        self.name = str(name)
        # Incarnation stamp on forwarded envelopes.  Wall nanoseconds by
        # default; deterministic harnesses inject one (each restart must
        # still pass a *fresh* boot — the parent's dedup keys on it).
        self.boot = time.time_ns() if boot is None else int(boot)
        self.forward_batch = int(forward_batch)
        self.journal_compact_bytes = int(journal_compact_bytes)
        self._fwd_seq = 0
        # (pid, raw) accepted but not yet enveloped / envelopes in flight.
        self._pending: list[tuple[int | None, bytes]] = []
        self._inflight: dict[int, list[tuple[int | None, bytes]]] = {}
        self.forwards_sent = 0
        self.forward_acks = 0
        self.recovered_payloads = 0
        self.recovered_rows = 0
        self._owns_parent = False
        if parent is None or hasattr(parent, "send_bytes"):
            self.parent = parent
        else:
            self.parent = Endpoint.parse(parent).connect()
            self._owns_parent = True
        if journal is None or isinstance(journal, AggregatorJournal):
            self.journal = journal
        else:
            self.journal = AggregatorJournal(str(journal), fsync=fsync)
        if self.journal is not None:
            self._recover()

    # -- accept hook (called by FleetAggregator.ingest) --------------------
    def _on_accept(self, delta: StepDelta, raw: bytes | None) -> None:
        if self._recovering:
            return
        if self.parent is None and self.journal is None:
            return
        if raw is None:
            raw = delta.to_bytes()
        pid = (
            self.journal.append_payload(raw)
            if self.journal is not None else None
        )
        if self.parent is not None:
            self._pending.append((pid, raw))

    # -- upstream side ------------------------------------------------------
    def pump(self) -> int:
        """One upstream turn: retire acked envelopes (journal ACKs),
        envelope + send pending payloads, compact the journal past its
        budget.  Returns envelopes sent."""
        self._drain_acks()
        sent = 0
        while self.parent is not None and self._pending:
            batch = self._pending[: self.forward_batch]
            del self._pending[: len(batch)]
            self._fwd_seq += 1
            env = ForwardedDelta(
                self.name, self._fwd_seq,
                [raw for _, raw in batch], boot=self.boot,
            )
            if self.journal is not None:
                self.journal.note_forward(
                    self.boot, self._fwd_seq,
                    [pid for pid, _ in batch if pid is not None],
                )
            self._inflight[self._fwd_seq] = batch
            ok = self.parent.send_bytes(env.to_bytes(), self.boot,
                                        self._fwd_seq)
            self.forwards_sent += 1
            sent += 1
            if ok and not hasattr(self.parent, "take_acks"):
                # Ack-less parent (e.g. a shm ring): a successful push is
                # the delivery — retire immediately.
                self._inflight.pop(self._fwd_seq, None)
                self.forward_acks += 1
                if self.journal is not None:
                    self.journal.note_ack(self.boot, self._fwd_seq)
        self._drain_acks()
        self._maybe_compact()
        return sent

    def _drain_acks(self) -> None:
        take = getattr(self.parent, "take_acks", None)
        if take is None:
            return
        for boot, seq in take():
            if boot != self.boot:
                continue
            if self._inflight.pop(seq, None) is not None:
                self.forward_acks += 1
                if self.journal is not None:
                    self.journal.note_ack(boot, seq)

    @property
    def pending_forwards(self) -> int:
        """Payloads accepted but not yet acked by the parent."""
        return len(self._pending) + sum(
            len(b) for b in self._inflight.values()
        )

    def step(self, *, step_time: float | None = None) -> list:
        """Local diagnosis tick (inherited) followed by :meth:`pump` —
        one call drives both faces of the role."""
        causes = super().step(step_time=step_time)
        self.pump()
        return causes

    def flush(self, timeout: float = 30.0) -> bool:
        """Envelope + send everything pending, then block until the
        parent acked it all (parents without ``flush`` return True)."""
        self.pump()
        fl = getattr(self.parent, "flush", None)
        ok = fl(timeout) if fl is not None else True
        if ok:
            self._drain_acks()
        return ok and not self._inflight

    def close(self) -> None:
        if self._owns_parent and self.parent is not None:
            self.parent.close()
        if self.journal is not None:
            self.journal.close()

    # -- HA: journal snapshot / recovery ------------------------------------
    def _export_state(self) -> dict:
        return {
            "host_seq": {
                h: {str(b): s for b, s in boots.items()}
                for h, boots in self.host_seq.items()
            },
            "ewma": dict(self._host_gap_ewma),
            "host_nodes": {
                h: sorted(v) for h, v in self._host_nodes.items()
            },
            "host_last_stage": dict(self._host_last_stage),
        }

    def _export_windows(self) -> bytes:
        stages = [
            StageDelta(**w.export_live()) for w in self.store.stages()
        ]
        stages = [s for s in stages if len(s)]
        if not stages:
            return b""
        return StepDelta(
            f"{self.name}/__image__", 0, stages, boot=0
        ).to_bytes()

    def compact_journal(self) -> None:
        """Snapshot state + windows into the journal, retaining only
        still-unacked payloads (see :meth:`AggregatorJournal.compact`)."""
        if self.journal is None:
            return
        keep = [
            (pid, raw)
            for batch in self._inflight.values()
            for pid, raw in batch
            if pid is not None
        ] + [(pid, raw) for pid, raw in self._pending if pid is not None]
        self.journal.compact(self._export_state(), self._export_windows(),
                             keep)

    def _maybe_compact(self) -> None:
        if (
            self.journal is not None
            and self.journal.size >= self.journal_compact_bytes
        ):
            self.compact_journal()

    def _recover(self) -> None:
        rec = self.journal.recover()
        if rec is None:
            return
        st = rec.state or {}
        self.host_seq = {
            h: {int(b): int(s) for b, s in boots.items()}
            for h, boots in st.get("host_seq", {}).items()
        }
        self._host_gap_ewma = {
            h: float(v) for h, v in st.get("ewma", {}).items()
        }
        self._host_nodes = {
            h: set(v) for h, v in st.get("host_nodes", {}).items()
        }
        self._host_last_stage = dict(st.get("host_last_stage", {}))
        if self.lease is not None:
            # Fresh grace period: a restart must not page every host as
            # dark on tick one; learned cadences (EWMAs) survive.
            now = self._clock()
            self._host_last_wall = {h: now for h in self.host_seq}
        if rec.windows_payload:
            image = StepDelta.from_bytes(rec.windows_payload)
            self.recovered_rows += image.apply_to(self.store)
        self._recovering = True
        try:
            for pid, raw, in_image, acked in rec.payloads:
                if not in_image:
                    try:
                        self.recovered_rows += self.ingest(raw)
                    except WireFormatError:
                        continue
                if not acked and self.parent is not None:
                    self._pending.append((pid, raw))
                    self.recovered_payloads += 1
        finally:
            self._recovering = False
