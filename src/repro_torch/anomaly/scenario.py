"""Deterministic discrete-event fleet scenario engine.

The in-process injectors (:mod:`repro_torch.anomaly.sim`, ``.loop``) stage
single-host incidents against an analyzer; nothing in the suite exercises
the *distributed* stack — transport resends, tree fan-in, journal
recovery, leases, policy — under the correlated fleet-scale failures it
was built for.  This module closes that gap with a seeded discrete-event
simulator (simulated clock + ``heapq`` event queue, the classic CloudSim
shape): per-host telemetry generators drive **real**
:class:`~repro_torch.telemetry.events.StepTelemetry` producers whose wire
payloads cross modelled links (bandwidth, latency, loss, duplication,
jitter, at-least-once resend) into **real**
:class:`~repro_torch.serve.fleet.FleetAggregator` /
:class:`~repro_torch.serve.fleet.TreeAggregator` instances (real journals on
disk, real :class:`~repro_torch.core.analyzer.BigRootsAnalyzer` diagnosis, real
:class:`~repro_torch.ft.policy.PolicyEngine` mitigation).  Only the bytes'
*carriage* is simulated — serialization, dedup, recovery, diagnosis and
policy are the production code paths.

Everything runs at simulated time: a ten-minute, thousand-host outage
replays in seconds, and the same seed replays **byte-identical** — the
event trace and the emitted cause stream are both deterministic, which is
what lets each library scenario pin a golden cause stream checked
byte-for-byte in CI (the ``scenarios`` lane; see ``main`` below and
"Authoring a scenario" in docs/operations.md).

Scenario scripts are declarative data — a fleet shape plus a timeline of
:class:`Incident` s (``Scenario.from_dict`` accepts the JSON form)::

    sc = Scenario(
        name="rack-down", seed=7, hosts=64, racks=8, steps=40,
        incidents=(
            Incident("rack_degrade", at=8.0, duration=14.0, racks=(2,),
                     params={"loss": 0.3, "latency_x": 10.0}),
            Incident("host_crash", at=15.0, hosts=("h0011",)),
        ),
    )
    result = ScenarioEngine(sc).run()
    result.cause_lines     # canonical cause stream
    result.trace_lines     # full event trace (same seed -> same bytes)

Incident kinds
--------------
``cpu_contend`` / ``disk_contend``
    External contention on the selected hosts: saturated ``cpu`` /
    inflated ``data_load`` phase — the classic BigRoots straggler signal
    (injected "high resource utilization", paper §IV-A).
``rack_degrade``
    Network degradation on the selected racks' links: multiplied latency
    (``latency_x``), divided bandwidth (``bandwidth_div``), added
    ``loss`` probability, plus network-starved input pipelines
    (``data_load_x``) on the affected hosts.
``host_crash``
    The selected hosts stop stepping and their client state dies with
    them (unacked buffers cleared).  Without ``restart_after`` the
    aggregator's lease machinery must page a dropout; with it the host
    returns under a fresh ``boot`` (the aggregator counts a restart,
    then a rejoin).
``agg_restart``
    SIGKILL analog for tree topologies: leaf aggregator ``params["agg"]``
    dies at ``at`` (in-memory state and inbox lost) and is rebuilt from
    its journal ``restart_after`` seconds later — children's resend
    timers then replay the backlog in a thundering herd the dedup
    watermarks must absorb.
``clock_skew``
    The selected hosts' telemetry clocks run offset by ``params["skew"]``
    seconds for the duration — stamps drift relative to the fleet, the
    diagnosis must not.
"""
from __future__ import annotations

import argparse
import hashlib
import heapq
import json
import os
import random
import re
import sys
import tempfile
import time
from dataclasses import dataclass, field, replace

import numpy as np

from ..core.analyzer import BigRootsAnalyzer, RootCause
from ..core.features import JAX_FEATURES, FeatureKind
from ..device import resolve_device
from ..ft.policy import GuardrailConfig, PolicyEngine, RecordingActuator
from ..serve.fleet import FleetAggregator, TreeAggregator
from ..telemetry.events import StepTelemetry, WireFormatError

__all__ = [
    "EpisodeSet",
    "Incident",
    "LinkProfile",
    "Scenario",
    "ScenarioEngine",
    "ScenarioResult",
    "SCENARIO_LIBRARY",
    "build_scenario",
    "export_episodes",
    "run_scenario",
]


# -- declarative script format ------------------------------------------------

@dataclass(frozen=True)
class LinkProfile:
    """Per-link carriage model: fixed ``latency_s`` plus
    ``size / bandwidth_bps`` serialization delay plus uniform
    ``jitter_s`` draw; independent ``loss`` / ``dup`` probabilities per
    transmission; unacked payloads retransmit every ``rto_s`` (simulated
    seconds) until acked — the at-least-once contract of the real
    :class:`~repro_torch.telemetry.transport.DeltaClient`.

    ``ordered=True`` (the default) models the real TCP stream: frames
    never overtake each other (FIFO delivery clamp) and a lost segment
    surfaces as ``rto_s`` of head-of-line delay, never as an
    application-visible gap — exactly what the socket transport presents
    to the aggregator.  ``ordered=False`` is a datagram-style fabric:
    loss makes real gaps (filled later by the sender's in-order replay)
    and jitter may reorder frames — the mode that exercises the
    aggregator's ``reorder_window`` resequencing."""

    latency_s: float = 0.005
    bandwidth_bps: float = 1e9
    jitter_s: float = 0.0
    loss: float = 0.0
    dup: float = 0.0
    rto_s: float = 3.0
    ordered: bool = True

    def to_dict(self) -> dict:
        return {
            "latency_s": self.latency_s, "bandwidth_bps": self.bandwidth_bps,
            "jitter_s": self.jitter_s, "loss": self.loss, "dup": self.dup,
            "rto_s": self.rto_s, "ordered": self.ordered,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LinkProfile":
        return cls(**d)


@dataclass(frozen=True)
class Incident:
    """One timeline entry: ``kind`` applied to the selected scope
    (explicit ``hosts`` ids and/or whole ``racks``) from ``at`` for
    ``duration`` simulated seconds (``inf`` = until end of run).
    Kind-specific knobs ride in ``params`` (see the module docstring)."""

    kind: str
    at: float
    duration: float = float("inf")
    hosts: tuple[str, ...] = ()
    racks: tuple[int, ...] = ()
    params: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "at": self.at}
        if self.duration != float("inf"):
            d["duration"] = self.duration
        if self.hosts:
            d["hosts"] = list(self.hosts)
        if self.racks:
            d["racks"] = list(self.racks)
        if self.params:
            d["params"] = dict(self.params)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Incident":
        return cls(
            kind=d["kind"], at=float(d["at"]),
            duration=float(d.get("duration", float("inf"))),
            hosts=tuple(d.get("hosts", ())),
            racks=tuple(int(r) for r in d.get("racks", ())),
            params=dict(d.get("params", {})),
        )


@dataclass(frozen=True)
class Scenario:
    """A complete declarative scenario script: fleet shape, workload
    cadence, transport model, aggregator knobs, incident timeline.
    ``to_dict``/``from_dict`` round-trip the JSON script form."""

    name: str
    seed: int = 0
    hosts: int = 16
    racks: int = 4
    steps: int = 32              # nominal steps per host: the workload
                                 # runs for steps*period sim seconds and
                                 # every host stops at that horizon
                                 # together (stragglers complete fewer)
    period: float = 1.0          # nominal step duration (sim seconds)
    window: int = 8              # steps per stage (peer pooling)
    topology: str = "star"       # "star" | "tree"
    fanout: int = 8              # hosts per leaf aggregator (tree)
    tick_period: float = 1.0     # aggregator diagnosis cadence
    lease: float | None = 3.0
    reorder_window: int = 0
    policy: bool = True
    noise: float = 0.04          # per-host uniform jitter on baselines
    cooldown: float = 10.0       # extra sim time after the last step
    link: LinkProfile = field(default_factory=LinkProfile)
    incidents: tuple[Incident, ...] = ()

    def to_dict(self) -> dict:
        return {
            "name": self.name, "seed": self.seed, "hosts": self.hosts,
            "racks": self.racks, "steps": self.steps, "period": self.period,
            "window": self.window, "topology": self.topology,
            "fanout": self.fanout, "tick_period": self.tick_period,
            "lease": self.lease, "reorder_window": self.reorder_window,
            "policy": self.policy, "noise": self.noise,
            "cooldown": self.cooldown, "link": self.link.to_dict(),
            "incidents": [i.to_dict() for i in self.incidents],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        d = dict(d)
        link = d.pop("link", None)
        incidents = d.pop("incidents", [])
        return cls(
            link=LinkProfile.from_dict(link) if link else LinkProfile(),
            incidents=tuple(Incident.from_dict(i) for i in incidents),
            **d,
        )

    def host_id(self, i: int) -> str:
        return f"h{i:04d}"

    def rack_of(self, i: int) -> int:
        per = max(1, (self.hosts + self.racks - 1) // self.racks)
        return i // per


# -- simulated time -----------------------------------------------------------

class SimClock:
    """The engine's clock: advanced only by the event loop.  Callable so
    it drops into every ``clock=`` seam (``FleetAggregator``,
    ``StepTelemetry``, ``DeltaClient``)."""

    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


class HostClock:
    """A host's view of time: the engine clock plus this host's skew,
    plus an intra-step offset the telemetry generator advances through
    phases (so one atomic step event still yields ``end > start``)."""

    def __init__(self, base: SimClock) -> None:
        self.base = base
        self.skew = 0.0
        self.offset = 0.0

    def __call__(self) -> float:
        return self.base.t + self.skew + self.offset


# -- link model ---------------------------------------------------------------

class SimLink:
    """One modelled host→aggregator edge implementing the delivery
    contract of the real socket transport — at-least-once with per-key
    acks and RTO-driven resends — over a lossy/duplicating/jittery
    carriage.  Exposes the ``send_bytes``/``take_acks``/``flush``
    surface, so a real :class:`TreeAggregator` forwards its envelopes
    through it unchanged (socket-vs-sim equivalence is pinned by
    tests/test_scenario.py)."""

    def __init__(self, engine: "ScenarioEngine", name: str,
                 profile: LinkProfile, rng: random.Random,
                 dst: "AggNode") -> None:
        self.engine = engine
        self.name = name
        self.profile = profile
        self.rng = rng
        self.dst = dst
        self.unacked: dict[tuple[int, int], bytes] = {}
        self.epoch = 0            # bumped on reset(): orphans in-flight events
        self._fifo_t = 0.0        # ordered carriage: next free delivery slot
        self._stalled = False     # connection down: sends buffer, probe waits
        self._ingested: set[tuple[int, int]] = set()   # acked-at-dst keys
        self._ack_history: list[tuple[int, int]] = []
        self.sent = 0
        self.delivered = 0
        self.lost = 0
        self.duplicated = 0
        self.resends = 0
        self.dead_drops = 0

    # -- DeltaClient-compatible surface --
    def send_bytes(self, payload: bytes, boot: int, seq: int) -> bool:
        key = (boot, seq)
        self.unacked[key] = payload
        if self._stalled or not self.dst.alive:
            # Connection down: like the real client, the frame only
            # joins the resend buffer; the reconnect probe (the oldest
            # frame's RTO timer) replays everything in order later.
            # Transmitting now would let this frame overtake the
            # backlog and trick the watermark into abandoning the gap.
            if not self._stalled:
                self._stalled = True
                self.engine.trace("link.down", self.name)
            epoch = self.epoch
            self.engine.at(self.engine.now + self.profile.rto_s,
                           lambda: self._check_resend(key, epoch))
            return True
        self._transmit(key, payload)
        return True

    def take_acks(self) -> list[tuple[int, int]]:
        out, self._ack_history = self._ack_history, []
        return out

    def flush(self, timeout: float = 0.0) -> bool:
        return not self.unacked

    def close(self) -> None:  # surface parity; nothing to tear down
        pass

    def orphans(self) -> int:
        """Unacked keys that would die with the sending process: not yet
        ingested at the destination and not sitting in its inbox — the
        rows a ``reset()`` right now would genuinely lose."""
        inboxed = {k for (ln, _e, k, _p) in self.dst.inbox if ln is self}
        return sum(1 for k in self.unacked
                   if k not in inboxed and k not in self._ingested)

    def reset(self) -> None:
        """The sending process died: its resend buffer dies with it."""
        self.epoch += 1
        self.unacked.clear()
        self._fifo_t = 0.0
        self._stalled = False
        self._ingested.clear()
        self._ack_history.clear()

    # -- carriage --
    def _transmit(self, key: tuple[int, int], payload: bytes) -> None:
        e, p = self.engine, self.profile
        self.sent += 1
        epoch = self.epoch
        delay = p.latency_s + len(payload) / p.bandwidth_bps
        if p.jitter_s:
            delay += p.jitter_s * self.rng.random()
        lost = self.rng.random() < p.loss
        if lost and p.ordered:
            # TCP-like stream: the segment is retransmitted beneath the
            # surface — the receiver sees head-of-line delay, not a gap.
            self.lost += 1
            e.trace("link.stall", f"{self.name} key={key[0]}:{key[1]}")
            delay += p.rto_s
            lost = False
        if lost:
            self.lost += 1
            e.trace("link.loss", f"{self.name} key={key[0]}:{key[1]}")
        else:
            at = e.now + delay
            if p.ordered:
                # FIFO clamp: nothing overtakes an earlier frame.
                at = max(at, self._fifo_t)
                self._fifo_t = at
            e.at(at, lambda: self._deliver(key, payload, epoch))
            if p.dup and self.rng.random() < p.dup:
                self.duplicated += 1
                extra = p.jitter_s * self.rng.random()
                e.trace("link.dup", f"{self.name} key={key[0]}:{key[1]}")
                e.at(at + extra,
                     lambda: self._deliver(key, payload, epoch))
        e.at(e.now + p.rto_s, lambda: self._check_resend(key, epoch))

    def _deliver(self, key: tuple[int, int], payload: bytes,
                 epoch: int) -> None:
        if epoch != self.epoch:
            return
        if not self.dst.alive:
            self.dead_drops += 1
            self.engine.trace(
                "link.dead_drop", f"{self.name} key={key[0]}:{key[1]}"
            )
            return
        self.delivered += 1
        self.dst.inbox.append((self, epoch, key, payload))

    def ack(self, key: tuple[int, int], epoch: int) -> None:
        """Called by the destination after *ingest* (the durable point —
        the journal, when there is one, has the payload): drain-mode ack
        semantics, delayed by the return latency."""
        e, p = self.engine, self.profile
        if epoch == self.epoch:
            self._ingested.add(key)   # durable at dst even if the ack races
        delay = p.latency_s + (p.jitter_s * self.rng.random()
                               if p.jitter_s else 0.0)
        e.at(e.now + delay, lambda: self._acked(key, epoch))

    def _acked(self, key: tuple[int, int], epoch: int) -> None:
        if epoch != self.epoch:
            return
        if self.unacked.pop(key, None) is not None:
            self._ack_history.append(key)

    def _check_resend(self, key: tuple[int, int], epoch: int) -> None:
        if epoch != self.epoch or self.engine.now > self.engine._horizon:
            return  # the run is settling: stop the retry loop
        if key not in self.unacked:
            return
        if key != next(iter(self.unacked)):
            # Only the oldest unacked frame's timer drives a replay; the
            # younger frames ride along below, once per RTO cycle.
            return
        if not self.dst.alive:
            # Reconnect refused: stay down, probe again next RTO —
            # the real client's bounded-backoff reconnect loop.
            self._stalled = True
            self.engine.at(self.engine.now + self.profile.rto_s,
                           lambda: self._check_resend(key, epoch))
            return
        self._stalled = False
        # Mirror the real DeltaClient reconnect contract: replay the WHOLE
        # resend buffer in send order.  Independent per-key retransmission
        # would let a younger seq overtake the gap after a receiver outage,
        # and the watermark dedup downstream would then abandon the older
        # rows as duplicates — breaking row conservation.
        batch = list(self.unacked.items())
        self.resends += len(batch)
        self.engine.trace(
            "link.resend", f"{self.name} head={key[0]}:{key[1]} n={len(batch)}"
        )
        for k, payload in batch:
            self._transmit(k, payload)


# -- fleet roles --------------------------------------------------------------

class AggNode:
    """An aggregator process in the simulation: the real aggregator
    object plus its delivery inbox and liveness flag."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.agg: FleetAggregator | None = None
        self.inbox: list[tuple[SimLink, int, tuple[int, int], bytes]] = []
        self.alive = True
        self.wire_errors = 0


class SimHost:
    """One simulated producer: a real ``StepTelemetry`` (wire mode,
    deterministic boot, host-skewed clock) plus its uplink and the
    effects of currently-active incidents."""

    def __init__(self, index: int, hid: str, rack: int, clock: HostClock,
                 link: SimLink, rng: random.Random) -> None:
        self.index = index
        self.id = hid
        self.rack = rack
        self.clock = clock
        self.link = link
        self.rng = rng
        self.alive = True
        self.incarnation = 0
        self.step = 0
        self.telem: StepTelemetry | None = None
        # active incident effects, keyed by incident identity
        self.effects: dict[int, Incident] = {}

    def boot_stamp(self) -> int:
        return (self.index + 1) * 1_000_000 + self.incarnation


def _default_policy() -> PolicyEngine:
    """The closed-loop engine every scenario runs by default: recording
    actuator (actions land in the trace), guardrails tuned for per-second
    diagnosis cadence."""
    return PolicyEngine(
        actuator=RecordingActuator(),
        guardrails=GuardrailConfig(
            max_actions_per_window=8, rate_window=4, min_fleet=2,
            verify_steps=3, flap_limit=2, flap_window=64, flap_hold=16,
        ),
    )


# -- the engine ---------------------------------------------------------------

class ScenarioEngine:
    """Run one :class:`Scenario` to completion.

    Determinism contract: a fixed scenario (seed included) produces a
    byte-identical ``trace_lines`` and ``cause_lines`` on every run —
    the event heap breaks time ties with a monotone sequence number,
    every random draw comes from per-entity ``random.Random`` streams
    seeded from strings (PYTHONHASHSEED-independent), and every
    wall-clock seam in the real stack (telemetry clocks, aggregator
    leases, producer/aggregator ``boot`` stamps) is injected.  Journals
    are real files under ``workdir`` (a scratch tempdir by default).

    Every aggregator's analyzer runs its gates with ``backend`` on
    ``device`` (``None`` = the GPU, raising when there is none; ``"cpu"``
    only when asked).  With ``backend="torch"`` each diagnosis tick's
    fleet sweep is one gate-kernel launch; ``"numpy"`` is the oracle.
    Both give the same bytes.
    """

    def __init__(self, scenario: Scenario, workdir: str | None = None, *,
                 device=None, backend: str = "torch") -> None:
        self.sc = scenario
        self.device = resolve_device(device)
        self.backend = backend
        self.clock = SimClock(0.0)
        self._heap: list[tuple[float, int, object]] = []
        self._eseq = 0
        self.trace_lines: list[str] = []
        self.causes: list[tuple[float, RootCause]] = []
        self._workdir = workdir
        self._tmp: tempfile.TemporaryDirectory | None = None
        self.hosts: list[SimHost] = []
        self.leaves: list[AggNode] = []
        self.root = AggNode("root")
        self._agg_links: dict[str, SimLink] = {}
        self._pending_restarts = 0
        self.rows_sent = 0        # sends that actually hit a link
        self.rows_lost_crash = 0  # rows that legitimately died with a host
        # The workload stops at work_horizon (all hosts together, so the
        # end of the run is not itself a fleet-wide "outage" the leases
        # would page); transport settle and diagnosis may run on to the
        # hard horizon, but ticks stop as soon as the fleet quiesces.
        self._work_horizon = scenario.steps * scenario.period
        self._horizon = self._work_horizon + scenario.cooldown

    # -- event queue --
    @property
    def now(self) -> float:
        return self.clock.t

    def at(self, t: float, fn) -> None:
        self._eseq += 1
        heapq.heappush(self._heap, (t, self._eseq, fn))

    def trace(self, kind: str, detail: str = "") -> None:
        self.trace_lines.append(f"{self.now:012.6f} {kind} {detail}".rstrip())

    # -- construction --
    def _rng(self, *scope) -> random.Random:
        return random.Random("/".join([str(self.sc.seed), *map(str, scope)]))

    def _build(self) -> None:
        sc = self.sc
        if self._workdir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="scenario-")
            self._workdir = self._tmp.name
        policy = _default_policy() if sc.policy else None
        analyzer = self._analyzer()
        self.root.agg = FleetAggregator(
            JAX_FEATURES, analyzer, lease=sc.lease, clock=self.clock,
            policy=policy, reorder_window=sc.reorder_window,
        )
        if sc.topology == "tree":
            n_leaves = max(1, (sc.hosts + sc.fanout - 1) // sc.fanout)
            for k in range(n_leaves):
                node = AggNode(f"agg{k}")
                self._spawn_leaf_agg(node, k)
                self.leaves.append(node)
        elif sc.topology != "star":
            raise ValueError(f"unknown topology {sc.topology!r}")
        for i in range(sc.hosts):
            hid = sc.host_id(i)
            dst = (self.leaves[i // sc.fanout]
                   if sc.topology == "tree" else self.root)
            link = SimLink(self, f"{hid}->{dst.name}", sc.link,
                           self._rng("link", hid), dst)
            host = SimHost(i, hid, sc.rack_of(i), HostClock(self.clock),
                           link, self._rng("host", hid))
            self._spawn_telemetry(host)
            self.hosts.append(host)
        # Host steps start staggered inside the first period.
        for host in self.hosts:
            self.at(host.rng.uniform(0.0, 0.2), lambda h=host: self._host_step(h))
        # Leaf ticks land before the root tick at equal times (creation
        # order breaks the tie), so a leaf's forwards are in flight the
        # tick they were accepted.
        for node in self.leaves:
            self.at(sc.tick_period, lambda n=node: self._agg_tick(n))
        self.at(sc.tick_period, lambda: self._agg_tick(self.root))
        for n, inc in enumerate(sc.incidents):
            self.at(inc.at, lambda i=inc, k=n: self._incident_start(k, i))
            if inc.duration != float("inf"):
                self.at(inc.at + inc.duration,
                        lambda i=inc, k=n: self._incident_end(k, i))

    def _analyzer(self) -> BigRootsAnalyzer:
        return BigRootsAnalyzer(JAX_FEATURES, backend=self.backend,
                                device=self.device)

    def _spawn_telemetry(self, host: SimHost) -> None:
        host.telem = StepTelemetry(
            host.id, window=self.sc.window, clock=host.clock,
            schema=JAX_FEATURES, wire=True, boot=host.boot_stamp(),
        )

    def _spawn_leaf_agg(self, node: AggNode, k: int,
                        incarnation: int = 0) -> None:
        """(Re)build a leaf ``TreeAggregator``: same name + journal path
        across incarnations, fresh deterministic boot — exactly the
        restart contract of examples/fleet_demo.py's tree mode."""
        parent = SimLink(self, f"{node.name}->root", self.sc.link,
                         self._rng("agglink", k, incarnation), self.root)
        self._agg_links[node.name] = parent
        node.agg = TreeAggregator(
            JAX_FEATURES, self._analyzer(),
            name=node.name, parent=parent,
            journal=os.path.join(self._workdir, f"{node.name}.journal"),
            boot=900_000_000 + k * 1_000 + incarnation,
            lease=self.sc.lease, clock=self.clock,
            reorder_window=self.sc.reorder_window,
        )

    # -- host workload --
    def _active(self, host: SimHost, kind: str) -> Incident | None:
        for inc in host.effects.values():
            if inc.kind == kind:
                return inc
        return None

    def _host_step(self, host: SimHost) -> None:
        if not host.alive:
            return
        sc = self.sc
        if self.now >= self._work_horizon:
            return
        # Baseline workload (same shape as examples/fleet_demo.py): a
        # ~period-long step dominated by compute, with small per-host
        # deterministic jitter.
        data_load = 0.18 * sc.period + round(
            host.rng.uniform(0.0, sc.noise * sc.period), 4)
        compute = 0.78 * sc.period
        cpu = 0.18 + round(host.rng.uniform(0.0, sc.noise), 3)
        inc = self._active(host, "cpu_contend")
        if inc is not None:
            level = float(inc.params.get("level", 1.0))
            cpu = min(1.0, 0.95 * level)
            compute *= 1.0 + 1.2 * level
            data_load *= 1.0 + 2.0 * level
        inc = self._active(host, "disk_contend")
        if inc is not None:
            level = float(inc.params.get("level", 1.0))
            data_load *= 1.0 + 6.0 * level
        inc = self._active(host, "rack_degrade")
        if inc is not None:
            data_load *= float(inc.params.get("data_load_x", 4.0))
        skew_inc = self._active(host, "clock_skew")
        host.clock.skew = (float(skew_inc.params["skew"])
                           if skew_inc is not None else 0.0)
        host.clock.offset = 0.0
        with host.telem.step(host.step) as s:
            with s.phase("data_load"):
                host.clock.offset += data_load
            s.add("read_bytes", 64e6)
            s.add("cpu", round(cpu, 4))
            with s.phase("compute"):
                host.clock.offset += compute
        delta = host.telem.drain_delta()
        payload = delta.to_bytes()
        dur = data_load + compute
        end = self.now + dur
        self.trace(
            "host.step",
            f"{host.id} step={host.step} dur={dur:.4f} bytes={len(payload)}",
        )
        self.at(end, lambda: self._host_send(host, payload,
                                             delta.boot, delta.seq))
        host.step += 1
        self.at(end, lambda: self._host_step(host))

    def _host_send(self, host: SimHost, payload: bytes,
                   boot: int, seq: int) -> None:
        if not host.alive:
            return   # the delta died with the producer, uncounted
        self.rows_sent += 1
        host.link.send_bytes(payload, boot, seq)

    # -- aggregator ticks --
    def _agg_tick(self, node: AggNode) -> None:
        if self.now > self._horizon:
            return
        if node.alive:
            batch, node.inbox = node.inbox, []
            for link, epoch, key, payload in batch:
                try:
                    node.agg.ingest(payload)
                except WireFormatError:
                    node.wire_errors += 1
                link.ack(key, epoch)
            causes = node.agg.step()
            for cause in causes:
                self._record_cause(node, cause)
        if self._quiesced():
            # The workload ended and every payload is delivered, acked
            # and forwarded: stop diagnosing before the fleet-wide end
            # of work reads as a fleet-wide dropout.
            self.trace("agg.quiesce", node.name)
            return
        self.at(self.now + self.sc.tick_period, lambda: self._agg_tick(node))

    def _quiesced(self) -> bool:
        if self.now < self._work_horizon or self._pending_restarts:
            return False
        if any(h.link.unacked for h in self.hosts):
            return False
        if any(link.unacked for link in self._agg_links.values()):
            return False
        if any(n.inbox for n in [*self.leaves, self.root]):
            return False
        return not any(
            n.alive and n.agg.pending_forwards for n in self.leaves
        )

    def _record_cause(self, node: AggNode, cause: RootCause) -> None:
        where = "cause" if node is self.root else f"cause.{node.name}"
        self.trace(where, f"{cause.feature} task={cause.task_id} "
                          f"sev={cause.severity}")
        if node is self.root:
            self.causes.append((self.now, cause))

    # -- incidents --
    def _selected(self, inc: Incident) -> list[SimHost]:
        return [h for h in self.hosts
                if h.id in inc.hosts or h.rack in inc.racks]

    def _incident_start(self, key: int, inc: Incident) -> None:
        self.trace("incident.start",
                   f"{inc.kind} hosts={','.join(inc.hosts) or '-'} "
                   f"racks={','.join(map(str, inc.racks)) or '-'}")
        if inc.kind == "agg_restart":
            self._kill_agg(inc)
            return
        if inc.kind == "host_crash":
            for host in self._selected(inc):
                self._crash_host(host, inc)
            return
        for host in self._selected(inc):
            host.effects[key] = inc
            if inc.kind == "rack_degrade":
                host.link.profile = replace(
                    host.link.profile,
                    latency_s=host.link.profile.latency_s
                    * float(inc.params.get("latency_x", 10.0)),
                    bandwidth_bps=host.link.profile.bandwidth_bps
                    / float(inc.params.get("bandwidth_div", 10.0)),
                    loss=min(0.95, host.link.profile.loss
                             + float(inc.params.get("loss", 0.2))),
                )

    def _incident_end(self, key: int, inc: Incident) -> None:
        self.trace("incident.end", inc.kind)
        for host in self._selected(inc):
            host.effects.pop(key, None)
            if inc.kind == "rack_degrade":
                host.link.profile = self.sc.link

    def _crash_host(self, host: SimHost, inc: Incident) -> None:
        host.alive = False
        self.rows_lost_crash += host.link.orphans()
        host.link.reset()
        self.trace("host.crash", host.id)
        restart_after = inc.params.get("restart_after")
        if restart_after is not None:
            self._pending_restarts += 1
            self.at(self.now + float(restart_after),
                    lambda: self._restart_host(host))

    def _restart_host(self, host: SimHost) -> None:
        self._pending_restarts -= 1
        if host.alive or self.now > self._horizon:
            return
        host.alive = True
        host.incarnation += 1
        self._spawn_telemetry(host)  # fresh boot: restarted producer
        self.trace("host.restart", f"{host.id} boot={host.boot_stamp()}")
        self._host_step(host)

    def _kill_agg(self, inc: Incident) -> None:
        k = int(inc.params.get("agg", 0))
        node = self.leaves[k]
        node.alive = False
        node.inbox.clear()        # in-memory queue dies with the process
        node.agg.close()          # releases the journal file handle
        self._agg_links[node.name].reset()
        self.trace("agg.kill", node.name)
        restart_after = float(inc.params.get("restart_after", 5.0))
        self._pending_restarts += 1
        self.at(self.now + restart_after,
                lambda: self._restart_agg(node, k))

    def _restart_agg(self, node: AggNode, k: int) -> None:
        self._pending_restarts -= 1
        self._spawn_leaf_agg(node, k, incarnation=1 + node.agg.boot % 1_000)
        node.alive = True
        self.trace("agg.restart",
                   f"{node.name} recovered_payloads="
                   f"{node.agg.recovered_payloads} "
                   f"recovered_rows={node.agg.recovered_rows}")

    # -- run ----------------------------------------------------------------
    def run(self) -> "ScenarioResult":
        t0 = time.perf_counter()
        self._build()
        self.trace("scenario.start",
                   f"{self.sc.name} seed={self.sc.seed} hosts={self.sc.hosts} "
                   f"topology={self.sc.topology}")
        while self._heap:
            t, _, fn = heapq.heappop(self._heap)
            self.clock.t = max(self.clock.t, t)
            fn()
        # Final settle: apply any payload stranded by the horizon (an
        # undrained inbox, a reorder gap the stopped resends never
        # filled), and only then run one extra diagnosis pass — a clean
        # quiesce skips it, so the end of the run adds nothing.
        for node in [*self.leaves, self.root]:
            if node.alive:
                settled = 0
                batch, node.inbox = node.inbox, []
                for link, epoch, key, payload in batch:
                    try:
                        settled += 1 + node.agg.ingest(payload)
                    except WireFormatError:
                        node.wire_errors += 1
                settled += node.agg.flush_reorders()
                if settled:
                    self.trace("agg.settle", f"{node.name} n={settled}")
                    for cause in node.agg.step():
                        self._record_cause(node, cause)
        result = ScenarioResult(
            scenario=self.sc,
            causes=list(self.causes),
            trace_lines=list(self.trace_lines),
            counters=self._counters(),
            wall_seconds=time.perf_counter() - t0,
        )
        self.trace("scenario.end", f"causes={len(self.causes)}")
        result.trace_lines = list(self.trace_lines)
        for node in self.leaves:
            try:
                node.agg.close()
            except Exception:  # noqa: BLE001 - already closed by a kill
                pass
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None
        return result

    def _counters(self) -> dict:
        root = self.root.agg
        out = {
            # One row per completed host step.  The end-to-end
            # conservation invariant for EVERY scenario is
            #   rows_sent == rows_ingested + rows_lost_crash
            # (rows_produced additionally counts steps whose send never
            # happened because the producer died first).
            "rows_produced": sum(h.step for h in self.hosts),
            "rows_sent": self.rows_sent,
            "rows_lost_crash": self.rows_lost_crash,
            "rows_ingested": root.rows_ingested,
            "deltas_ingested": root.deltas_ingested,
            "duplicate_drops": root.duplicate_drops,
            "host_restarts": root.host_restarts,
            "host_dropouts": root.host_dropouts,
            "host_rejoins": root.host_rejoins,
            "reorder_holds": root.reorder_holds,
            "reorder_flushes": root.reorder_flushes,
            "forwarded_frames": root.forwarded_frames,
            "link_lost": sum(h.link.lost for h in self.hosts),
            "link_duplicated": sum(h.link.duplicated for h in self.hosts),
            "link_resends": sum(h.link.resends for h in self.hosts),
            "causes": len(self.causes),
        }
        if self.sc.policy and root.policy is not None:
            acts = getattr(root.policy.actuator, "applied", [])
            out["policy_actions"] = len(acts)
            out["policy_kinds"] = sorted({a.kind.value for a in acts})
        return out


# -- results + golden pinning -------------------------------------------------

@dataclass
class ScenarioResult:
    """What one run produced: the root's cause stream, the full event
    trace, and the counters that make a golden file reviewable."""

    scenario: Scenario
    causes: list[tuple[float, RootCause]]
    trace_lines: list[str]
    counters: dict
    wall_seconds: float

    @property
    def cause_lines(self) -> list[str]:
        """Canonical one-line-per-cause serialization: emission time,
        feature, scope (task/stage/node), severity, gate groups and the
        normalized value — the attribution-ordered stream the golden
        files pin byte-for-byte."""
        out = []
        for t, c in self.causes:
            out.append(json.dumps({
                "t": round(t, 6),
                "feature": c.feature,
                "task": c.task_id,
                "stage": c.stage_id,
                "node": c.node,
                "severity": c.severity,
                "groups": list(c.peer_groups),
                "value": f"{c.value:.6g}",
            }, sort_keys=True, separators=(",", ":")))
        return out

    @property
    def trace_digest(self) -> str:
        blob = "\n".join(self.trace_lines).encode()
        return hashlib.sha256(blob).hexdigest()

    def golden_bytes(self) -> bytes:
        """The byte-exact golden file body for this run."""
        head = [
            f"# scenario: {self.scenario.name}",
            f"# seed: {self.scenario.seed} hosts: {self.scenario.hosts} "
            f"steps: {self.scenario.steps} topology: {self.scenario.topology}",
            f"# trace_sha256: {self.trace_digest}",
            "# counters: " + json.dumps(
                self.counters, sort_keys=True, separators=(",", ":")),
        ]
        return ("\n".join(head + self.cause_lines) + "\n").encode()


def run_scenario(name_or_scenario, workdir: str | None = None, *,
                 device=None, backend: str = "torch",
                 **overrides) -> ScenarioResult:
    """Convenience: run a library scenario by name (or a
    :class:`Scenario`), optionally overriding script fields; ``device``
    and ``backend`` as for :class:`ScenarioEngine`."""
    sc = build_scenario(name_or_scenario, **overrides)
    return ScenarioEngine(sc, workdir=workdir, device=device,
                          backend=backend).run()


def build_scenario(name_or_scenario, **overrides) -> Scenario:
    if isinstance(name_or_scenario, Scenario):
        sc = name_or_scenario
    else:
        sc = SCENARIO_LIBRARY[str(name_or_scenario)]
    return replace(sc, **overrides) if overrides else sc


# -- scenario library ---------------------------------------------------------
# ~6 reusable correlated-incident scripts, each pinned by a golden cause
# stream in tests/golden/ (checked byte-for-byte by the CI scenarios
# lane).  The goldens are the JAX package's (it re-pins them); this
# package is held to the same bytes and never rewrites them.

SCENARIO_LIBRARY: dict[str, Scenario] = {
    # The classic single-straggler signal: one host saturates CPU for a
    # stretch; speculate/cordon policy closes the loop.
    "hot_host_cpu": Scenario(
        name="hot_host_cpu", seed=11, hosts=16, racks=4, steps=32,
        incidents=(
            Incident("cpu_contend", at=6.0, duration=14.0, hosts=("h0003",)),
        ),
    ),
    # Rack-level network degradation: every host in rack 1 sees a lossy,
    # slow uplink and a starved input pipeline — correlated data_load
    # stragglers plus transport resends the dedup must absorb.
    "rack_degrade": Scenario(
        name="rack_degrade", seed=23, hosts=24, racks=4, steps=32,
        lease=5.0,
        incidents=(
            Incident("rack_degrade", at=8.0, duration=12.0, racks=(1,),
                     params={"loss": 0.25, "latency_x": 20.0,
                             "bandwidth_div": 50.0, "data_load_x": 5.0}),
        ),
    ),
    # Cascading dropouts: one host dies mid-incident (severity-2
    # escalation), two more follow; one returns under a fresh boot.
    "cascade_dropouts": Scenario(
        name="cascade_dropouts", seed=37, hosts=16, racks=4, steps=40,
        incidents=(
            Incident("cpu_contend", at=5.0, duration=8.0, hosts=("h0005",)),
            Incident("host_crash", at=10.0, hosts=("h0005",)),
            Incident("host_crash", at=13.0, hosts=("h0006",)),
            Incident("host_crash", at=16.0, hosts=("h0007",),
                     params={"restart_after": 10.0}),
        ),
    ),
    # Tree fan-in: SIGKILL a leaf aggregator mid-run; its journal
    # restart plus the children's thundering-herd replay must conserve
    # every row at the root.
    "herd_reconnect": Scenario(
        name="herd_reconnect", seed=41, hosts=16, racks=2, steps=32,
        topology="tree", fanout=8, lease=6.0,
        incidents=(
            Incident("agg_restart", at=10.0,
                     params={"agg": 0, "restart_after": 6.0}),
        ),
    ),
    # Clock skew: one host's stamps run 30s ahead mid-run while another
    # host carries a real disk incident — skew must not confuse the
    # diagnosis or the dedup.
    "clock_skew": Scenario(
        name="clock_skew", seed=53, hosts=12, racks=3, steps=32,
        incidents=(
            Incident("clock_skew", at=8.0, duration=12.0, hosts=("h0002",),
                     params={"skew": 30.0}),
            Incident("disk_contend", at=10.0, duration=10.0,
                     hosts=("h0009",)),
        ),
    ),
    # Fleet-wide lossy fabric: loss + duplication + jitter-reordering on
    # every link, absorbed by resends and the aggregator's reorder
    # window — rows conserve and one real incident still diagnoses.
    "lossy_fabric": Scenario(
        name="lossy_fabric", seed=67, hosts=16, racks=4, steps=32,
        lease=6.0, reorder_window=6,
        link=LinkProfile(loss=0.15, dup=0.10, jitter_s=0.4, rto_s=2.0,
                         ordered=False),
        incidents=(
            Incident("cpu_contend", at=9.0, duration=10.0, hosts=("h0011",)),
        ),
    ),
}


# -- labeled episodes (training data for repro_torch.core.forecast) ----------
#
# A scenario run is a *labeled* incident: the engine knows which rows the
# Eq. 5 gates later confirmed as stragglers (the root's cause stream).
# The exporter turns one run into supervised sequences — per host, every
# trailing window of `length` gate-space rows, stamped with whether that
# host gets a gate-confirmed straggler within the next `horizon` steps.
# Same determinism contract as the cause goldens: a fixed scenario yields
# byte-identical tensors + labels, pinned in tests/golden/ via --episodes.

_TASK_STEP_RE = re.compile(r"^(.+)/step(\d+)$")


@dataclass
class EpisodeSet:
    """One scenario run as supervised forecasting sequences.

    ``x[s]`` holds host ``hosts[s]``'s gate-space rows for the ``length``
    steps ending at ``anchors[s]`` (newest last — the same per-node
    trailing-window view :func:`repro_torch.core.fleet.pack_sequences` packs at
    inference time); ``y[s]`` is 1 iff the Eq. 5 gates confirmed that
    host as a straggler within ``(anchor, anchor + horizon]``.
    """

    name: str
    seed: int
    length: int
    horizon: int
    x: np.ndarray                       # [S, L, F] float64, full windows only
    y: np.ndarray                       # [S] int8 labels
    hosts: list[str]                    # [S] host per sequence
    anchors: list[int]                  # [S] anchor (newest) step per sequence
    stage_ids: list[str]                # [S] stage of the anchor row
    confirmed: tuple                    # sorted (host, step) gate verdicts
    rows: int                           # trace rows consumed (all hosts)
    row_steps: set                      # every (host, step) trace row seen
    counters: dict                      # the run's ScenarioResult counters
    wall_seconds: float

    @property
    def positives(self) -> int:
        return int(self.y.sum())

    def golden_bytes(self) -> bytes:
        """Byte-exact golden body: tensor digests + every positive label."""
        head = [
            f"# episodes: {self.name}",
            f"# seed: {self.seed} length: {self.length} "
            f"horizon: {self.horizon}",
            f"# rows: {self.rows} sequences: {len(self.y)} "
            f"positives: {self.positives} confirmed: {len(self.confirmed)}",
            f"# x_sha256: {hashlib.sha256(self.x.tobytes()).hexdigest()} "
            f"shape: {'x'.join(map(str, self.x.shape))}",
            f"# y_sha256: {hashlib.sha256(self.y.tobytes()).hexdigest()}",
        ]
        lines = sorted(
            json.dumps(
                {"host": h, "anchor": a, "stage": st},
                sort_keys=True, separators=(",", ":"),
            )
            for h, a, st, yy in zip(
                self.hosts, self.anchors, self.stage_ids, self.y
            )
            if yy
        )
        return ("\n".join(head + lines) + "\n").encode()


def export_episodes(
    name_or_scenario,
    length: int = 8,
    horizon: int = 3,
    workdir: str | None = None,
    *,
    device=None,
    backend: str = "torch",
    **overrides,
) -> EpisodeSet:
    """Run a scenario and export its labeled forecasting episodes.

    Rows come straight from each simulated host's in-memory ``TraceStore``
    (every completed step lands there regardless of transport fate), put
    into gate space exactly as :class:`~repro_torch.core.window.SlidingStageWindow`
    would (TIME columns / max(duration, 1e-12), row-local); labels come
    from the root's confirmed cause stream — only causes whose feature is
    a schema column (i.e. Eq. 5 gate output, never synthesized causes
    like ``host_dropout``).  A window anchored at step ``a`` is labeled
    ``y=1`` iff its node is gate-confirmed at some step ``s`` with
    ``a < s <= a + horizon`` — the *future* verdict, which is what makes
    the episodes forecasting data rather than detection data.  Only full
    ``length``-step windows are emitted, so every ``x`` row maps 1:1
    onto a trace row.

    Exports are byte-reproducible for a fixed scenario and seed
    (``EpisodeSet.golden_bytes`` is golden-pinned in CI, same ``--check``
    workflow as the cause-stream goldens).  ``device`` and
    ``backend`` as for :class:`ScenarioEngine`.
    """
    t0 = time.perf_counter()
    sc = build_scenario(name_or_scenario, **overrides)
    eng = ScenarioEngine(sc, workdir=workdir, device=device,
                         backend=backend)
    result = eng.run()
    schema = JAX_FEATURES
    tcols = schema.cols_of_kind(FeatureKind.TIME)

    confirmed: set[tuple[str, int]] = set()
    for _t, c in result.causes:
        if c.feature not in schema:
            continue
        m = _TASK_STEP_RE.match(c.task_id)
        if m:
            confirmed.add((m.group(1), int(m.group(2))))

    xs, ys, hosts, anchors, stage_ids = [], [], [], [], []
    rows_total = 0
    row_steps: set[tuple[str, int]] = set()
    for host in eng.hosts:
        rows: list[tuple[int, str, np.ndarray]] = []
        for frame in host.telem.trace.stages():
            v = frame.raw.copy()
            if tcols.size:
                v[:, tcols] /= np.maximum(frame.durations, 1e-12)[:, None]
            for i, tid in enumerate(frame.task_ids):
                step = int(_TASK_STEP_RE.match(tid).group(2))
                rows.append((step, frame.stage_id, v[i]))
                row_steps.add((host.id, step))
        rows.sort(key=lambda r: r[0])
        rows_total += len(rows)
        for k in range(length - 1, len(rows)):
            anchor, stage_id, _ = rows[k]
            xs.append(np.stack([r[2] for r in rows[k - length + 1 : k + 1]]))
            ys.append(
                1 if any(
                    (host.id, s) in confirmed
                    for s in range(anchor + 1, anchor + horizon + 1)
                ) else 0
            )
            hosts.append(host.id)
            anchors.append(anchor)
            stage_ids.append(stage_id)

    F = len(schema)
    x = (np.stack(xs) if xs
         else np.zeros((0, length, F), dtype=np.float64))
    return EpisodeSet(
        name=sc.name, seed=sc.seed, length=length, horizon=horizon,
        x=x, y=np.asarray(ys, dtype=np.int8),
        hosts=hosts, anchors=anchors, stage_ids=stage_ids,
        confirmed=tuple(sorted(confirmed)),
        rows=rows_total, row_steps=row_steps,
        counters=result.counters,
        wall_seconds=time.perf_counter() - t0,
    )


# Scenarios whose episode exports are golden-pinned in tests/golden/
# (the --episodes lane default: one classic straggler, one with crashes).
EPISODE_PINS = ("hot_host_cpu", "cascade_dropouts")


# -- CI runner ----------------------------------------------------------------

def _golden_path(golden_dir: str, name: str) -> str:
    return os.path.join(golden_dir, f"scenario_{name}.golden")


def _episode_golden_path(golden_dir: str, name: str) -> str:
    return os.path.join(golden_dir, f"episodes_{name}.golden")


def main(argv: list[str] | None = None) -> int:
    """Headless scenario runner — the CI ``scenarios`` lane entrypoint.

    ``--check`` compares each scenario's golden bytes against the pinned
    file (byte-for-byte) under a per-scenario wall-time ``--budget``;
    on any failure the full event trace is written under ``--trace-dir``
    for replay-debugging and the exit code is non-zero.  The pinned files
    are the JAX package's goldens, which this runner only reads.
    """
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.anomaly.scenario", description=main.__doc__
    )
    ap.add_argument("names", nargs="*", default=[],
                    help="scenario names (default: all library scenarios)")
    ap.add_argument("--list", action="store_true",
                    help="list library scenarios and exit")
    ap.add_argument("--check", action="store_true",
                    help="compare against pinned goldens byte-for-byte")
    ap.add_argument("--episodes", action="store_true",
                    help="run the labeled-episode exporter instead of the "
                         "cause-stream lane (goldens: episodes_<name>.golden; "
                         "default names: the EPISODE_PINS subset)")
    ap.add_argument("--golden-dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))), "tests", "golden"),
        help="directory of pinned scenario_<name>.golden files")
    ap.add_argument("--trace-dir", default=None,
                    help="where failing scenarios dump their event trace "
                         "(default: <golden-dir>/../..../scenario-traces)")
    ap.add_argument("--budget", type=float, default=120.0,
                    help="per-scenario wall-time budget in seconds")
    ap.add_argument("--device", default=None,
                    help="where the diagnosis runs (default: the GPU, and "
                         "an error without one; 'cpu' runs the gate "
                         "kernel's plain version on the host)")
    args = ap.parse_args(argv)

    if args.list:
        for name, sc in SCENARIO_LIBRARY.items():
            print(f"{name}: hosts={sc.hosts} steps={sc.steps} "
                  f"topology={sc.topology} incidents={len(sc.incidents)}")
        return 0

    device = resolve_device(args.device)
    if args.episodes:
        names = args.names or list(EPISODE_PINS)
        failures = 0
        for name in names:
            es = export_episodes(name, device=device)
            got = es.golden_bytes()
            status = "ran"
            if es.wall_seconds > args.budget:
                status = f"OVER-BUDGET ({es.wall_seconds:.1f}s "\
                         f"> {args.budget:.0f}s)"
                failures += 1
            if args.check:
                try:
                    with open(_episode_golden_path(args.golden_dir, name),
                              "rb") as f:
                        want = f.read()
                except FileNotFoundError:
                    want = None
                if want is None:
                    status = "MISSING-GOLDEN"
                    failures += 1
                elif got != want:
                    status = "MISMATCH"
                    failures += 1
                else:
                    status = "OK"
            print(f"EPISODES,{name},{status},sequences={len(es.y)},"
                  f"positives={es.positives},wall={es.wall_seconds:.2f}s")
        return 1 if failures else 0

    names = args.names or list(SCENARIO_LIBRARY)
    trace_dir = args.trace_dir or os.path.join(
        os.getcwd(), "scenario-traces")
    failures = 0
    for name in names:
        result = run_scenario(name, device=device)
        got = result.golden_bytes()
        status = "ran"
        if result.wall_seconds > args.budget:
            status = f"OVER-BUDGET ({result.wall_seconds:.1f}s "\
                     f"> {args.budget:.0f}s)"
            failures += 1
        if args.check:
            try:
                with open(_golden_path(args.golden_dir, name), "rb") as f:
                    want = f.read()
            except FileNotFoundError:
                want = None
            if want is None:
                status = "MISSING-GOLDEN"
                failures += 1
            elif got != want:
                status = "MISMATCH"
                failures += 1
            if status in ("MISSING-GOLDEN", "MISMATCH"):
                os.makedirs(trace_dir, exist_ok=True)
                trace_path = os.path.join(trace_dir, f"{name}.trace")
                with open(trace_path, "w") as f:
                    f.write("\n".join(result.trace_lines) + "\n")
                with open(os.path.join(trace_dir, f"{name}.golden.got"),
                          "wb") as f:
                    f.write(got)
                status += f" (trace: {trace_path})"
            elif status == "ran":
                status = "OK"
        print(f"SCENARIO,{name},{status},causes={len(result.causes)},"
              f"wall={result.wall_seconds:.2f}s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
