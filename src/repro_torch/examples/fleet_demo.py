"""Cross-process fleet diagnosis demo: N real host processes, one socket.

This is the proof behind ``repro_torch.telemetry.transport``: per-host telemetry
actually crosses a process boundary (localhost TCP, Unix socket, or the
shared-memory ring), the launcher-side
:class:`~repro_torch.serve.FleetAggregator` merges it live, and the result is
*exactly* what in-process ingestion of the same bytes would have produced
— plus host-dropout escalation when a process is killed mid-run.

What it does:

1. spawns ``--hosts`` child processes; each runs a
   ``StepTelemetry(wire=True)`` loop over a deterministic synthetic
   workload (one host doubles as a periodic straggler with high CPU and
   slow data loads) and ships a ``StepDelta`` per step through
   ``DeltaClient.send`` (or a ``ShmRing``);
2. the parent drains the server into a ``FleetAggregator`` with a
   wall-clock host lease, runs the fleet diagnosis tick, and *records
   every event* (each payload's bytes, each diagnosis tick);
3. once the straggler host has delivered ``--kill-after`` deltas it is
   SIGKILLed mid-run; the parent keeps ticking until the lease expires
   and the synthesized ``host_dropout`` escalation fires (severity 2:
   the host went dark while its nodes carried confirmed causes);
4. the recorded event sequence is replayed into a fresh in-process
   aggregator, and the two RootCause streams (dropout findings aside —
   the replay has no wall clock) must be **byte-identical**, field for
   field.  Any transport-introduced loss, reorder, duplication, or
   corruption would break the equality; the ``(boot, seq)`` dedup is
   what makes the at-least-once channel safe to compare at all.

**Tree mode** (``--aggs N``): hosts connect to N intermediate
:class:`~repro_torch.serve.fleet.TreeAggregator` processes (Unix sockets)
instead of the root; each aggregator merges its sub-fleet, journals every
accepted payload, and forwards re-stamped ``BRDF`` envelopes upstream.
Mid-run the aggregator owning the straggler host is SIGKILLed and
restarted against the same journal — it must resume watermarks and
re-forward its unacked tail, so the root still sees **exactly**
``hosts × steps`` rows (zero lost, zero duplicated; redelivery surfaces
only as inner ``duplicate_drops``) and a cause stream byte-identical to
in-process replay of the received envelopes.  Both the kill and the
restart trigger on *acked-delta progress* observed at the root (never a
wall-clock delay), so the interleaving is the same on an idle laptop and
a loaded CI runner.

Run it::

    PYTHONPATH=src python -m repro_torch.examples.fleet_demo                # 3 hosts, TCP
    PYTHONPATH=src python -m repro_torch.examples.fleet_demo --hosts 2 --steps 24 \\
        --kill-after 8 --lease 1.0                              # CI shape
    PYTHONPATH=src python -m repro_torch.examples.fleet_demo --transport unix
    PYTHONPATH=src python -m repro_torch.examples.fleet_demo --transport shm
    PYTHONPATH=src python -m repro_torch.examples.fleet_demo --hosts 4 --aggs 2 \\
        --steps 24 --agg-kill-after 8                 # depth-2 tree + failover

Both modes additionally run an in-process attribution hop check: a wire
v3 (``BRD3``) payload carrying a priced RootCause is pushed through a
:class:`TreeAggregator`, and the forwarded envelope must embed the
original bytes verbatim with the root re-emitting the cause's
``Attribution`` intact.

Exits non-zero if the cause streams differ, the attributed payload does
not survive the tree hop byte-identically, no dropout escalation
surfaced (star mode), or rows were lost or duplicated through the
aggregator failover (tree mode); prints ``OK`` last otherwise.  The
diagnosing processes (the parent and, in tree mode, the aggregators) run
the fleet sweep on ``--device`` (default: the GPU; ``cpu`` runs the gate
kernel's plain version on the host); the host processes only send.  See ``docs/operations.md`` for the
production version of this topology and ``docs/wire_format.md`` for what
the bytes look like.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from ..core import BigRootsAnalyzer, JAX_FEATURES
from ..device import resolve_device
from ..serve.fleet import (
    DROPOUT_FEATURE,
    FleetAggregator,
    TreeAggregator,
)
from ..telemetry.events import StepTelemetry
from ..telemetry.transport import (
    DeltaClient,
    DeltaServer,
    RingSender,
    ShmRing,
)

STRAGGLER_HOST_INDEX = 1  # also the kill target (dies mid-incident)
MODULE = "repro_torch.examples.fleet_demo"


def child_command(*args: str) -> list[str]:
    """This module as a child process, with the package's ``src`` on its
    path."""
    return [sys.executable, "-m", MODULE, *args]


def child_env() -> dict:
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    return {**os.environ,
            "PYTHONPATH": src + (os.pathsep + path if path else "")}


class SimClock:
    """Deterministic per-host clock: ``advance`` inside phases decides the
    synthetic step timings."""

    def __init__(self, start: float = 1000.0) -> None:
        self.t = start

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def host_steps(host_index: int, steps: int, window: int = 8):
    """The synthetic workload, identical across runs: mostly uniform
    ~1s steps; the straggler host's first two steps of every window run
    ~2.6x long with saturated CPU and a slow data load."""
    rng = np.random.default_rng(1000 + host_index)
    for step in range(steps):
        slow = host_index == STRAGGLER_HOST_INDEX and step % window < 2
        data_load = 1.5 if slow else 0.18 + round(float(rng.uniform(0, 0.04)), 3)
        compute = 1.1 if slow else 0.8
        cpu = 0.95 if slow else 0.18 + round(float(rng.uniform(0, 0.04)), 2)
        yield step, data_load, compute, cpu


def run_host(args) -> int:
    """Child-process body: emit telemetry, ship a delta per step."""
    if args.transport == "shm":
        sink = RingSender(ShmRing.attach(args.connect))
    else:
        sink = DeltaClient(args.connect)
    clock = SimClock()
    telem = StepTelemetry(f"h{args.host_index}", window=8, clock=clock,
                          wire=True)
    for step, data_load, compute, cpu in host_steps(args.host_index,
                                                    args.steps):
        with telem.step(step) as s:
            with s.phase("data_load"):
                clock.advance(data_load)
            s.add("read_bytes", 64e6)
            s.add("cpu", cpu)
            with s.phase("compute"):
                clock.advance(compute)
        delta = telem.drain_delta()
        if args.transport == "shm":
            # A ring-full send *sheds*; re-send the same delta until the
            # draining parent makes room (the (boot, seq) watermark makes
            # an accepted-then-retried duplicate harmless).
            while not sink.send(delta):
                time.sleep(0.05)
        else:
            sink.send(delta)  # False = buffered; the resend path owns it
        time.sleep(args.pace)
    ok = sink.flush(timeout=15.0)
    sink.close()
    return 0 if ok else 3


def run_agg(args) -> int:
    """Intermediate-aggregator process body: serve a sub-fleet with
    deferred (durable) acks, journal every accepted payload, forward
    re-stamped envelopes to the root.  Runs until killed — SIGKILL
    mid-run is the point; the respawn reuses the same ``--listen``
    socket path and ``--journal`` file and must resume where the dead
    incarnation's journal left off."""
    sock_path = args.listen[len("unix:"):]
    try:
        os.unlink(sock_path)  # a SIGKILLed incarnation leaves this behind
    except OSError:
        pass
    agg = TreeAggregator(
        JAX_FEATURES, BigRootsAnalyzer(JAX_FEATURES, device=args.device),
        name=f"agg{args.host_index}", parent=args.connect,
        journal=args.journal, forward_batch=8,
    )
    if agg.recovered_payloads:
        print(f"[agg{args.host_index}] resumed from journal: "
              f"{agg.recovered_payloads} payloads "
              f"({agg.recovered_rows} rows), "
              f"{agg.pending_forwards} re-queued for forward", flush=True)
    server = DeltaServer(args.listen, ack="drain")
    while True:  # no graceful shutdown on purpose: the parent SIGKILLs us
        server.drain_into(agg)
        agg.pump()
        time.sleep(args.pace)


def agg_of(host_index: int, aggs: int, hosts: int) -> int:
    """Contiguous host→aggregator assignment; keeps the straggler (h1)
    on agg0 for the default shapes."""
    return host_index * aggs // hosts


def fresh_aggregator(lease: float | None, device) -> FleetAggregator:
    return FleetAggregator(
        JAX_FEATURES, BigRootsAnalyzer(JAX_FEATURES, device=device),
        lease=lease,
    )


def replay(events: list, device) -> list:
    """In-process union ingest of exactly the payload bytes the parent
    received, with the identical ingest/step interleaving."""
    agg = fresh_aggregator(lease=None, device=device)
    causes = []
    for kind, payload in events:
        if kind == "ingest":
            agg.ingest(payload)
        else:
            causes.extend(agg.step())
    return causes


def cause_fields(cause) -> tuple:
    return (cause.task_id, cause.stage_id, cause.node, cause.feature,
            cause.kind, cause.value, cause.peer_groups, cause.guidance,
            cause.severity, cause.attribution)


def attribution_hop_check(device) -> bool:
    """Prove an *attributed* (wire v3) payload survives the tree hop
    byte-identically: a StepDelta carrying a priced RootCause is pushed
    through an in-process TreeAggregator, the forwarded ``BRDF``
    envelope must embed the original ``BRD3`` bytes verbatim, and the
    root must re-emit the cause with its Attribution intact."""
    from ..core import Attribution, FeatureKind, RootCause
    from ..core.analyzer import cause_from_wire, cause_to_wire
    from ..telemetry.events import ForwardedDelta, StageDelta, StepDelta

    class Pipe:
        def __init__(self) -> None:
            self.sent: list[bytes] = []

        def send_bytes(self, payload: bytes, boot: int, seq: int) -> bool:
            self.sent.append(payload)
            return True

    attr = Attribution(estimated_recovery_s=2.5, throughput_delta=0.25,
                       cumulative_recovery_s=2.5, tasks_rebased=1,
                       baseline_s=10.0)
    cause = RootCause(task_id="h0/s0", stage_id="s0", node="h0",
                      feature="cpu", kind=FeatureKind.RESOURCE, value=2.0,
                      peer_groups=("inter",), severity=1, attribution=attr)
    n = 4
    raw = StepDelta("h0", 1, [StageDelta(
        "s0", [f"t{i}" for i in range(n)], ["h0"] * n,
        np.zeros(n), np.ones(n), np.zeros(n, np.int16),
        {"cpu": np.full(n, 0.2)}, {"cpu": np.ones(n, bool)},
    )], boot=1, causes=[cause_to_wire(cause)]).to_bytes()

    pipe = Pipe()
    mid = TreeAggregator(JAX_FEATURES, name="hopcheck", parent=pipe,
                         device=device)
    mid.ingest(raw)
    mid.pump()
    verbatim = (len(pipe.sent) == 1
                and ForwardedDelta.from_bytes(pipe.sent[0]).payloads == [raw])
    root = fresh_aggregator(lease=None, device=device)
    root.ingest(pipe.sent[0])
    out = [c for c in root.step() if c.attribution is not None]
    survived = (verbatim and len(out) == 1
                and out[0] == cause_from_wire(cause_to_wire(cause)))
    print(f"[fleet_demo] attributed BRD3 payload through tree hop: "
          f"verbatim={verbatim} attribution_intact={survived}")
    return survived


def run_parent(args) -> int:
    rings: dict[str, ShmRing] = {}
    server = None
    if args.transport == "shm":
        for i in range(args.hosts):
            rings[f"h{i}"] = ShmRing.create(capacity=1 << 20)
        connect_for = {f"h{i}": rings[f"h{i}"].name for i in range(args.hosts)}
    else:
        if args.transport == "unix":
            path = os.path.join(tempfile.mkdtemp(prefix="fleet_demo_"),
                                "agg.sock")
            server = DeltaServer("unix:" + path)
            addr = "unix:" + path
        else:
            server = DeltaServer(("127.0.0.1", 0))
            addr = f"{server.address[0]}:{server.address[1]}"
        connect_for = {f"h{i}": addr for i in range(args.hosts)}

    procs = {}
    for i in range(args.hosts):
        procs[f"h{i}"] = subprocess.Popen(
            child_command("--child",
                          "--host-index", str(i), "--steps", str(args.steps),
                          "--transport", args.transport,
                          "--connect", connect_for[f"h{i}"],
                          "--pace", str(args.pace)),
            env=child_env(),
        )
    kill_target = (f"h{STRAGGLER_HOST_INDEX}"
                   if args.hosts > 1 and args.kill_after > 0 else None)

    agg = fresh_aggregator(lease=args.lease, device=args.device)
    events: list[tuple[str, bytes | None]] = []
    live_causes = []
    dropout_causes = []
    per_host_payloads: dict[str, int] = {}
    killed_at = None
    deadline = time.time() + args.timeout

    def drain() -> int:
        """Pull payload bytes off the transport, log + ingest each."""
        if args.transport == "shm":
            payloads = []
            for ring in rings.values():
                while True:
                    p = ring.pop()
                    if p is None:
                        break
                    payloads.append(p)
        else:
            payloads = server.drain()
        for p in payloads:
            events.append(("ingest", p))
            agg.ingest(p)
        return len(payloads)

    def tick() -> None:
        events.append(("step", None))
        for cause in agg.step():
            if cause.feature == DROPOUT_FEATURE:
                dropout_causes.append(cause)
                print(f"[fleet] DROPOUT sev={cause.severity}: {cause.guidance}")
            else:
                live_causes.append(cause)
                print(f"[fleet] cause: {cause.task_id} <- {cause.feature} "
                      f"(F={cause.value:.3g}, sev={cause.severity})")

    while time.time() < deadline:
        n = drain()
        if n:
            for host, boots in agg.host_seq.items():
                per_host_payloads[host] = max(boots.values(), default=0)
        tick()
        if (kill_target and killed_at is None
                and per_host_payloads.get(kill_target, 0) >= args.kill_after):
            print(f"[fleet] SIGKILL {kill_target} after "
                  f"{per_host_payloads[kill_target]} deltas")
            procs[kill_target].kill()
            killed_at = time.time()
        others_done = all(
            p.poll() is not None for h, p in procs.items() if h != kill_target
        )
        if others_done and (kill_target is None or dropout_causes):
            drain()
            tick()
            if (args.transport == "shm"
                    or server.pending == 0):
                break
        time.sleep(args.pace)

    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.wait()
    if server is not None:
        server.close()
    for ring in rings.values():
        ring.close()

    # -- the proof ---------------------------------------------------------
    replayed = replay(events, args.device)
    got = [cause_fields(c) for c in live_causes]
    want = [cause_fields(c) for c in replayed]
    identical = got == want
    print(f"\n[fleet_demo] hosts={args.hosts} transport={args.transport} "
          f"payloads={sum(1 for k, _ in events if k == 'ingest')} "
          f"rows={agg.rows_ingested} dup_drops={agg.duplicate_drops}")
    print(f"[fleet_demo] causes over socket: {len(live_causes)}  "
          f"in-process replay: {len(replayed)}  byte-identical: {identical}")
    if kill_target:
        print(f"[fleet_demo] dropout escalations: {len(dropout_causes)} "
              f"(severities {[c.severity for c in dropout_causes]})")
    ok = (identical and bool(live_causes)
          and attribution_hop_check(args.device))
    if kill_target:
        ok = ok and bool(dropout_causes)
    if not ok:
        if not identical:
            for g, w in zip(got, want):
                if g != w:
                    print("  first divergence:\n   socket:", g,
                          "\n   replay:", w)
                    break
            if len(got) != len(want):
                print(f"  length mismatch: {len(got)} vs {len(want)}")
        print("[fleet_demo] FAILED")
        return 1
    print("[fleet_demo] OK — transport-delivered causes are byte-identical "
          "to in-process union ingest"
          + (", dropout escalated" if kill_target else ""))
    return 0


def run_tree_parent(args) -> int:
    """Depth-2 topology: root ← ``--aggs`` aggregator processes ← hosts,
    with a SIGKILL + journal-restart of the straggler's aggregator."""
    workdir = tempfile.mkdtemp(prefix="fleet_tree_")
    root_addr = "unix:" + os.path.join(workdir, "root.sock")
    root = DeltaServer(root_addr)

    def agg_cmd(j: int) -> list[str]:
        return child_command(
            "--agg-child", "--host-index", str(j),
            "--listen", "unix:" + os.path.join(workdir, f"agg{j}.sock"),
            "--journal", os.path.join(workdir, f"agg{j}.journal"),
            "--connect", root_addr, "--pace", str(args.pace),
            "--device", str(args.device))

    agg_procs = {j: subprocess.Popen(agg_cmd(j), env=child_env())
                 for j in range(args.aggs)}
    deadline = time.time() + args.timeout
    while (any(not os.path.exists(os.path.join(workdir, f"agg{j}.sock"))
               for j in range(args.aggs)) and time.time() < deadline):
        time.sleep(0.05)

    host_procs = {}
    for i in range(args.hosts):
        j = agg_of(i, args.aggs, args.hosts)
        host_procs[f"h{i}"] = subprocess.Popen(
            child_command(
                "--child", "--host-index", str(i), "--steps", str(args.steps),
                "--transport", "unix",
                "--connect", "unix:" + os.path.join(workdir, f"agg{j}.sock"),
                "--pace", str(args.pace)),
            env=child_env(),
        )

    kill_agg = agg_of(STRAGGLER_HOST_INDEX, args.aggs, args.hosts)
    straggler = f"h{STRAGGLER_HOST_INDEX}"
    expected_rows = args.hosts * args.steps
    agg = fresh_aggregator(lease=args.lease, device=args.device)
    events: list[tuple[str, bytes | None]] = []
    live_causes = []
    killed = False
    restarted = False
    progress_base = 0

    def survivor_progress() -> int:
        """Acked-delta progress the root has seen from hosts on the
        *surviving* aggregators — the load-independent clock that decides
        when the killed aggregator respawns.  Wall-clock delays here are
        exactly what flakes under a loaded CI box: the surviving
        sub-fleet may have shipped 2 deltas or 20 in the same 0.3s."""
        total = 0
        for i in range(args.hosts):
            if agg_of(i, args.aggs, args.hosts) != kill_agg:
                total += max(agg.host_seq.get(f"h{i}", {}).values(),
                             default=0)
        return total

    def drain() -> None:
        for p in root.drain():
            events.append(("ingest", p))
            agg.ingest(p)

    def tick() -> None:
        events.append(("step", None))
        for cause in agg.step():
            if cause.feature != DROPOUT_FEATURE:
                live_causes.append(cause)

    while time.time() < deadline:
        drain()
        tick()
        seen = max(agg.host_seq.get(straggler, {}).values(), default=0)
        if (args.agg_kill_after > 0 and not killed
                and seen >= args.agg_kill_after):
            print(f"[tree] SIGKILL agg{kill_agg} after the root saw "
                  f"{seen} deltas from {straggler}")
            agg_procs[kill_agg].kill()
            agg_procs[kill_agg].wait()
            killed = True
            progress_base = survivor_progress()
        survivors_exist = any(
            agg_of(i, args.aggs, args.hosts) != kill_agg
            for i in range(args.hosts)
        )
        if (killed and not restarted
                and (not survivors_exist  # nothing can progress: respawn now
                     or survivor_progress() - progress_base
                     >= args.agg_restart_after)):
            print(f"[tree] restarting agg{kill_agg} from its journal "
                  f"(survivors advanced "
                  f"{survivor_progress() - progress_base} deltas)")
            agg_procs[kill_agg] = subprocess.Popen(agg_cmd(kill_agg),
                                                   env=child_env())
            restarted = True
        hosts_done = all(p.poll() is not None for p in host_procs.values())
        if hosts_done and agg.rows_ingested >= expected_rows:
            drain()
            tick()
            break
        time.sleep(args.pace)

    timed_out = {h for h, p in host_procs.items() if p.poll() is None}
    for p in list(host_procs.values()) + list(agg_procs.values()):
        if p.poll() is None:
            p.kill()
        p.wait()
    root.close()

    # -- the proof ---------------------------------------------------------
    # Same replay oracle as the star run — the recorded bytes are BRDF
    # envelopes here, but ingest is topology-agnostic — plus strict row
    # conservation through the failover.
    replayed = replay(events, args.device)
    got = [cause_fields(c) for c in live_causes]
    want = [cause_fields(c) for c in replayed]
    identical = got == want
    conserved = agg.rows_ingested == expected_rows
    hosts_ok = not timed_out and all(
        p.returncode == 0 for p in host_procs.values())
    print(f"\n[fleet_demo] hosts={args.hosts} aggs={args.aggs} "
          f"envelopes={sum(1 for k, _ in events if k == 'ingest')} "
          f"rows={agg.rows_ingested}/{expected_rows} "
          f"dup_drops={agg.duplicate_drops} "
          f"agg_restarts={agg.host_restarts}")
    print(f"[fleet_demo] causes via tree: {len(live_causes)}  "
          f"in-process replay: {len(replayed)}  byte-identical: {identical}")
    ok = (identical and bool(live_causes) and conserved and hosts_ok
          and attribution_hop_check(args.device)
          and (args.agg_kill_after == 0
               or (restarted and agg.host_restarts >= 1)))
    if not ok:
        if not identical:
            for g, w in zip(got, want):
                if g != w:
                    print("  first divergence:\n   tree:  ", g,
                          "\n   replay:", w)
                    break
            if len(got) != len(want):
                print(f"  length mismatch: {len(got)} vs {len(want)}")
        if not conserved:
            print(f"  row conservation broken: {agg.rows_ingested} != "
                  f"{expected_rows}")
        if not hosts_ok:
            print(f"  host failures: timed out {sorted(timed_out)}, codes "
                  f"{ {h: p.returncode for h, p in host_procs.items()} }")
        print("[fleet_demo] FAILED")
        return 1
    print("[fleet_demo] OK — aggregator failover lost nothing: tree-"
          "delivered causes are byte-identical to in-process replay and "
          f"all {expected_rows} rows arrived exactly once")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hosts", type=int, default=3)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--transport", choices=["tcp", "unix", "shm"],
                    default="tcp")
    ap.add_argument("--kill-after", type=int, default=12,
                    help="SIGKILL the straggler host after it delivered "
                         "this many deltas (0 disables)")
    ap.add_argument("--lease", type=float, default=1.0,
                    help="aggregator host lease (seconds of wall silence)")
    ap.add_argument("--pace", type=float, default=0.02,
                    help="per-step sleep in hosts and parent ticks")
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--aggs", type=int, default=0,
                    help="intermediate TreeAggregator processes (0 = star "
                         "topology); tree mode uses Unix sockets for every "
                         "hop")
    ap.add_argument("--agg-kill-after", type=int, default=8,
                    help="SIGKILL the straggler's aggregator once the root "
                         "has seen this many of its deltas (0 disables)")
    ap.add_argument("--agg-restart-after", type=int, default=4,
                    help="respawn the killed aggregator once the root has "
                         "seen this many MORE acked deltas from hosts on "
                         "the surviving aggregators — progress-derived, so "
                         "the kill/restart interleaving is identical on an "
                         "idle box and a loaded CI runner (a wall-clock "
                         "delay here is what used to flake)")
    ap.add_argument("--device", default=None,
                    help="torch device of the diagnosing processes "
                         "(default: the GPU)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--agg-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--host-index", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--connect", default="", help=argparse.SUPPRESS)
    ap.add_argument("--listen", default="", help=argparse.SUPPRESS)
    ap.add_argument("--journal", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return run_host(args)
    args.device = resolve_device(args.device)
    if args.agg_child:
        return run_agg(args)
    if args.aggs > 0:
        if args.transport == "shm":
            raise SystemExit("tree mode uses socket hops; --transport shm "
                             "only applies to the star topology")
        rc = run_tree_parent(args)
    else:
        rc = run_parent(args)
    if rc == 0:
        print("OK")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
