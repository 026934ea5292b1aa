"""End-to-end training driver with BigRoots telemetry in the loop.

Runs a real PyTorch training loop (any decoder-only --arch, reduced or full
config) on the GPU, or on the host with ``--device cpu``, with:
  - host-sharded synthetic data + background prefetch,
  - per-step phase timing + /proc resource sampling → TaskRecords
    (stage = window of steps; on a single host the peer set is the step
    window, BigRoots' intra-node observation),
  - *in-loop* BigRoots diagnosis every step through the fleet-aggregation
    path: telemetry cuts a columnar StepDelta per step, a FleetAggregator
    merges it into per-stage sliding windows, and one fleet-wide
    ``analyze_fleet`` sweep emits newly confirmed RootCauses live — the
    same launcher-side pipeline a multi-host job shards over
    (``--no-live-diagnose`` to disable),
  - optional live anomaly generators injected mid-run (the paper's §IV-B
    verification, on the real host),
  - checkpointing (atomic/async/retention) + supervised restart,
  - offline BigRoots analysis + mitigation plan at the end (the reference
    post-hoc pass the live stream is property-tested against).

The forward runs the hand-written kernels of the default config (flash
attention, the SSD intra-chunk, the grouped matmul; their gradients are
their plain versions', ``repro_torch.kernels.grad``) and the live
diagnosis tick the Eq. 5 gate kernel.

On the GPU, at full size:
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite_moe_1b_a400m --steps 8 --batch 8 --seq 512
CPU-sized example (the e2e deliverable, the kernels' plain versions):
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_130m \\
      --smoke --device cpu --steps 24
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..anomaly.generators import GENERATORS
from ..anomaly.injector import Injection, InjectionSchedule
from ..ckpt.manager import CheckpointManager
from ..configs import get_config
from ..core import (
    BigRootsAnalyzer,
    JAX_FEATURES,
    PCCAnalyzer,
    evaluate,
    found_set,
    render_markdown,
    summarize,
)
from ..data.pipeline import DataConfig, HostDataLoader, Prefetcher
from ..device import resolve_device
from ..ft.elastic import reshard_plan
from ..ft.mitigation import MitigationPlanner
from ..ft.policy import (
    ActionKind,
    DEFAULT_RULES,
    PolicyEngine,
    forecast_rule,
    load_policy,
)
from ..models import Model, smoke_variant
from ..serve import Diagnosis
from ..serve.fleet import FleetAggregator, TreeAggregator
from ..telemetry.events import GcTimer, StepTelemetry
from ..telemetry.transport import DeltaServer
from ..telemetry.sampler import SystemSampler
from ..telemetry.timeline import ResourceTimeline
from ..train.optimizer import AdamWConfig
from ..train.step import init_state, make_train_step


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite_8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--window", type=int, default=16,
                    help="BigRoots stage window (steps)")
    ap.add_argument("--no-live-diagnose", dest="live_diagnose",
                    action="store_false", default=True,
                    help="disable in-loop (per-step) BigRoots diagnosis")
    ap.add_argument("--live-window", type=int, default=0,
                    help="live-diagnosis row cap per merged stage window "
                         "(default: unbounded; stages are already bounded "
                         "by --window steps per host)")
    ap.add_argument("--fleet-connect", default="",
                    help="ship per-step StepDeltas to a remote aggregator "
                         "at this address ('host:port' or 'unix:/path') "
                         "instead of diagnosing locally — the host role "
                         "of a multi-host launch")
    ap.add_argument("--fleet-listen", default="",
                    help="also accept remote hosts' StepDeltas at this "
                         "address and merge them into this process's "
                         "fleet diagnosis — the launcher role of a "
                         "multi-host launch")
    ap.add_argument("--fleet-lease", type=float, default=10.0,
                    help="lease floor: seconds without a delta before a "
                         "connected host is declared dark and a dropout "
                         "cause is escalated; the effective per-host lease "
                         "adapts upward from observed cadence (only "
                         "meaningful with --fleet-listen)")
    ap.add_argument("--fleet-role",
                    choices=["auto", "host", "aggregator", "root"],
                    default="auto",
                    help="explicit fleet role; default derives it from the "
                         "flags (--fleet-connect => host, --fleet-parent "
                         "=> aggregator, --fleet-listen => root)")
    ap.add_argument("--fleet-parent", default="",
                    help="run as a tree aggregator: accept children at "
                         "--fleet-listen, merge locally, and forward "
                         "pre-merged envelopes upstream to this address "
                         "('host:port' or 'unix:/path')")
    ap.add_argument("--fleet-journal", default="",
                    help="aggregator-HA journal path: watermarks, window "
                         "snapshots, and unacked forwards persist here so "
                         "a restarted aggregator resumes instead of "
                         "re-learning (see docs/operations.md)")
    ap.add_argument("--fleet-name", default="",
                    help="fleet-unique aggregator identity for tree roles "
                         "(default: --host); stable across restarts")
    ap.add_argument("--mitigate", action="store_true",
                    help="close the loop: run the guarded policy engine "
                         "(ft.policy) over every live-diagnosis tick and "
                         "act on confirmed causes through this process's "
                         "knobs")
    ap.add_argument("--mitigate-dry-run", action="store_true",
                    help="run the policy engine's full decision path and "
                         "audit log without touching any knob (implies "
                         "--mitigate)")
    ap.add_argument("--policy", default="",
                    help="JSON policy file (ft.policy.load_policy format); "
                         "default: the built-in DEFAULT_RULES")
    ap.add_argument("--forecast", default="",
                    help="enable the predictive straggler hop: comma-"
                         "separated scenario names "
                         "(repro_torch.anomaly.scenario library) to export "
                         "labeled episodes from and "
                         "train the forecaster on at startup, e.g. "
                         "'hot_host_cpu,clock_skew'; tagged "
                         "predicted_straggler candidates then ride every "
                         "diagnosis tick (with --mitigate and no --policy "
                         "file, the opt-in forecast_rule is armed too)")
    ap.add_argument("--forecast-risk", type=float, default=0.7,
                    help="risk score above which a node emits a "
                         "predicted_straggler candidate cause")
    ap.add_argument("--forecast-horizon", type=int, default=3,
                    help="label lookahead in steps for episode export")
    ap.add_argument("--forecast-length", type=int, default=8,
                    help="telemetry steps per scored sequence")
    ap.add_argument("--forecast-train-steps", type=int, default=300,
                    help="Adam steps for the startup training run")
    ap.add_argument("--audit-log", default="",
                    help="append-only JSONL audit log of every policy "
                         "decision, including suppressed ones")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--anomaly", choices=["cpu", "disk", "network", "none"],
                    default="none")
    ap.add_argument("--anomaly-at", type=int, default=20)
    ap.add_argument("--anomaly-steps", type=int, default=15)
    ap.add_argument("--anomaly-workers", type=int, default=4)
    ap.add_argument("--skew-factor", type=float, default=1.0,
                    help=">1 injects data skew into this host's shard")
    ap.add_argument("--trace-out", default="")
    ap.add_argument("--report-out", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host", default="host0")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions on the host)")
    return ap


class TrainActuator:
    """Launcher-side :class:`~repro_torch.ft.policy.Actuator`: maps policy
    actions onto this process's real knobs.

    - ``SAMPLER_BACKOFF`` stretches the /proc sampler's interval (halves
      its overhead under gc/contention churn); rollback restores it.
    - ``ASYNC_CKPT`` flips subsequent checkpoint saves to non-blocking.
    - ``CORDON_HOST`` computes an :func:`~repro_torch.ft.elastic.reshard_plan`
      over the fleet roster minus the cordoned host — the re-mesh a
      multi-host launcher would execute (here: printed + recorded).
    - ``PAGE_OPERATOR`` prints the page and records it.

    Knobs with no in-process surface (prefetch depth is fixed at loader
    construction) return ``False`` so the audit log records
    ``actuator_noop`` instead of a silently faked success."""

    def __init__(self, sampler, fleet=None, *,
                 chips_per_host: int = 8, model_axis: int = 1) -> None:
        self.sampler = sampler
        self.fleet = fleet
        self.chips_per_host = chips_per_host
        self.model_axis = model_axis
        self.async_ckpt: bool | None = None    # None = knob untouched
        self.pages: list[str] = []
        self.reshard_plans: list = []
        self._interval0 = sampler.interval if sampler is not None else None

    def apply(self, action) -> bool:
        kind = action.kind
        if kind is ActionKind.SAMPLER_BACKOFF and self.sampler is not None:
            self.sampler.interval = min(self.sampler.interval * 2.0, 5.0)
            return True
        if kind is ActionKind.ASYNC_CKPT:
            self.async_ckpt = True
            return True
        if kind is ActionKind.PAGE_OPERATOR:
            page = action.detail or action.cause_key
            self.pages.append(page)
            print(f"[policy] PAGE OPERATOR: {page}")
            return True
        if kind is ActionKind.CORDON_HOST and self.fleet is not None:
            roster = sorted(self.fleet.host_seq)
            alive = [h for h in roster
                     if h != action.target
                     and h not in self.fleet.dropped_hosts]
            if not alive:
                return False
            try:
                plan = reshard_plan(
                    (len(roster) * self.chips_per_host // self.model_axis,
                     self.model_axis),
                    alive, roster, self.chips_per_host,
                    model_axis=self.model_axis,
                )
            except ValueError:
                return False    # below one data row: refuse, audit shows it
            self.reshard_plans.append(plan)
            print(f"[policy] cordon {action.target}: re-mesh "
                  f"{plan.old_shape} -> {plan.new_shape} "
                  f"({plan.chips_idle} chips idle)")
            return True
        if kind is ActionKind.UNCORDON_HOST:
            return True    # roster-only: next reshard plan includes it again
        return False

    def rollback(self, action) -> bool:
        kind = action.kind
        if kind is ActionKind.SAMPLER_BACKOFF and self.sampler is not None:
            self.sampler.interval = self._interval0
            return True
        if kind is ActionKind.ASYNC_CKPT:
            self.async_ckpt = None
            return True
        return False


def run(args) -> dict:
    device = resolve_device(getattr(args, "device", None))
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    model = Model(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=max(args.steps, 2),
                          warmup_steps=max(args.steps // 10, 1))
    state = init_state(model,
                       torch.Generator(device=device).manual_seed(args.seed),
                       opt_cfg, compress=args.compress_grads)
    train_step = make_train_step(model, opt_cfg, accum=args.accum,
                                 compress=args.compress_grads)

    dcfg = DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, batch_per_host=args.batch,
        seed=args.seed,
        skew_host=0 if args.skew_factor > 1 else None,
        skew_factor=args.skew_factor,
        embed_tokens=cfg.frontend_tokens,
        d_model=cfg.d_model if (cfg.frontend_tokens or cfg.enc_layers) else 0,
        enc_frames=args.seq // 4 if cfg.enc_layers else 0,
    )
    loader = HostDataLoader(dcfg, host_id=0, num_hosts=1)

    timeline = ResourceTimeline()
    sampler = SystemSampler(args.host, timeline, interval=0.25)
    gc_timer = GcTimer().install()
    live_diagnose = getattr(args, "live_diagnose", True)
    telem = StepTelemetry(
        args.host, timeline=timeline, window=args.window, gc_timer=gc_timer,
        wire=live_diagnose,
    )
    # Live diagnosis runs through the launcher's fleet-aggregation path —
    # per-step StepDeltas merged into per-stage windows, one analyze_fleet
    # sweep per step — wired through the Diagnosis facade.  On a
    # single-host run it is a fleet of one.  A multi-host launch picks a
    # role per process: hosts run with --fleet-connect (forward deltas,
    # no local sweep), the root runs with --fleet-listen (merge + sweep,
    # host-dropout leases armed), and intermediate tree aggregators run
    # with --fleet-listen *and* --fleet-parent (merge their sub-fleet,
    # forward pre-merged envelopes upstream; add --fleet-journal for HA).
    fleet = None
    fleet_server = None
    diagnosis = None
    fleet_connect = getattr(args, "fleet_connect", "")
    fleet_listen = getattr(args, "fleet_listen", "")
    fleet_parent = getattr(args, "fleet_parent", "")
    fleet_journal = getattr(args, "fleet_journal", "")
    fleet_name = getattr(args, "fleet_name", "") or args.host
    role = getattr(args, "fleet_role", "auto")
    if fleet_connect and (fleet_listen or fleet_parent):
        raise SystemExit(
            "--fleet-connect is the leaf-host role and excludes "
            "--fleet-listen/--fleet-parent: a host ships its deltas "
            "upstream, aggregators listen (and forward with "
            "--fleet-parent)"
        )
    if role == "auto":
        role = ("host" if fleet_connect
                else "aggregator" if fleet_parent else "root")
    if role == "host" and not fleet_connect:
        raise SystemExit("--fleet-role host needs --fleet-connect")
    if role == "aggregator" and not fleet_parent:
        raise SystemExit("--fleet-role aggregator needs --fleet-parent")
    if live_diagnose:
        if role == "host":
            diagnosis = Diagnosis.forward(fleet_connect)
        else:
            agg_kwargs = dict(
                max_rows=(getattr(args, "live_window", 0) or None),
                max_stages=8,
                lease=(getattr(args, "fleet_lease", 10.0)
                       if fleet_listen else None),
            )
            analyzer = BigRootsAnalyzer(JAX_FEATURES, timelines=timeline,
                                        device=device)
            if role == "aggregator" or fleet_journal:
                fleet = TreeAggregator(
                    JAX_FEATURES, analyzer, name=fleet_name,
                    parent=(fleet_parent or None),
                    journal=(fleet_journal or None), **agg_kwargs,
                )
            else:
                fleet = FleetAggregator(JAX_FEATURES, analyzer, **agg_kwargs)
            # An intermediate aggregator forwards; the sweep (and the
            # causes) belong to the root.  Its Diagnosis still pumps the
            # upstream side every tick.
            diagnosis = Diagnosis.fleet(fleet, drive=(role != "aggregator"))
            if fleet_listen:
                # With a journal, defer child acks until drain_into has
                # ingested (and journaled) — a child's ack then means
                # "durable across my restart", closing the failover gap.
                fleet_server = DeltaServer(
                    fleet_listen,
                    ack="drain" if fleet_journal else "enqueue",
                )
                print(f"[fleet] {role} aggregating at "
                      f"{fleet_server.endpoint}")
    live_causes: list[dict] = []

    # Predictive hop (opt-in): train the straggle-risk forecaster on
    # scenario episodes at startup and wire it into the driving
    # Diagnosis — one extra batched launch per tick, candidates tagged
    # `predicted_straggler` (see repro_torch.core.forecast).
    forecast_spec = getattr(args, "forecast", "")
    if (forecast_spec and diagnosis is not None
            and diagnosis.aggregator is not None and diagnosis.drive):
        from ..anomaly.scenario import export_episodes
        from ..core.forecast import Forecaster

        episodes = [
            export_episodes(
                name.strip(),
                length=getattr(args, "forecast_length", 8),
                horizon=getattr(args, "forecast_horizon", 3),
                device=device,
            )
            for name in forecast_spec.split(",") if name.strip()
        ]
        diagnosis.forecaster = Forecaster.train(
            episodes, JAX_FEATURES, seed=args.seed,
            steps=getattr(args, "forecast_train_steps", 300),
            risk_threshold=getattr(args, "forecast_risk", 0.7),
            device=device,
        )
        print(f"[forecast] trained on "
              f"{sum(len(e.y) for e in episodes)} sequences "
              f"({sum(e.positives for e in episodes)} positive) from "
              f"{forecast_spec}")

    # Closed-loop mitigation: policy engine ticked by the fleet aggregator
    # every diagnosis step (see ft.policy).  Only meaningful where the
    # causes are — the aggregator role; a --fleet-connect host ships raw
    # deltas and diagnoses nothing locally.
    policy = None
    actuator = None
    dry_run = getattr(args, "mitigate_dry_run", False)
    if (getattr(args, "mitigate", False) or dry_run) and fleet is not None:
        policy_path = getattr(args, "policy", "")
        rules = load_policy(policy_path) if policy_path else DEFAULT_RULES
        if not policy_path and diagnosis.forecaster is not None:
            rules = (*rules, forecast_rule())
        actuator = TrainActuator(sampler, fleet=fleet)
        policy = PolicyEngine(
            rules, actuator, dry_run=dry_run,
            audit_path=(getattr(args, "audit_log", "") or None),
        )
        fleet.policy = policy

    ckpt = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None

    # live anomaly schedule (ground truth for the verification accounting)
    generator = None
    schedule_entries = []
    losses = []
    with sampler, Prefetcher(loader, depth=2) as prefetch:
        t_start = time.time()
        for step in range(args.steps):
            # anomaly lifecycle
            if args.anomaly != "none" and step == args.anomaly_at:
                generator = GENERATORS[args.anomaly](
                    workers=args.anomaly_workers
                ).start()
                anomaly_t0 = time.time()
            if generator is not None and step == args.anomaly_at + args.anomaly_steps:
                generator.stop()
                schedule_entries.append(
                    Injection(args.host, args.anomaly, anomaly_t0, time.time())
                )
                generator = None

            t_step0 = time.time()
            with telem.step(step) as scope:
                with scope.phase("data_load"):
                    batch_np, meta = prefetch.next()
                scope.add("read_bytes", meta.read_bytes)
                scope.set_locality(meta.locality)
                with scope.phase("h2d"):
                    batch = {k: torch.from_numpy(v).to(device)
                             for k, v in batch_np.items()}
                with scope.phase("compute"):
                    state, metrics = train_step(state, batch)
                    loss = float(metrics["loss"])
                if ckpt and step > 0 and step % args.ckpt_every == 0:
                    # The policy's ASYNC_CKPT action flips saves to
                    # non-blocking mid-run (rollback restores the flag).
                    go_async = args.async_ckpt or (
                        actuator is not None and bool(actuator.async_ckpt)
                    )
                    with scope.phase("ckpt"):
                        ckpt.save(step, state["params"],
                                  blocking=not go_async)
            losses.append(loss)
            if diagnosis is not None:
                if fleet_server is not None:
                    fleet_server.drain_into(fleet)
                for cause in diagnosis.tick(
                    telem, step_time=time.time() - t_step0
                ):
                    live_causes.append({
                        "step": step, "task": cause.task_id,
                        "feature": cause.feature, "value": cause.value,
                    })
                    print(f"[live-diagnosis] step {step}: {cause.task_id} "
                          f"<- {cause.feature} (F={cause.value:.3g})")
        if generator is not None:
            generator.stop()
            schedule_entries.append(
                Injection(args.host, args.anomaly, anomaly_t0, time.time())
            )
        wall = time.time() - t_start
    gc_timer.uninstall()
    if ckpt:
        ckpt.wait()
    if diagnosis is not None and diagnosis.mode == "forward":
        # At-least-once: block until the aggregator acked everything this
        # host produced (a crash-free run must lose nothing), then hang up.
        if not diagnosis.flush(timeout=10.0):
            sink = diagnosis.sink
            print(f"[fleet] WARNING: aggregator unreachable at exit — "
                  f"{sink.unacked} deltas unacked, "
                  f"{sink.resend_drops} shed earlier; the fleet "
                  f"view of this host is incomplete")
        diagnosis.close()
    if fleet_server is not None:
        # Quiesce before closing: frames the server acks are a promise to
        # ingest, and straggling hosts may still be flushing their tails.
        # Keep draining until two consecutive quiet passes (or a grace
        # deadline), then run one last sweep — only then drop the socket.
        grace = time.time() + 5.0
        quiet = 0
        while quiet < 2 and time.time() < grace:
            if fleet_server.drain_into(fleet) == 0 and fleet_server.pending == 0:
                quiet += 1
            else:
                quiet = 0
            time.sleep(0.2)
        for cause in fleet.step():
            live_causes.append({
                "step": args.steps, "task": cause.task_id,
                "feature": cause.feature, "value": cause.value,
            })
        fleet_server.close()
    if isinstance(fleet, TreeAggregator):
        # Push the forwarded tail upstream (and ack it into the journal)
        # before exit; a clean shutdown leaves nothing pending.
        if fleet.parent is not None and not fleet.flush(timeout=10.0):
            print(f"[fleet] WARNING: parent unreachable at exit — "
                  f"{fleet.pending_forwards} payloads unacked (journaled: "
                  f"{'yes' if fleet.journal else 'no'})")
        fleet.close()
    if policy is not None:
        policy.close()

    # ---- offline BigRoots analysis ---------------------------------------
    trace = telem.trace
    analyzer = BigRootsAnalyzer(JAX_FEATURES, timelines=timeline,
                                device=device)
    analyses = analyzer.analyze(trace)
    summary = summarize(analyses)
    report = render_markdown(summary, title=f"BigRoots report — {cfg.name}")
    plan = MitigationPlanner().plan(
        [c for sa in analyses for c in sa.root_causes]
    )

    schedule = InjectionSchedule(schedule_entries)
    truth = set()
    for stage in trace.stages():
        for t in stage.tasks:
            for kind in ("cpu", "disk", "network"):
                if schedule.affected(t.node, kind, t.start, t.end):
                    truth.add((t.task_id, kind))
    found = found_set(analyzer.root_causes(trace))
    straggler_ids = {tid for sa in analyses for tid in sa.straggler_ids}
    universe = {(tid, f) for tid in straggler_ids for f in JAX_FEATURES.names}
    conf = evaluate(found, truth, universe)

    out = {
        "arch": cfg.name,
        "steps": args.steps,
        "wall_seconds": wall,
        "final_loss": losses[-1] if losses else None,
        "loss_decreased": bool(losses and losses[-1] < losses[0]),
        "num_stragglers": summary.num_stragglers,
        "root_causes": dict(summary.causes_by_feature),
        "live_causes": live_causes,
        "live_causes_count": len(live_causes),
        "mitigations": [
            {"action": m.action.value, "target": m.target, "evidence": m.evidence}
            for m in plan
        ],
        "policy": (
            None if policy is None else {
                **policy.stats(),
                "dry_run": policy.dry_run,
                "pages": list(actuator.pages),
                "reshard_plans": [
                    {"old_shape": list(p.old_shape),
                     "new_shape": list(p.new_shape),
                     "dropped_hosts": list(p.dropped_hosts),
                     "chips_idle": p.chips_idle}
                    for p in actuator.reshard_plans
                ],
            }
        ),
        "injection": {
            "kind": args.anomaly,
            "truth_pairs": len(truth & universe),
            "tp": conf.tp, "fp": conf.fp, "fn": conf.fn,
        },
        "report": report,
    }
    if args.trace_out:
        trace.dump_jsonl(args.trace_out)
        timeline.dump_jsonl(args.trace_out + ".timeline")
    if args.report_out:
        with open(args.report_out, "w") as f:
            f.write(report + "\n\n```json\n"
                    + json.dumps({k: v for k, v in out.items() if k != "report"},
                                 indent=2, default=str)
                    + "\n```\n")
    return out


def main(argv: list[str] | None = None) -> None:
    args = build_argparser().parse_args(argv)
    out = run(args)
    print(out["report"])
    print(json.dumps({k: v for k, v in out.items() if k != "report"},
                     indent=2, default=str))


if __name__ == "__main__":
    main()
