"""Closed-loop mitigation over the simulated cluster: diagnose → act →
measure the recovered step time.

:class:`SimCluster` replays the paper's verification experiments offline;
this module replays them *closed-loop*: the cluster runs stage by stage,
each completed stage is diagnosed in-loop (the per-step
``BigRootsAnalyzer`` sweep), the confirmed causes feed a
:class:`~repro_torch.ft.policy.PolicyEngine`, and the engine's actions change
how the *remaining* stages execute through a :class:`SimActuator`:

- ``CORDON_HOST``    — the node is removed from scheduling for later
  stages (external contention stays behind on the cordoned machine);
- ``SPECULATE_TASK`` — the straggler's task is re-executed on a clean
  slot; its effective completion is
  ``min(original end, detection point + peer-median duration +
  overhead)``, modeling Spark speculative re-execution launched the
  moment the in-loop diagnosis confirms the cause (the task was
  diagnosable once it exceeded λs × the stage median);
- ``REBALANCE_SHARDS`` / ``TUNE_ROUTER`` — the hot input/shuffle shard
  is split: later stages draw skewed tasks with the skew magnitude
  divided by the split factor;
- ``POOL_BUFFERS``   — allocation churn drops: later stages draw
  GC-thrashing tasks less often, and thrash less when they do.

Approximation note: diagnosis runs when the stage seals, and a granted
speculation is applied retroactively to the stage barrier — the honest
reading is "in-stream detection at λs·median, copy finished before the
original".  Node resource timelines are recorded from the *raw* task
windows (the diagnoser must see the contention the straggler saw), so
the few seconds a speculated task was trimmed by can leave ghost
self-load samples behind; both arms of an A/B carry the same
approximation.

The A/B entry point is :func:`ab_compare`: same seed, same injection
schedule, one arm with a live engine and one with the identical engine
in ``dry_run`` (decisions logged, nothing applied — i.e. diagnose-only).
Per the what-if framing (arXiv 2505.05713) the honest metric is **mean
step (stage) time recovered**, not causes counted:

    ab = ab_compare("cpu", seed=0)
    assert ab.mitigated.mean_step_time < ab.baseline.mean_step_time
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field

from ..core.analyzer import BigRootsAnalyzer, BigRootsThresholds, RootCause
from ..core.features import SPARK_FEATURES
from ..core.records import TaskRecord, Trace
from ..core.whatif import WhatIfReplayer
from ..ft.policy import (
    Action,
    ActionKind,
    Actuator,
    DEFAULT_RULES,
    GuardrailConfig,
    PolicyEngine,
    Rule,
)
from ..telemetry.timeline import ResourceTimeline
from .injector import Injection, InjectionSchedule
from .sim import (
    NET_CAP,
    RESOURCE_KINDS,
    SimCluster,
    WorkloadProfile,
    WORKLOAD_PROFILES,
    perturbed_profile,
)

#: Guardrail tuning for stage-cadence loops (one engine step per stage,
#: not per training step): rate windows shrink accordingly.
SIM_GUARDRAILS = GuardrailConfig(
    max_actions_per_window=8,
    rate_window=4,
    min_fleet=2,
    verify_steps=3,
    flap_limit=2,
    flap_window=64,
    flap_hold=16,
)


class SimActuator(Actuator):
    """Applies policy actions to the simulated cluster's control state.

    The runner reads this state when scheduling the next stage; in a
    ``dry_run`` engine the actuator is never called, so the simulation
    proceeds exactly as diagnose-only."""

    def __init__(self, sim: "ClosedLoopSim") -> None:
        self.sim = sim
        self.cordoned: set[str] = set()
        self.pending_speculations: list[str] = []
        self.pages: list[Action] = []
        self.applied: list[Action] = []
        self.rolled_back: list[Action] = []

    def apply(self, action: Action) -> bool:
        kind = action.kind
        sim = self.sim
        if kind is ActionKind.CORDON_HOST:
            if len(sim.active_nodes()) - 1 < 1:
                return False
            self.cordoned.add(action.target)
        elif kind is ActionKind.SPECULATE_TASK:
            self.pending_speculations.append(action.target)
        elif kind in (ActionKind.REBALANCE_SHARDS, ActionKind.REPLICATE_SHARDS):
            p = sim.cluster.profile
            sim.cluster.profile = perturbed_profile(
                p,
                read_skew_mag=max(1.0, p.read_skew_mag / sim.split_factor),
                remote_prob=p.remote_prob / 2,
            )
        elif kind is ActionKind.TUNE_ROUTER:
            p = sim.cluster.profile
            sim.cluster.profile = perturbed_profile(
                p, shuffle_skew_mag=max(1.0, p.shuffle_skew_mag
                                        / sim.split_factor),
            )
        elif kind is ActionKind.POOL_BUFFERS:
            p = sim.cluster.profile
            sim.cluster.profile = perturbed_profile(
                p,
                gc_heavy_prob=p.gc_heavy_prob / 4,
                gc_heavy_frac=p.gc_heavy_frac / 2,
                spill_prob=p.spill_prob / 2,
            )
        elif kind is ActionKind.PAGE_OPERATOR:
            self.pages.append(action)
        # SAMPLER_BACKOFF / DEEPEN_PREFETCH / ASYNC_CKPT have no analog
        # knob in the stage simulator: report noop so the audit log says
        # so (the train-loop actuator owns those).
        else:
            return False
        self.applied.append(action)
        return True

    def rollback(self, action: Action) -> bool:
        if action.kind is ActionKind.CORDON_HOST:
            self.cordoned.discard(action.target)
            self.rolled_back.append(action)
            return True
        # Profile perturbations are not reversed mid-run (re-merging a
        # split shard is not an operation Spark offers either).
        return False


@dataclass
class LoopResult:
    """One closed-loop run: per-stage step times + what the policy did."""

    stage_times: list[float]
    causes_per_stage: list[int]
    actions: list[Action]
    speculated: int
    cordoned: tuple[str, ...]
    job_duration: float
    engine: PolicyEngine
    actuator: SimActuator

    @property
    def mean_step_time(self) -> float:
        return sum(self.stage_times) / max(len(self.stage_times), 1)


@dataclass
class ABResult:
    """Mitigated vs diagnose-only on identical seed + injections."""

    scenario: str
    mitigated: LoopResult
    baseline: LoopResult

    @property
    def improvement(self) -> float:
        """Fraction of mean step time recovered by acting on causes."""
        base = self.baseline.mean_step_time
        if base <= 0:
            return 0.0
        return 1.0 - self.mitigated.mean_step_time / base


class ClosedLoopSim:
    """Stage-by-stage :class:`SimCluster` execution with an in-loop
    policy engine.

    Unlike ``SimCluster.run`` (which seals the whole job and analyzes
    post-hoc), every stage here is scheduled over the currently active
    (non-cordoned) nodes, diagnosed as soon as it completes, and the
    engine's actions reshape the stages still to come.  One engine step
    == one stage; ``step_time`` fed to the engine (and reported) is the
    stage makespan after speculation.

    ``device`` is where the in-loop analyzer and what-if replayer run
    (``None`` = the GPU, raising when there is none; ``"cpu"`` only when
    asked).
    """

    def __init__(
        self,
        nodes: int = 6,
        slots_per_node: int = 4,
        seed: int = 0,
        profile: WorkloadProfile | str = "naivebayes_large",
        stages: int | None = None,
        schedule: InjectionSchedule | None = None,
        thresholds: BigRootsThresholds | None = None,
        speculation_overhead: float = 1.0,
        split_factor: float = 4.0,
        node_prefix: str = "slave",
        attribution: bool = False,
        device=None,
    ) -> None:
        if isinstance(profile, str):
            profile = WORKLOAD_PROFILES[profile]
        self.cluster = SimCluster(
            nodes=nodes, slots_per_node=slots_per_node, seed=seed,
            profile=profile, node_prefix=node_prefix,
        )
        self.nodes = list(self.cluster.nodes)
        self.slots_per_node = slots_per_node
        self.seed = seed
        self.num_stages = stages if stages is not None else profile.num_stages
        self.schedule = schedule or InjectionSchedule()
        self.thresholds = thresholds or BigRootsThresholds(quantile=0.8)
        self.speculation_overhead = speculation_overhead
        self.split_factor = split_factor
        self.device = device
        self._actuator: SimActuator | None = None
        # What-if attribution: price each diagnosed cause in recovered
        # stage time; the job-level sum lands in ``whatif_recovered_s``.
        self._replayer = (
            WhatIfReplayer(SPARK_FEATURES, device=device)
            if attribution else None
        )
        self.whatif_recovered_s = 0.0

    def active_nodes(self) -> list[str]:
        cordoned = self._actuator.cordoned if self._actuator else set()
        return [n for n in self.nodes if n not in cordoned]

    # ------------------------------------------------------------------
    def run(
        self,
        rules: tuple[Rule, ...] = DEFAULT_RULES,
        *,
        dry_run: bool = False,
        guardrails: GuardrailConfig = SIM_GUARDRAILS,
        audit_path: str | None = None,
    ) -> LoopResult:
        import random

        rng = random.Random(self.seed)
        actuator = SimActuator(self)
        self._actuator = actuator
        self.whatif_recovered_s = 0.0
        engine = PolicyEngine(rules, actuator, guardrails=guardrails,
                              dry_run=dry_run, audit_path=audit_path)
        timeline = ResourceTimeline()
        analyzer = BigRootsAnalyzer(SPARK_FEATURES, self.thresholds,
                                    timelines=timeline, device=self.device)
        stage_times: list[float] = []
        causes_per_stage: list[int] = []
        actions: list[Action] = []
        speculated = 0
        clock = 0.0
        tl_cursor = 0.0
        prev_stage_time: float | None = None
        p0 = self.cluster.profile
        try:
            for stage_idx in range(self.num_stages):
                stage_id = f"stage{stage_idx:03d}"
                active = self.active_nodes()
                tasks = self._run_stage(rng, stage_id, stage_idx, active, clock)
                raw_end = max(t.end for t in tasks)
                tl_cursor = self._sample_timeline(
                    timeline, tasks, tl_cursor, raw_end + 4.0, rng)
                self._attach_resources(tasks, timeline)
                causes = self._diagnose(analyzer, tasks, stage_id)
                causes_per_stage.append(len(causes))
                acted = engine.step(
                    causes, step_time=prev_stage_time,
                    live_hosts=len(active),
                )
                actions.extend(acted)
                # Grant this stage's speculations: effective barrier.
                eff_end = raw_end
                if actuator.pending_speculations:
                    durations = sorted(t.end - t.start for t in tasks)
                    median = statistics.median(durations)
                    by_id = {t.task_id: t for t in tasks}
                    for tid in actuator.pending_speculations:
                        t = by_id.get(tid)
                        if t is None:
                            continue
                        detect = t.start + self.thresholds.straggler * median
                        spec_end = detect + median + self.speculation_overhead
                        if spec_end < t.end:
                            t.end = spec_end
                            speculated += 1
                    actuator.pending_speculations.clear()
                    eff_end = max(t.end for t in tasks)
                stage_time = eff_end - clock
                stage_times.append(stage_time)
                prev_stage_time = stage_time
                clock = eff_end
        finally:
            self.cluster.profile = p0
            self._actuator = None
            engine.close()
        return LoopResult(
            stage_times=stage_times,
            causes_per_stage=causes_per_stage,
            actions=actions,
            speculated=speculated,
            cordoned=tuple(sorted(actuator.cordoned)),
            job_duration=clock,
            engine=engine,
            actuator=actuator,
        )

    # ------------------------------------------------------------------
    def _run_stage(self, rng, stage_id: str, stage_idx: int,
                   active: list[str], stage_start: float):
        p = self.cluster.profile
        slots = [(node, s) for node in active
                 for s in range(self.slots_per_node)]
        free_at = {slot: stage_start for slot in slots}
        tasks = []
        for ti in range(p.tasks_per_stage):
            slot = min(slots, key=lambda s: free_at[s])
            task = self.cluster._make_task(
                rng, stage_id, stage_idx, ti, slot[0], free_at[slot],
                self.schedule, tasks,
            )
            free_at[slot] = task.end
            tasks.append(task)
        return tasks

    def _sample_timeline(self, tl: ResourceTimeline, tasks, t0: float,
                         horizon: float, rng) -> float:
        """1 Hz node samples over [t0, horizon) — baseline noise + task
        self-load + whatever the injection schedule says is running on
        the node at that instant (cordoned nodes keep their contention;
        nothing of ours runs there)."""
        sched = self.schedule
        by_node: dict[str, list] = {n: [] for n in self.nodes}
        for t in tasks:
            by_node[t.node].append(t)
        t = t0
        while t < horizon:
            for node in self.nodes:
                running = [x for x in by_node[node] if x.start <= t < x.end]
                cpu = min(0.05 + 0.02 * rng.random()
                          + sum(x.cpu_self for x in running)
                          + sched.active(node, "cpu", t), 1.0)
                disk = min(0.02 + 0.02 * rng.random()
                           + sum(x.disk_self for x in running)
                           + sched.active(node, "disk", t), 1.0)
                net = (0.005 * NET_CAP * rng.random()
                       + sum(x.net_self for x in running)
                       + sched.active(node, "network", t) * NET_CAP)
                tl.record(node, "cpu", t, cpu)
                tl.record(node, "disk", t, disk)
                tl.record(node, "network", t, net)
            t += 1.0
        return max(t, t0)

    def _attach_resources(self, tasks, tl: ResourceTimeline) -> None:
        for t in tasks:
            for metric in RESOURCE_KINDS:
                val = tl.window_mean(t.node, metric, t.start, t.end)
                t.features[metric] = val if val is not None else 0.0

    def _diagnose(self, analyzer: BigRootsAnalyzer, tasks,
                  stage_id: str) -> list[RootCause]:
        trace = Trace()
        for t in tasks:
            trace.add_task(TaskRecord(
                task_id=t.task_id, stage_id=t.stage_id, node=t.node,
                start=t.start, end=t.end, locality=t.locality,
                features=t.features,
            ))
        causes = [c for sa in analyzer.analyze(trace)
                  for c in sa.root_causes]
        if self._replayer is not None:
            causes = self._replayer.attribute(trace, causes)
            # Joint recovery (all implicated rows rebased together), not
            # the per-cause sum: concurrent stragglers shadow each other
            # in the exclusive counterfactual, and mitigation acts on
            # the whole diagnosis at once.
            self.whatif_recovered_s += sum(
                self._replayer.last_stage_recovery.values()
            )
        return causes


# ----------------------------------------------------------------------
#: Scenario name → (profile overrides, injection builder).  These are the
#: paper's incident classes (§IV-B contention AGs, Table VI organic skew
#: and GC churn) staged for the closed-loop A/B.
def _contention_schedule(kind: str, node: str) -> InjectionSchedule:
    return InjectionSchedule([Injection(node, kind, 0.0, 1e9, level=0.9)])


def _scenario(name: str, nodes: int, node_prefix: str):
    base = WORKLOAD_PROFILES["naivebayes_large"]
    target = f"{node_prefix}1"
    if name in ("cpu", "disk", "network"):
        return base, _contention_schedule(name, target)
    if name == "skew":
        return perturbed_profile(base, read_skew_prob=0.25,
                                 read_skew_mag=12.0), InjectionSchedule()
    if name == "gc":
        return perturbed_profile(base, gc_heavy_prob=0.25,
                                 gc_heavy_frac=0.5), InjectionSchedule()
    raise ValueError(f"unknown scenario {name!r} "
                     "(cpu|disk|network|skew|gc)")


SCENARIOS = ("cpu", "disk", "network", "skew", "gc")


def ab_compare(
    scenario: str,
    *,
    seed: int = 0,
    stages: int = 10,
    nodes: int = 6,
    slots_per_node: int = 4,
    rules: tuple[Rule, ...] = DEFAULT_RULES,
    guardrails: GuardrailConfig = SIM_GUARDRAILS,
    audit_path: str | None = None,
    node_prefix: str = "slave",
    device=None,
) -> ABResult:
    """Run one incident scenario twice — live engine vs the same engine
    in ``dry_run`` (diagnose-only) — on the identical seed and injection
    schedule, and report the recovered step time.

    Both arms consume the same RNG stream until the first applied action
    diverges them, which is exactly the counterfactual of interest.
    ``device`` is where both arms diagnose (see :class:`ClosedLoopSim`)."""
    profile, schedule = _scenario(scenario, nodes, node_prefix)

    def arm(dry_run: bool, path: str | None) -> LoopResult:
        sim = ClosedLoopSim(
            nodes=nodes, slots_per_node=slots_per_node, seed=seed,
            profile=profile, stages=stages, schedule=schedule,
            node_prefix=node_prefix, device=device,
        )
        return sim.run(rules, dry_run=dry_run, guardrails=guardrails,
                       audit_path=path)

    baseline = arm(True, None)
    mitigated = arm(False, audit_path)
    return ABResult(scenario=scenario, mitigated=mitigated,
                    baseline=baseline)


def whatif_recovery(
    scenario: str,
    *,
    seed: int = 0,
    stages: int = 10,
    nodes: int = 6,
    slots_per_node: int = 4,
    node_prefix: str = "slave",
    device=None,
) -> float:
    """Predicted recovered seconds for one incident scenario: a
    diagnose-only run (no actions applied) with what-if attribution on,
    summing the replayer's *joint* per-stage recovery
    (``WhatIfReplayer.last_stage_recovery``) across the job — the joint
    counterfactual rebases every implicated row at once, so concurrent
    stragglers don't shadow each other the way per-cause exclusive
    estimates do.

    This is the *prediction* side of the what-if framing: it prices the
    incident without running the mitigated arm.  Ranking scenarios by
    this predictor matches the measured A/B ordering of
    :func:`ab_compare` (pinned in ``tests/test_whatif.py`` for the cpu
    and skew scenarios).  ``device`` as for :class:`ClosedLoopSim`."""
    profile, schedule = _scenario(scenario, nodes, node_prefix)
    sim = ClosedLoopSim(
        nodes=nodes, slots_per_node=slots_per_node, seed=seed,
        profile=profile, stages=stages, schedule=schedule,
        node_prefix=node_prefix, attribution=True, device=device,
    )
    sim.run(DEFAULT_RULES, dry_run=True)
    return sim.whatif_recovered_s
