"""Closed-loop mitigation: a guarded policy engine that turns RootCauses
into actions.

BigRoots' headline claim (paper §I) is that knowing *why* a task straggled
enables a targeted fix instead of blind speculative re-execution.  Up to
now the pipeline ended at a cause stream — :class:`MitigationPlanner`
printed a plan once, offline.  This module closes the loop: a
:class:`PolicyEngine` runs *inside* the per-step diagnosis loop
(``ServeEngine``, ``FleetAggregator.step``, a training loop),
evaluates every confirmed :class:`~repro_torch.core.analyzer.RootCause` against
declarative :class:`Rule`\\ s, and executes the resulting
:class:`Action`\\ s through a pluggable :class:`Actuator` — the anomaly
simulator, the serve engine, and the fleet launcher all share one engine
and differ only in the actuator they plug in.

Robustness is the design center, not an afterthought.  Every action must
pass the guardrail chain before it reaches the actuator, and **every**
decision — acted on or suppressed — lands in an append-only audit log
with the guardrail that fired:

- *recurrence*: a rule only fires after ``min_recurrence`` matching
  causes on the same scope target within ``recurrence_window`` steps
  (one noisy window must not cordon a host);
- *cooldown*: the same ``(action, target)`` cannot repeat within the
  rule's ``cooldown`` steps;
- *rate limit*: at most ``max_actions_per_window`` actions of one kind
  per ``rate_window`` steps, fleet-wide;
- *quorum floor*: a cordon that would leave fewer than ``min_fleet``
  live hosts is refused outright;
- *flap damping*: a host that cycles cordon→rejoin ``flap_limit`` times
  within ``flap_window`` steps is held un-cordonable for ``flap_hold``
  steps (hysteresis against oscillating contention);
- *rollback*: an applied action opens a verification watch; if the mean
  step time over the next ``verify_steps`` steps did not improve on the
  pre-action baseline, the action is rolled back through the actuator
  and the target charged with a flap;
- *recovery budget*: with what-if attribution on, causes are ranked by
  estimated recovered time (``attribution.cumulative_recovery_s``, raw
  severity as tie-break) before evaluation, and
  ``min_recovery_s`` refuses actions whose priced cause recovers less
  than the configured floor — actions are budgeted by what they are
  worth, not how loud the cause was.  Unattributed causes (attribution
  off, or synthesized findings like host dropouts) are never ranked or
  vetoed on recovery, so an unattributed stream's decision log is
  byte-identical to the pre-attribution engine's.

``dry_run=True`` evaluates everything — the same rules, the same
guardrail state transitions, the same rollback verdicts — but never
calls the actuator: the decision log of a dry-run over a given input
stream is byte-identical to the live engine's (``decision_log_bytes``),
which is what makes staging a policy against production traffic safe.
"""
from __future__ import annotations

import enum
import json
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Sequence

from ..core.analyzer import RootCause

#: Matches any cause feature in a Rule's ``features``.
ANY_FEATURE = "*"


class ActionKind(enum.Enum):
    """The framework knobs a policy can turn (superset of the offline
    :class:`~repro_torch.ft.mitigation.MitigationAction` vocabulary, plus the
    closed-loop-only verbs: cordon/uncordon, speculation, sampler
    backoff, operator page)."""

    CORDON_HOST = "cordon_host"          # drop host + ft.elastic re-mesh plan
    UNCORDON_HOST = "uncordon_host"      # rollback of a cordon
    SPECULATE_TASK = "speculate_task"    # re-execute the straggler's task
    REBALANCE_SHARDS = "rebalance_shards"
    REPLICATE_SHARDS = "replicate_shards"
    TUNE_ROUTER = "tune_router"
    ASYNC_CKPT = "async_ckpt"
    DEEPEN_PREFETCH = "deepen_prefetch"
    POOL_BUFFERS = "pool_buffers"
    SAMPLER_BACKOFF = "sampler_backoff"  # telemetry sampling off the hot path
    PAGE_OPERATOR = "page_operator"


#: Action kinds whose effect is reversible and therefore watched for
#: rollback when the engine is fed step times.
REVERSIBLE = frozenset({
    ActionKind.CORDON_HOST,
    ActionKind.REBALANCE_SHARDS,
    ActionKind.TUNE_ROUTER,
    ActionKind.SAMPLER_BACKOFF,
    ActionKind.DEEPEN_PREFETCH,
    ActionKind.POOL_BUFFERS,
})


@dataclass(frozen=True)
class Action:
    """One concrete actuation: what to do, to what, and why."""

    kind: ActionKind
    target: str                  # host / task id / "-" for global knobs
    rule: str                    # name of the Rule that fired
    cause_key: tuple[str, str]   # (task_id, feature) that triggered it
    step: int                    # engine step the decision was made at
    detail: str = ""


@dataclass(frozen=True)
class Rule:
    """One declarative mapping ``(cause feature, severity, recurrence,
    scope) → action``.

    ``features`` lists the cause features that match (``"*"`` for any);
    ``scope`` picks the action target from the cause: ``"host"`` →
    ``cause.node``, ``"task"`` → ``cause.task_id``, ``"global"`` →
    ``"-"``.  Recurrence is counted per (rule, target): the rule fires
    only once ``min_recurrence`` matching causes were seen on that
    target within ``recurrence_window`` engine steps.
    """

    name: str
    features: tuple[str, ...]
    action: ActionKind
    scope: str = "host"               # 'host' | 'task' | 'global'
    min_severity: int = 1
    min_recurrence: int = 1
    recurrence_window: int = 64
    cooldown: int = 32
    detail: str = ""

    def __post_init__(self) -> None:
        if self.scope not in ("host", "task", "global"):
            raise ValueError(f"rule {self.name!r}: bad scope {self.scope!r}")
        if self.min_recurrence < 1:
            raise ValueError(f"rule {self.name!r}: min_recurrence must be >= 1")

    def target_of(self, cause: RootCause) -> str:
        if self.scope == "host":
            return cause.node
        if self.scope == "task":
            return cause.task_id
        return "-"

    @staticmethod
    def from_dict(obj: dict) -> "Rule":
        """Build a rule from its JSON form (see docs/operations.md —
        'Closed-loop mitigation': one object per rule, ``action`` by
        enum value)."""
        kind = ActionKind(obj["action"])
        return Rule(
            name=obj["name"],
            features=tuple(obj["features"]),
            action=kind,
            scope=obj.get("scope", "host"),
            min_severity=int(obj.get("min_severity", 1)),
            min_recurrence=int(obj.get("min_recurrence", 1)),
            recurrence_window=int(obj.get("recurrence_window", 64)),
            cooldown=int(obj.get("cooldown", 32)),
            detail=obj.get("detail", ""),
        )


def load_policy(path: str) -> list[Rule]:
    """Load a JSON policy file: either a list of rule objects or
    ``{"rules": [...]}``."""
    with open(path) as f:
        obj = json.load(f)
    rules = obj["rules"] if isinstance(obj, dict) else obj
    return [Rule.from_dict(r) for r in rules]


#: The shipped default policy: the README mitigation table as rules.
#: Contention causes get a cheap task-scoped speculation immediately and a
#: host cordon only on recurrence; global knob tweaks need two sightings so
#: a single noisy window cannot retune the job.
DEFAULT_RULES: tuple[Rule, ...] = (
    Rule("speculate_contended", ("cpu", "disk", "network"),
         ActionKind.SPECULATE_TASK, scope="task",
         min_recurrence=1, cooldown=8,
         detail="re-execute the straggler's task on a clean host"),
    Rule("cordon_contended", ("cpu", "disk", "network"),
         ActionKind.CORDON_HOST, scope="host",
         min_recurrence=2, recurrence_window=64, cooldown=64,
         detail="repeated external contention; drop host and re-mesh"),
    Rule("cordon_dropout", ("host_dropout",),
         ActionKind.CORDON_HOST, scope="host",
         min_recurrence=1, cooldown=64,
         detail="host stopped reporting; re-mesh without it"),
    Rule("page_dead_mid_incident", ("host_dropout",),
         ActionKind.PAGE_OPERATOR, scope="host", min_severity=2,
         min_recurrence=1, cooldown=256,
         detail="host died mid-incident: straggler signal and telemetry "
                "vanished together"),
    Rule("rebalance_input_skew", ("read_bytes",),
         ActionKind.REBALANCE_SHARDS, scope="global",
         min_recurrence=2, recurrence_window=64, cooldown=64,
         detail="input-shard skew; split the hot shard"),
    Rule("replicate_remote_reads", ("locality",),
         ActionKind.REPLICATE_SHARDS, scope="global",
         min_recurrence=2, cooldown=64,
         detail="remote reads; cache shards on local SSD"),
    Rule("tune_router_shuffle", ("shuffle_read_bytes", "shuffle_write_bytes"),
         ActionKind.TUNE_ROUTER, scope="global",
         min_recurrence=2, cooldown=64,
         detail="shuffle skew / router imbalance; raise aux-loss or capacity"),
    Rule("pool_gc_churn", ("gc_time", "jvm_gc_time", "memory_bytes_spilled",
                           "disk_bytes_spilled"),
         ActionKind.POOL_BUFFERS, scope="global",
         min_recurrence=2, cooldown=64,
         detail="allocation churn; pool buffers"),
    Rule("backoff_sampler_gc", ("gc_time", "jvm_gc_time"),
         ActionKind.SAMPLER_BACKOFF, scope="global",
         min_severity=2, min_recurrence=1, cooldown=128,
         detail="GC churn keeps re-emerging; halve telemetry sampling rate"),
    Rule("prefetch_input_stall", ("data_load_time", "h2d_time"),
         ActionKind.DEEPEN_PREFETCH, scope="global",
         min_recurrence=2, cooldown=64,
         detail="input pipeline stalls the step; deepen prefetch"),
    Rule("async_ckpt_stall", ("ckpt_time", "d2h_time"),
         ActionKind.ASYNC_CKPT, scope="global",
         min_recurrence=2, cooldown=64,
         detail="checkpoint writes block the step; move them off-step"),
)


def forecast_rule(
    action: ActionKind = ActionKind.SPECULATE_TASK,
    *,
    name: str = "speculate_forecast",
    scope: str = "task",
    min_recurrence: int = 1,
    cooldown: int = 16,
    detail: str = "predicted straggler; act before Eq. 5 confirms",
) -> Rule:
    """A rule matching the forecaster's ``predicted_straggler`` causes.

    Forecast causes are candidates, not confirmations, so this is opt-in
    — it is NOT in :data:`DEFAULT_RULES`.  Add it to a policy when the
    forecaster's held-out precision (``repro_torch.core.forecast.
    lead_time_curve``) justifies pre-emptive action; the default pairs
    it with the cheapest reversible response (task speculation).
    """
    return Rule(name, ("predicted_straggler",), action, scope=scope,
                min_recurrence=min_recurrence, cooldown=cooldown,
                detail=detail)


@dataclass(frozen=True)
class GuardrailConfig:
    """Tunable limits of the guardrail chain (docs/operations.md has the
    tuning guidance)."""

    max_actions_per_window: int = 4   # per ActionKind, fleet-wide
    rate_window: int = 32             # steps the rate limit counts over
    min_fleet: int = 2                # never cordon below this many hosts
    flap_limit: int = 2               # cordon→rejoin cycles before damping
    flap_window: int = 512            # steps the flap counter remembers
    flap_hold: int = 256              # suppression once damped
    verify_steps: int = 8             # post-action rollback watch length
    min_improvement: float = 0.0      # required relative step-time gain
    audit_cap: int = 4096             # in-memory audit entries retained
    #: Minimum what-if recovered time (seconds) an *attributed* cause
    #: must promise before its action may reach the actuator; 0.0 (the
    #: default) disables the check, and unattributed causes always pass.
    min_recovery_s: float = 0.0


class Actuator:
    """Pluggable execution surface: the engine decides, the actuator
    does.  ``apply`` performs the action (return False to report the
    knob was unavailable — the engine records ``actuator_noop``);
    ``rollback`` reverses a previously applied action.  The base class
    applies nothing and is safe everywhere."""

    def apply(self, action: Action) -> bool:  # noqa: ARG002 — interface
        return False

    def rollback(self, action: Action) -> bool:  # noqa: ARG002
        return False


class RecordingActuator(Actuator):
    """Test/demo actuator: remembers what it was asked to do."""

    def __init__(self) -> None:
        self.applied: list[Action] = []
        self.rolled_back: list[Action] = []

    def apply(self, action: Action) -> bool:
        self.applied.append(action)
        return True

    def rollback(self, action: Action) -> bool:
        self.rolled_back.append(action)
        return True


@dataclass
class _Watch:
    """Rollback verification state for one applied action."""

    action: Action
    baseline: float            # mean step time before the action
    samples: list[float] = field(default_factory=list)


class PolicyEngine:
    """Evaluate root causes against rules each step; act through the
    actuator under the guardrail chain; audit everything.

    Call :meth:`step` once per diagnosis tick with the tick's newly
    confirmed causes (possibly empty — idle ticks still advance
    cooldowns and rollback watches).  ``step_time`` feeds the rollback
    verifier; ``live_hosts`` feeds the quorum floor (defaults to
    assuming the floor is satisfied when unknown).

    With ``dry_run=True`` the engine walks the identical decision path —
    including simulated cordon bookkeeping and rollback verdicts — but
    never touches the actuator; :meth:`decision_log_bytes` is then
    byte-identical to a live engine fed the same stream.
    """

    def __init__(
        self,
        rules: Sequence[Rule] = DEFAULT_RULES,
        actuator: Actuator | None = None,
        *,
        guardrails: GuardrailConfig = GuardrailConfig(),
        dry_run: bool = False,
        audit_path: str | None = None,
    ) -> None:
        self.rules = list(rules)
        self.actuator = actuator if actuator is not None else Actuator()
        self.guardrails = guardrails
        self.dry_run = dry_run
        self.audit: deque[dict] = deque(maxlen=guardrails.audit_cap)
        self._audit_file = open(audit_path, "a") if audit_path else None
        self._seq = 0
        self._actuate_seq = 0
        self.steps = 0
        self.cordoned: set[str] = set()
        # (rule, target) → recent matching-cause steps (recurrence count)
        self._recurrence: dict[tuple[str, str], deque[int]] = {}
        # Rate-limit / cooldown state is keyed by the ActionKind's *value
        # string*, not the enum: Enum.__hash__ is a Python-level call and
        # these dicts are hit hundreds of times per tick at fleet scale.
        # kind value → recent acted steps (rate limit)
        self._recent: dict[str, deque[int]] = {}
        # (kind value, target) → last acted step (cooldown)
        self._last: dict[tuple[str, str], int] = {}
        # Per-tick veto caches, cleared every step().  Cooldown and
        # rate-limit state can only tighten within one tick (a vetoed
        # pair cannot commit again), so their veto strings are safe to
        # reuse for repeat offenders — the common case when one global
        # rule matches hundreds of causes in a single sweep.
        self._veto_cache: dict[tuple[str, str], tuple[str, str]] = {}
        self._rate_veto: dict[str, tuple[str, str]] = {}
        # host → recent flap steps (cordon→rejoin cycles)
        self._flaps: dict[str, deque[int]] = {}
        self._flap_hold_until: dict[str, int] = {}
        self._watches: list[_Watch] = []
        self._step_times: deque[float] = deque(maxlen=max(
            guardrails.verify_steps, 1))
        # feature → [(rule, action value str, scope)], precomputed: the
        # per-step hot path is a dict hit per cause, not a scan over the
        # rule list, and Enum .value is a DynamicClassAttribute property —
        # measurably slow at 16k-host cause volume.
        self._by_feature: dict[str, list[tuple[Rule, str, str]]] = {}
        self._any_feature: list[tuple[Rule, str, str]] = []
        for r in self.rules:
            triple = (r, r.action.value, r.scope)
            if ANY_FEATURE in r.features:
                self._any_feature.append(triple)
                continue
            for f in r.features:
                self._by_feature.setdefault(f, []).append(triple)
        # Horizons for the periodic bookkeeping sweep: task-scoped rules
        # key state by task id, which is unbounded in an always-on loop
        # (the MitigationPlanner.applied leak, same class) — entries
        # older than every window they can still influence are dropped.
        self._max_recurrence_window = max(
            (r.recurrence_window for r in self.rules), default=0)
        self._max_cooldown = max((r.cooldown for r in self.rules), default=0)
        # lifetime counters (cheap observability)
        self.applied_count = 0
        self.suppressed_count = 0
        self.rolled_back_count = 0

    # -- audit -------------------------------------------------------------
    def _log(self, typ: str, **fields) -> dict:
        # Actuator-call entries number from their own counter: they only
        # exist in live mode, and sharing the counter would shift every
        # later decision's seq and break dry-run byte-equivalence.
        if typ == "actuate":
            seq = self._actuate_seq
            self._actuate_seq += 1
        else:
            seq = self._seq
            self._seq += 1
        entry = {"seq": seq, "step": self.steps, "type": typ, **fields}
        self._append(entry)
        return entry

    def _append(self, entry: dict) -> None:
        self.audit.append(entry)
        if self._audit_file is not None:
            self._audit_file.write(
                json.dumps(entry, sort_keys=False, default=str) + "\n")
            self._audit_file.flush()

    def decision_log(self) -> list[dict]:
        """All retained audit entries except actuator-call results —
        the part of the log that must match between ``dry_run`` and
        live over the same input stream."""
        return [e for e in self.audit if e["type"] != "actuate"]

    def decision_log_bytes(self) -> bytes:
        return b"\n".join(
            json.dumps(e, sort_keys=True, default=str).encode()
            for e in self.decision_log()
        )

    def close(self) -> None:
        if self._audit_file is not None:
            self._audit_file.close()
            self._audit_file = None

    # -- the per-tick entry point -----------------------------------------
    def step(
        self,
        causes: Iterable[RootCause] = (),
        *,
        step_time: float | None = None,
        live_hosts: int | None = None,
    ) -> list[Action]:
        """One policy tick: verify pending watches against ``step_time``,
        then evaluate this tick's causes.  Returns the actions that
        passed every guardrail this tick (in dry-run they are decisions,
        not actuations)."""
        self.steps += 1
        if self.steps % 256 == 0:
            self._gc()
        if step_time is not None:
            self._verify_watches(step_time)
            self._step_times.append(step_time)
        if self._veto_cache:
            self._veto_cache.clear()
        if self._rate_veto:
            self._rate_veto.clear()
        acted: list[Action] = []
        causes = list(causes)
        if any(c.attribution is not None for c in causes):
            # Recovery ranking: highest priced recovery first, severity
            # as tie-break.  Only entered when attribution is actually
            # present — an unattributed stream is never reordered, so
            # its decision log stays byte-identical to the
            # pre-attribution engine's.
            causes.sort(key=lambda c: (
                -(c.attribution.cumulative_recovery_s
                  if c.attribution is not None else 0.0),
                -c.severity,
            ))
        by_feature = self._by_feature
        any_feature = self._any_feature
        evaluate = self._evaluate
        for cause in causes:
            rules = by_feature.get(cause.feature, ())
            for rule, kind_value, scope in rules:
                a = evaluate(rule, kind_value, scope, cause, live_hosts)
                if a is not None:
                    acted.append(a)
            for rule, kind_value, scope in any_feature:
                a = evaluate(rule, kind_value, scope, cause, live_hosts)
                if a is not None:
                    acted.append(a)
        return acted

    def note_rejoin(self, host: str) -> None:
        """Tell the engine a cordoned host rejoined outside its control
        (operator action, lease rejoin): charges a flap so an oscillating
        host eventually hits the damping hold."""
        if host in self.cordoned:
            self.cordoned.discard(host)
            self._charge_flap(host)
            self._log("rejoin", target=host)

    # -- evaluation --------------------------------------------------------
    def _evaluate(self, rule: Rule, kind_value: str, scope: str,
                  cause: RootCause,
                  live_hosts: int | None) -> Action | None:
        if cause.severity < rule.min_severity:
            return None
        steps = self.steps
        if scope == "host":
            target = cause.node
        elif scope == "task":
            target = cause.task_id
        else:
            target = "-"
        key = (rule.name, target)
        seen = self._recurrence.get(key)
        if seen is None:
            seen = self._recurrence[key] = deque()
        # Count distinct diagnosis ticks, not causes: ten stragglers in
        # one noisy window are one sighting, not ten.
        if not seen or seen[-1] != steps:
            seen.append(steps)
        while seen and steps - seen[0] > rule.recurrence_window:
            seen.popleft()
        # Decision entries are built as one literal each (not through
        # :meth:`_log`'s kwargs merge) — this is the per-cause hot path
        # of a 16k-host sweep.  Key order must stay identical to _log's.
        if len(seen) < rule.min_recurrence:
            seq = self._seq
            self._seq = seq + 1
            self._append({
                "seq": seq, "step": steps, "type": "decision",
                "verdict": "defer", "guardrail": "recurrence",
                "detail": f"{len(seen)}/{rule.min_recurrence} in "
                          f"{rule.recurrence_window} steps",
                "rule": rule.name, "action": kind_value, "target": target,
                "cause": [cause.task_id, cause.feature],
                "severity": cause.severity})
            return None
        guardrail = self._guardrail_veto(rule, kind_value, target, live_hosts,
                                         cause)
        if guardrail is not None:
            self.suppressed_count += 1
            seq = self._seq
            self._seq = seq + 1
            self._append({
                "seq": seq, "step": steps, "type": "decision",
                "verdict": "suppress", "guardrail": guardrail[0],
                "detail": guardrail[1],
                "rule": rule.name, "action": kind_value, "target": target,
                "cause": [cause.task_id, cause.feature],
                "severity": cause.severity})
            return None
        action = Action(kind=rule.action, target=target, rule=rule.name,
                        cause_key=cause.key, step=self.steps,
                        detail=rule.detail)
        self._commit(action)
        self._log("decision", verdict="act", guardrail=None,
                  detail=rule.detail, rule=rule.name, action=kind_value,
                  target=target, cause=[cause.task_id, cause.feature],
                  severity=cause.severity)
        if not self.dry_run:
            # An actuator failure must not kill the diagnosis loop the
            # engine runs inside of: log it and move on.
            try:
                ok = bool(self.actuator.apply(action))
                outcome = "applied" if ok else "actuator_noop"
            except Exception as e:  # noqa: BLE001 — actuation boundary
                ok = False
                outcome = f"actuator_error:{type(e).__name__}"
            self._log("actuate", action=kind_value, target=target,
                      rule=rule.name, outcome=outcome)
            self.applied_count += ok
        return action

    def _guardrail_veto(self, rule: Rule, kind_value: str, target: str,
                        live_hosts: int | None,
                        cause: RootCause) -> tuple[str, str] | None:
        """First guardrail that vetoes ``(rule.action, target)``, or None.
        Checked in a fixed order so audit logs are stable.  The recovery
        budget runs last and is never cached: two causes sharing a
        (rule, target) can carry different priced recoveries."""
        g = self.guardrails
        # Cooldown is per (rule, target) — two rules may share an action
        # kind but not a cooldown — so its cache key is the rule name.
        cool_key = (rule.name, target)
        veto = self._veto_cache.get(cool_key)
        if veto is not None:
            return veto
        last = self._last.get((kind_value, target))
        if last is not None and self.steps - last < rule.cooldown:
            veto = ("cooldown",
                    f"acted at step {last}, cooldown {rule.cooldown}")
            self._veto_cache[cool_key] = veto
            return veto
        recent = self._recent.get(kind_value)
        if recent is not None:
            veto = self._rate_veto.get(kind_value)
            if veto is not None:
                return veto
            while recent and self.steps - recent[0] > g.rate_window:
                recent.popleft()
            if len(recent) >= g.max_actions_per_window:
                veto = ("rate_limit",
                        f"{len(recent)} {kind_value} "
                        f"actions in the last {g.rate_window} steps "
                        f"(max {g.max_actions_per_window})")
                self._rate_veto[kind_value] = veto
                return veto
        if rule.action is ActionKind.CORDON_HOST:
            if target in self.cordoned:
                return ("already_cordoned", f"{target} is already out")
            hold = self._flap_hold_until.get(target)
            if hold is not None and self.steps < hold:
                return ("flap_damping",
                        f"{target} flapped; held until step {hold}")
            if live_hosts is not None:
                remaining = live_hosts - 1
                if remaining < g.min_fleet:
                    return ("min_fleet",
                            f"cordon would leave {remaining} < "
                            f"min_fleet={g.min_fleet} hosts")
        if g.min_recovery_s > 0.0 and cause.attribution is not None:
            recovery = cause.attribution.cumulative_recovery_s
            if recovery < g.min_recovery_s:
                return ("min_recovery",
                        f"estimated recovery {recovery:.3f}s < "
                        f"min_recovery_s={g.min_recovery_s:.3f}s")
        return None

    def _commit(self, action: Action) -> None:
        """State transitions for an action that passed the chain —
        identical in dry-run, which is what keeps its decision stream
        byte-compatible with a live engine."""
        kind_value = action.kind.value
        self._last[(kind_value, action.target)] = self.steps
        self._recent.setdefault(kind_value, deque()).append(self.steps)
        if action.kind is ActionKind.CORDON_HOST:
            self.cordoned.add(action.target)
        if action.kind is ActionKind.UNCORDON_HOST:
            self.cordoned.discard(action.target)
        if action.kind in REVERSIBLE and self._step_times:
            baseline = sum(self._step_times) / len(self._step_times)
            self._watches.append(_Watch(action=action, baseline=baseline))

    # -- rollback ----------------------------------------------------------
    def _verify_watches(self, step_time: float) -> None:
        g = self.guardrails
        still: list[_Watch] = []
        for w in self._watches:
            w.samples.append(step_time)
            if len(w.samples) < g.verify_steps:
                still.append(w)
                continue
            post = sum(w.samples) / len(w.samples)
            improved = post <= w.baseline * (1.0 - g.min_improvement)
            if improved:
                self._log("verify", verdict="kept",
                          action=w.action.kind.value, target=w.action.target,
                          baseline=round(w.baseline, 6),
                          post=round(post, 6))
                continue
            self.rolled_back_count += 1
            self._log("verify", verdict="rolled_back",
                      action=w.action.kind.value, target=w.action.target,
                      baseline=round(w.baseline, 6), post=round(post, 6),
                      detail="no step-time improvement in "
                             f"{g.verify_steps} steps")
            if w.action.kind is ActionKind.CORDON_HOST:
                self.cordoned.discard(w.action.target)
                self._charge_flap(w.action.target)
            if not self.dry_run:
                try:
                    ok = bool(self.actuator.rollback(w.action))
                    outcome = "rolled_back" if ok else "rollback_noop"
                except Exception as e:  # noqa: BLE001 — actuation boundary
                    outcome = f"rollback_error:{type(e).__name__}"
                self._log("actuate", action=w.action.kind.value,
                          target=w.action.target, rule=w.action.rule,
                          outcome=outcome)
        self._watches = still

    def _charge_flap(self, host: str) -> None:
        g = self.guardrails
        flaps = self._flaps.setdefault(host, deque())
        flaps.append(self.steps)
        while flaps and self.steps - flaps[0] > g.flap_window:
            flaps.popleft()
        if len(flaps) >= g.flap_limit:
            self._flap_hold_until[host] = self.steps + g.flap_hold
            self._log("guardrail", guardrail="flap_damping", target=host,
                      detail=f"{len(flaps)} flaps in {g.flap_window} steps; "
                             f"cordon held for {g.flap_hold} steps")

    def _gc(self) -> None:
        """Drop per-target bookkeeping that can no longer influence any
        decision (task-scoped rules key state by task id — unbounded in
        an always-on loop without this sweep)."""
        now = self.steps
        stale = [k for k, d in self._recurrence.items()
                 if not d or now - d[-1] > self._max_recurrence_window]
        for k in stale:
            del self._recurrence[k]
        stale_last = [k for k, s in self._last.items()
                      if now - s > self._max_cooldown]
        for k in stale_last:
            del self._last[k]
        g = self.guardrails
        stale_flaps = [h for h, d in self._flaps.items()
                       if not d or now - d[-1] > g.flap_window]
        for h in stale_flaps:
            del self._flaps[h]
        expired_holds = [h for h, s in self._flap_hold_until.items()
                         if now >= s]
        for h in expired_holds:
            del self._flap_hold_until[h]

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        return {
            "steps": self.steps,
            "applied": self.applied_count,
            "suppressed": self.suppressed_count,
            "rolled_back": self.rolled_back_count,
            "cordoned": sorted(self.cordoned),
            "audit_entries": self._seq + self._actuate_seq,
        }
