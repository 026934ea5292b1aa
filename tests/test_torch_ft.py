"""Fault tolerance: ``repro_torch.ft`` (and the closed-loop A/B of
``repro_torch.anomaly.loop``) against ``repro.ft``.

Every case of the reference's ``test_ft.py`` except the supervisor's
(its backoff cases run on the port in ``test_torch_ckpt_data.py``) runs
here on both packages with the same inputs: the port must take the same actions and
write the same audit JSON, byte for byte, and the reference's own
assertions are checked on the port's result.  The A/B runs its analyzers
on ``device="cpu"``.
"""
from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

import repro.anomaly as ref_anomaly
import repro.core as ref_core
import repro.ft as ref_ft
import repro.serve.fleet as ref_fleet
import repro.telemetry.events as ref_events
import repro_torch.anomaly as port_anomaly
import repro_torch.core as port_core
import repro_torch.ft as port_ft
import repro_torch.serve.fleet as port_fleet
import repro_torch.telemetry.events as port_events

REF = SimpleNamespace(core=ref_core, ft=ref_ft, fleet=ref_fleet,
                      events=ref_events, anomaly=ref_anomaly, kw={})
PORT = SimpleNamespace(core=port_core, ft=port_ft, fleet=port_fleet,
                       events=port_events, anomaly=port_anomaly,
                       kw={"device": "cpu"})


def both(fn, *args, **kwargs):
    """``fn`` on the port and on the reference; their observations must be
    equal.  Returns the port's."""
    got = fn(PORT, *args, **kwargs)
    want = fn(REF, *args, **kwargs)
    assert got == want
    return got


def cause(p, task="s0/t0", node="slave1", feature="cpu", severity=1):
    return p.core.RootCause(
        task_id=task, stage_id="s0", node=node, feature=feature,
        kind=p.core.FeatureKind.RESOURCE, value=2.0, peer_groups=("inter",),
        severity=severity,
    )


def actions(acts) -> list[tuple]:
    return [(a.kind.value, a.target, a.rule, a.cause_key, a.step, a.detail)
            for a in acts]


def seen(eng) -> dict:
    """What an engine did, in comparable form: its audit JSON, what its
    actuator applied and rolled back, its counters and cordons."""
    act = eng.actuator
    return {
        "log": eng.decision_log_bytes(),
        "audit": json.dumps(list(eng.audit), sort_keys=True),
        "applied": actions(getattr(act, "applied", [])),
        "rolled_back": actions(getattr(act, "rolled_back", [])),
        "counts": (eng.applied_count, eng.suppressed_count,
                   eng.rolled_back_count),
        "cordoned": sorted(eng.cordoned),
    }


def engine(p, rules=None, **gkw):
    g = p.ft.GuardrailConfig(**gkw) if gkw else p.ft.GuardrailConfig()
    return p.ft.PolicyEngine(rules or p.ft.DEFAULT_RULES,
                             p.ft.RecordingActuator(), guardrails=g)


# -- ft.elastic ----------------------------------------------------------------

def plan_fields(plan) -> tuple:
    return (plan.new_shape, plan.dropped_hosts, plan.chips_idle,
            plan.axis_names)


def test_reshard_drops_data_rows_keeps_model_axis():
    got = both(lambda p: plan_fields(p.ft.reshard_plan(
        (4, 16), ["h0", "h1", "h2"], ["h0", "h1", "h2", "h3"],
        chips_per_host=16)))
    assert got[:3] == ((3, 16), ("h3",), 0)


def test_reshard_pod_axis_preserved():
    hosts = [f"h{i}" for i in range(8)]
    got = both(lambda p: plan_fields(p.ft.reshard_plan(
        (2, 4, 16), hosts[:6], hosts, chips_per_host=32,
        axis_names=("pod", "data", "model"))))
    assert got[0][0] == 2 and got[0][2] == 16
    assert got[3] == ("pod", "data", "model")


def test_reshard_idle_chip_accounting():
    got = both(lambda p: plan_fields(p.ft.reshard_plan(
        (4, 16), ["h0", "h1", "h2"], ["h0", "h1", "h2", "h3"],
        chips_per_host=20)))
    assert got[2] == 3 * 20 - got[0][0] * got[0][1] > 0


@pytest.mark.parametrize("call", [
    lambda p: p.ft.plan_mesh_shape(8, model_axis=16),
    lambda p: p.ft.reshard_plan((2, 16), ["h0"], ["h0", "h1"],
                                chips_per_host=8),
    lambda p: p.ft.plan_mesh_shape(16, model_axis=16, pod_axis=2),
])
def test_not_enough_chips_raises(call):
    for p in (PORT, REF):
        with pytest.raises(ValueError):
            call(p)


# -- ft.heartbeat --------------------------------------------------------------

def detector_view(det) -> tuple:
    return det.last_beats(), det.alive(), det.dead()


def test_missing_directory_is_empty_not_error(tmp_path):
    got = both(lambda p: detector_view(
        p.ft.FailureDetector(str(tmp_path / "nope"))))
    assert got == ({}, [], [])


def test_malformed_and_foreign_files_skipped(tmp_path):
    (tmp_path / "h0.hb").write_text("garbage")
    (tmp_path / "notes.txt").write_text("123.0")
    (tmp_path / "h1.hb").write_text("50.0")
    got = both(lambda p: detector_view(p.ft.FailureDetector(
        str(tmp_path), timeout=5.0, clock=lambda: 52.0)))
    assert got == ({"h1": 50.0}, ["h1"], [])


def test_exact_timeout_boundary_is_alive(tmp_path):
    (tmp_path / "h0.hb").write_text("10.0")

    def run(p):
        det = p.ft.FailureDetector(str(tmp_path), timeout=5.0,
                                   clock=lambda: 15.0)
        at = (det.alive(), det.dead())
        det.clock = lambda: 15.001
        return at, (det.alive(), det.dead())

    assert both(run) == ((["h0"], []), ([], ["h0"]))


def test_writer_beats_and_detector_sees_them(tmp_path):
    def run(p):
        d = tmp_path / p.ft.__name__
        t = [100.0]
        w = p.ft.HeartbeatWriter(str(d), "h0", interval=60.0,
                                 clock=lambda: t[0])
        w.beat()
        det = p.ft.FailureDetector(str(d), timeout=5.0, clock=lambda: t[0])
        out = [det.alive()]
        t[0] = 200.0
        out.append(det.dead())
        w.beat()
        out.append(det.alive())
        return out

    assert both(run) == [["h0"], ["h0"], ["h0"]]


# -- ft.mitigation ---------------------------------------------------------------

@pytest.mark.parametrize("cap,steps,want", [(64, 2000, 64),
                                            (None, 300, 300)])
def test_planner_applied_is_bounded(cap, steps, want):
    def run(p):
        planner = p.ft.MitigationPlanner(applied_cap=cap)
        plans = [planner.plan([cause(p, task=f"s0/t{s}", feature="gc_time")])
                 for s in range(steps)]
        return len(planner.applied), [
            [(a.action.value, a.target, a.evidence, a.detail) for a in plan]
            for plan in plans[:5]]

    got = both(run)
    assert got[0] == want


# -- ft.policy: guardrails -----------------------------------------------------

def test_recurrence_defers_single_sighting():
    def run(p):
        eng = engine(p)
        acted = eng.step([cause(p)], live_hosts=6)
        return actions(acted), seen(eng)

    acted, eng = both(run)
    kinds = {a[0] for a in acted}
    assert "speculate_task" in kinds and "cordon_host" not in kinds
    log = [json.loads(ln) for ln in eng["log"].splitlines()]
    defers = [e for e in log if e.get("guardrail") == "recurrence"]
    assert defers and defers[0]["verdict"] == "defer"


def test_cordon_after_recurrence_and_cooldown_suppresses():
    def run(p):
        eng = engine(p)
        eng.step([cause(p)], live_hosts=6)
        acted = eng.step([cause(p, task="s0/t1")], live_hosts=6)
        mid = sorted(eng.cordoned)
        eng.step([cause(p, task="s0/t2")], live_hosts=6)
        return actions(acted), mid, seen(eng)

    acted, mid, eng = both(run)
    assert any(a[0] == "cordon_host" for a in acted) and "slave1" in mid
    sup = [e for e in map(json.loads, eng["log"].splitlines())
           if e.get("verdict") == "suppress"]
    assert any(e["guardrail"] == "cooldown" for e in sup)


def test_already_cordoned_suppression():
    def run(p):
        rules = [p.ft.Rule("cordon", ("cpu",), p.ft.ActionKind.CORDON_HOST,
                           min_recurrence=1, cooldown=2)]
        eng = p.ft.PolicyEngine(rules, p.ft.RecordingActuator())
        eng.step([cause(p)], live_hosts=6)
        eng.step([], live_hosts=6)
        eng.step([], live_hosts=6)
        acted = eng.step([cause(p, task="s0/t9")], live_hosts=6)
        return actions(acted), seen(eng)

    acted, eng = both(run)
    assert acted == []
    sup = [e for e in map(json.loads, eng["log"].splitlines())
           if e.get("verdict") == "suppress"]
    assert sup[-1]["guardrail"] == "already_cordoned"


def test_rate_limit_suppression_visible_in_audit():
    def run(p):
        rules = [p.ft.Rule("spec", ("cpu",), p.ft.ActionKind.SPECULATE_TASK,
                           scope="task", cooldown=1)]
        eng = engine(p, rules, max_actions_per_window=2, rate_window=32)
        causes = [cause(p, task=f"s0/t{i}", node=f"n{i}") for i in range(5)]
        return actions(eng.step(causes, live_hosts=6)), seen(eng)

    acted, eng = both(run)
    assert len(acted) == 2 and len(eng["applied"]) == 2
    limited = [e for e in map(json.loads, eng["log"].splitlines())
               if e.get("guardrail") == "rate_limit"]
    assert len(limited) == 3
    assert all(e["verdict"] == "suppress" for e in limited)
    assert eng["counts"][1] == 3


def test_min_fleet_floor_refuses_cordon():
    def run(p):
        rules = [p.ft.Rule("cordon", ("cpu",), p.ft.ActionKind.CORDON_HOST,
                           min_recurrence=1)]
        eng = engine(p, rules, min_fleet=2)
        first = actions(eng.step([cause(p)], live_hosts=2))
        second = actions(eng.step([cause(p)], live_hosts=6))
        return first, second, seen(eng)

    first, second, eng = both(run)
    assert first == [] and [a[0] for a in second] == ["cordon_host"]
    floor = [e for e in map(json.loads, eng["log"].splitlines())
             if e.get("guardrail") == "min_fleet"]
    assert len(floor) == 1 and "min_fleet=2" in floor[0]["detail"]


def test_flap_damping_holds_oscillating_host():
    def run(p):
        rules = [p.ft.Rule("cordon", ("cpu",), p.ft.ActionKind.CORDON_HOST,
                           min_recurrence=1, cooldown=1)]
        eng = engine(p, rules, flap_limit=2, flap_window=512, flap_hold=100)
        out = []
        for _ in range(2):   # cordon → rejoin, twice
            eng.step([cause(p)], live_hosts=6)
            out.append("slave1" in eng.cordoned)
            eng.note_rejoin("slave1")
        out.append("slave1" in eng.cordoned)
        return out, actions(eng.step([cause(p)], live_hosts=6)), seen(eng)

    flags, acted, eng = both(run)
    assert flags == [True, True, False] and acted == []
    assert any(e.get("guardrail") == "flap_damping"
               for e in map(json.loads, eng["log"].splitlines()))


@pytest.mark.parametrize("after,rolled_back", [(1.2, True), (0.5, False)])
def test_rollback_verdict_follows_step_time(after, rolled_back):
    def run(p):
        rules = [p.ft.Rule("cordon", ("cpu",), p.ft.ActionKind.CORDON_HOST,
                           min_recurrence=1, cooldown=1000)]
        eng = p.ft.PolicyEngine(
            rules, p.ft.RecordingActuator(),
            guardrails=p.ft.GuardrailConfig(verify_steps=3))
        for _ in range(3):
            eng.step([], step_time=1.0)        # establish the baseline
        eng.step([cause(p)], step_time=1.0, live_hosts=6)
        cordoned = "slave1" in eng.cordoned
        for _ in range(3):
            eng.step([], step_time=after)
        return cordoned, seen(eng)

    cordoned, eng = both(run)
    assert cordoned
    if rolled_back:
        assert eng["counts"][2] == 1
        assert [a[0] for a in eng["rolled_back"]] == ["cordon_host"]
        assert "slave1" not in eng["cordoned"]
        verdicts = [e for e in map(json.loads, eng["log"].splitlines())
                    if e["type"] == "verify"]
        assert verdicts[-1]["verdict"] == "rolled_back"
    else:
        assert eng["counts"][2] == 0 and eng["rolled_back"] == []
        assert "slave1" in eng["cordoned"]


def test_actuator_exception_logged_not_raised():
    class Exploding:
        def apply(self, action):
            raise OSError("knob fell off")

        def rollback(self, action):
            return True

    def run(p):
        rules = [p.ft.Rule("spec", ("cpu",), p.ft.ActionKind.SPECULATE_TASK,
                           scope="task")]
        eng = p.ft.PolicyEngine(rules, Exploding())
        eng.step([cause(p)], live_hosts=6)   # must not raise
        return ([e["outcome"] for e in eng.audit if e["type"] == "actuate"],
                eng.applied_count, eng.decision_log_bytes())

    outcomes, applied, _ = both(run)
    assert outcomes == ["actuator_error:OSError"] and applied == 0


def test_per_target_state_is_gc_swept():
    def run(p):
        rules = [p.ft.Rule("spec", ("cpu",), p.ft.ActionKind.SPECULATE_TASK,
                           scope="task", recurrence_window=16, cooldown=4)]
        eng = p.ft.PolicyEngine(rules, p.ft.RecordingActuator())
        for step in range(4096):
            eng.step([cause(p, task=f"s0/t{step}")])
        return len(eng._recurrence), len(eng._last), seen(eng)

    recurrence, last, _ = both(run)
    assert recurrence < 1024 and last < 1024


# -- ft.policy: dry run ----------------------------------------------------------

def feed(p, eng):
    for step in range(40):
        tick = []
        if step % 3 == 0:
            tick.append(cause(p, task=f"s0/t{step}"))
        if step % 7 == 0:
            tick.append(cause(p, task=f"s1/t{step}", node="slave2",
                              feature="gc_time", severity=2))
        eng.step(tick, step_time=1.0 + 0.01 * (step % 5), live_hosts=6)


def test_dry_run_decisions_byte_identical_zero_actuations():
    def run(p):
        live = p.ft.PolicyEngine(p.ft.DEFAULT_RULES, p.ft.RecordingActuator())
        dry = p.ft.PolicyEngine(p.ft.DEFAULT_RULES, p.ft.RecordingActuator(),
                                dry_run=True)
        feed(p, live)
        feed(p, dry)
        return seen(live), seen(dry)

    live, dry = both(run)
    assert live["log"] == dry["log"]
    assert dry["applied"] == [] and dry["rolled_back"] == []
    assert dry["counts"][0] == 0 and live["applied"] != []


def test_audit_file_is_append_only_jsonl(tmp_path):
    def run(p):
        path = tmp_path / f"{p.ft.__name__}.jsonl"
        eng = p.ft.PolicyEngine(p.ft.DEFAULT_RULES, p.ft.RecordingActuator(),
                                audit_path=str(path))
        feed(p, eng)
        eng.close()
        return path.read_text()

    text = both(run)
    entries = [json.loads(ln) for ln in text.splitlines()]
    assert entries
    seqs = [e["seq"] for e in entries if e["type"] != "actuate"]
    assert seqs == list(range(len(seqs)))
    assert any(e.get("verdict") == "suppress" for e in entries)


# -- ft.policy: rules ------------------------------------------------------------

def test_load_policy_roundtrip(tmp_path):
    path = tmp_path / "policy.json"
    path.write_text(json.dumps({"rules": [
        {"name": "my_cordon", "features": ["cpu", "disk"],
         "action": "cordon_host", "min_recurrence": 3, "cooldown": 100},
        {"name": "my_page", "features": ["host_dropout"],
         "action": "page_operator", "scope": "host", "min_severity": 2},
    ]}))

    def run(p):
        return [(r.name, r.features, r.action.value, r.scope,
                 r.min_severity, r.min_recurrence, r.recurrence_window,
                 r.cooldown) for r in p.ft.load_policy(str(path))]

    rules = both(run)
    assert [r[0] for r in rules] == ["my_cordon", "my_page"]
    assert rules[0][2] == "cordon_host" and rules[0][5] == 3
    assert rules[1][4] == 2


@pytest.mark.parametrize("kw", [dict(scope="galaxy"),
                                dict(min_recurrence=0)])
def test_bad_rule_rejected(kw):
    for p in (PORT, REF):
        with pytest.raises(ValueError):
            p.ft.Rule("r", ("cpu",), p.ft.ActionKind.CORDON_HOST, **kw)


def test_severity_gate():
    def run(p):
        rules = [p.ft.Rule("page", ("host_dropout",),
                           p.ft.ActionKind.PAGE_OPERATOR, min_severity=2)]
        eng = p.ft.PolicyEngine(rules, p.ft.RecordingActuator())
        low = eng.step([cause(p, feature="host_dropout", severity=1)])
        high = eng.step([cause(p, feature="host_dropout", severity=2)])
        return actions(low), actions(high), seen(eng)

    low, high, _ = both(run)
    assert low == [] and [a[0] for a in high] == ["page_operator"]


def test_forecast_rule_matches_predicted_causes():
    def run(p):
        rule = p.ft.forecast_rule()
        eng = p.ft.PolicyEngine((*p.ft.DEFAULT_RULES, rule),
                                p.ft.RecordingActuator(),
                                guardrails=p.ft.GuardrailConfig())
        c = p.core.synthesize_cause(
            task_id="s0/t1", stage_id="s0", node="n0",
            feature=p.core.forecast.PREDICTED_STRAGGLER, value=0.91,
            guidance="forecast", peer_groups=("forecast",))
        eng.step([c], step_time=1.0, live_hosts=8)
        return rule.features, seen(eng)

    features, eng = both(run)
    assert features == ("predicted_straggler",)
    acted = [a for a in eng["applied"] if a[2] == "speculate_forecast"]
    assert len(acted) == 1 and acted[0][1] == "s0/t1"


# -- fleet wiring: the aggregator ticks the policy and reports rejoins -----------

class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def test_dropout_cause_cordons_and_rejoin_charges_flap():
    def run(p):
        def delta(host, seq, t, n=8):
            return p.events.StepDelta(host, seq, [p.events.StageDelta(
                "s0", [f"{host}/t{seq}-{i}" for i in range(n)], [host] * n,
                np.full(n, float(t)), np.full(n, float(t) + 1.0),
                np.zeros(n, np.int16),
                {"cpu": np.full(n, 0.2)}, {"cpu": np.ones(n, bool)})],
                boot=1)

        clock = FakeClock()
        pol = p.ft.PolicyEngine(p.ft.DEFAULT_RULES, p.ft.RecordingActuator(),
                                guardrails=p.ft.GuardrailConfig(min_fleet=1))
        agg = p.fleet.FleetAggregator(
            p.core.JAX_FEATURES,
            p.core.BigRootsAnalyzer(p.core.JAX_FEATURES, **p.kw),
            lease=5.0, clock=clock, policy=pol,
        )
        for step in range(3):
            clock.t = float(step)
            for h in ("h0", "h1", "h2"):
                agg.ingest(delta(h, step + 1, step))
            agg.step(step_time=1.0)
        clock.t = 20.0     # h1 goes dark past its lease
        agg.ingest(delta("h0", 4, 3))
        agg.ingest(delta("h2", 4, 3))
        agg.step(step_time=1.0)
        dark = sorted(pol.cordoned)
        agg.ingest(delta("h1", 9, 21))   # h1 reports again
        return dark, agg.host_rejoins, seen(pol)

    dark, rejoins, pol = both(run)
    assert "h1" in dark
    assert "cordon_host" in [a[0] for a in pol["applied"]]
    assert rejoins == 1 and "h1" not in pol["cordoned"]
    rejoined = [e for e in map(json.loads, pol["log"].splitlines())
                if e["type"] == "rejoin"]
    assert rejoined and rejoined[0]["target"] == "h1"


# -- the closed-loop A/B: acting on causes recovers step time --------------------

def loop_view(res) -> dict:
    return {
        "stage_times": res.stage_times,
        "causes_per_stage": res.causes_per_stage,
        "actions": actions(res.actions),
        "speculated": res.speculated,
        "cordoned": res.cordoned,
        "job_duration": res.job_duration,
        "engine": seen(res.engine),
    }


def ab(p, scenario, **kw):
    r = p.anomaly.ab_compare(scenario, **kw, **p.kw)
    return {"mitigated": loop_view(r.mitigated),
            "baseline": loop_view(r.baseline), "improvement": r.improvement,
            "dry": (r.baseline.engine.dry_run, r.mitigated.engine.dry_run)}


@pytest.mark.parametrize("scenario", ["cpu", "skew"])
def test_mitigated_beats_diagnose_only(scenario):
    got = both(ab, scenario, seed=0, stages=10)
    m, b = got["mitigated"], got["baseline"]
    assert sum(m["stage_times"]) < sum(b["stage_times"])
    assert got["improvement"] > 0.05
    assert got["dry"] == (True, False)
    assert b["engine"]["applied"] == [] and m["actions"] != []


def test_audit_log_deterministic_under_fixed_seed():
    a = both(ab, "cpu", seed=1, stages=8)
    assert ab(PORT, "cpu", seed=1, stages=8) == a


def test_ab_arms_decide_identically():
    got = both(ab, "gc", seed=0, stages=8)
    live, dry = (
        [json.loads(ln) for ln in got[arm]["engine"]["log"].splitlines()]
        for arm in ("mitigated", "baseline"))
    first_live = next(e for e in live if e.get("verdict") == "act")
    first_dry = next(e for e in dry if e.get("verdict") == "act")
    for k in ("rule", "action", "verdict"):
        assert first_live[k] == first_dry[k]


@pytest.mark.parametrize("scenario", ["disk", "network"])
def test_other_incident_classes_match_the_reference(scenario):
    both(ab, scenario, seed=2, stages=6)


def test_whatif_recovery_matches_the_reference():
    got = both(lambda p: p.anomaly.loop.whatif_recovery(
        "cpu", seed=0, stages=6, **p.kw))
    assert got > 0.0


def test_no_supervisor_yet():
    """Since the training slice (``repro_torch.ckpt``) the port's ``ft``
    exports the supervisor too: the reference's names, all of them."""
    assert port_ft.Supervisor.__module__ == "repro_torch.ft.supervisor"
    assert set(port_ft.__all__) == set(ref_ft.__all__)
