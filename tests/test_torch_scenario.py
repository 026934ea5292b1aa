"""The fleet scenario engine end to end: ``repro_torch.anomaly.scenario``
against the goldens the JAX package pinned.

Every library scenario drives the port's whole diagnosis stack (wire
telemetry, transport, tree and star aggregation, ``analyze_fleet`` with
the gate kernel's plain version on ``device="cpu"``, the policy engine)
and must reproduce ``tests/golden/scenario_<name>.golden`` byte for
byte; the two pinned episode exports must reproduce
``episodes_<name>.golden``.  The engine's contracts from the reference's
``test_scenario.py`` (same-seed replay, script round trip, host-count
scaling) are held on the port, and one scenario outside the library is
held to the reference's own run.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.anomaly.scenario as ref_scenario
import repro_torch.anomaly.scenario as port_scenario
from repro_torch.anomaly.scenario import (
    EPISODE_PINS,
    SCENARIO_LIBRARY,
    Scenario,
    build_scenario,
    export_episodes,
    run_scenario,
)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def library_results():
    return {name: run_scenario(name, **CPU) for name in SCENARIO_LIBRARY}


@pytest.mark.parametrize("name", sorted(SCENARIO_LIBRARY))
def test_scenario_matches_pinned_golden(name, library_results):
    want = (GOLDEN / f"scenario_{name}.golden").read_bytes()
    assert library_results[name].golden_bytes() == want


@pytest.mark.parametrize("name", sorted(SCENARIO_LIBRARY))
def test_rows_conserve(name, library_results):
    c = library_results[name].counters
    assert c["rows_sent"] == c["rows_ingested"] + c["rows_lost_crash"]
    assert c["rows_produced"] >= c["rows_sent"]


@pytest.mark.parametrize("name", EPISODE_PINS)
def test_episodes_match_pinned_golden(name):
    want = (GOLDEN / f"episodes_{name}.golden").read_bytes()
    assert export_episodes(name, **CPU).golden_bytes() == want


def test_same_seed_replays_byte_identical(library_results):
    a = library_results["hot_host_cpu"]
    b = run_scenario("hot_host_cpu", **CPU)
    assert a.trace_lines == b.trace_lines
    assert a.cause_lines == b.cause_lines
    assert a.golden_bytes() == b.golden_bytes()
    assert a.causes


def test_different_seed_diverges(library_results):
    b = run_scenario("hot_host_cpu", seed=SCENARIO_LIBRARY[
        "hot_host_cpu"].seed + 1, **CPU)
    assert library_results["hot_host_cpu"].trace_digest != b.trace_digest


def test_script_round_trips_and_replays(library_results):
    sc = SCENARIO_LIBRARY["cascade_dropouts"]
    rt = Scenario.from_dict(json.loads(json.dumps(sc.to_dict())))
    assert rt == sc
    assert run_scenario(rt, **CPU).golden_bytes() == \
        library_results["cascade_dropouts"].golden_bytes()


def per_host(res, node):
    return [ln for ln in res.cause_lines if json.loads(ln)["node"] == node]


def test_host_count_scaling_preserves_per_host_streams():
    small = run_scenario("hot_host_cpu", hosts=8, racks=2, **CPU)
    big = run_scenario("hot_host_cpu", hosts=64, racks=8, **CPU)
    assert per_host(small, "h0003") == per_host(big, "h0003")
    assert per_host(small, "h0003")
    for res in (small, big):
        assert {json.loads(ln)["node"] for ln in res.cause_lines} == {"h0003"}


def test_a_scenario_outside_the_library_matches_the_reference():
    got = port_scenario.run_scenario(
        port_scenario.build_scenario("lossy_fabric", seed=99), **CPU)
    want = ref_scenario.run_scenario(
        ref_scenario.build_scenario("lossy_fabric", seed=99))
    assert got.golden_bytes() == want.golden_bytes()
    assert got.trace_lines == want.trace_lines


def test_numpy_backend_gives_the_same_bytes(library_results):
    got = run_scenario("rack_degrade", backend="numpy", **CPU)
    assert got.golden_bytes() == library_results["rack_degrade"].golden_bytes()


def test_every_tick_sweeps_through_the_gate_function(monkeypatch):
    """With ``backend="torch"`` every diagnosis tick with a straggling
    window packs its windows and evaluates them in one call of the gate
    function (the kernel on a GPU, its plain version here)."""
    from repro_torch.core.fleet import GateStaging

    calls = []
    run = GateStaging.run

    def counted(self, batch, peer_mean):
        calls.append(int(batch.counts.sum()))
        return run(self, batch, peer_mean)

    monkeypatch.setattr(GateStaging, "run", counted)
    res = run_scenario("hot_host_cpu", **CPU)
    assert res.golden_bytes() == \
        (GOLDEN / "scenario_hot_host_cpu.golden").read_bytes()
    assert calls and min(calls) > 0
    assert port_scenario.ScenarioEngine(
        build_scenario("hot_host_cpu"), **CPU).backend == "torch"


def test_scenario_and_device_keywords_stay_apart():
    fields = set(Scenario.__dataclass_fields__)
    assert fields == set(ref_scenario.Scenario.__dataclass_fields__)
    assert not {"device", "backend"} & fields


@pytest.mark.parametrize("extra", [[], ["--episodes"]])
def test_check_cli_passes_on_the_cpu(extra, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.anomaly.scenario", "--check",
         "--device", "cpu", *extra],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ",OK," in ln]
    assert len(lines) == (len(EPISODE_PINS) if extra
                          else len(SCENARIO_LIBRARY))
