"""Anomaly generation: real resource hogs (paper §IV-A AGs), the
deterministic simulated cluster used to replicate the paper's tables, the
closed-loop mitigation A/B harness over it, and the discrete-event fleet
scenario engine that drives the real transport + aggregation + diagnosis
stack through scripted correlated incidents (``SCENARIO_LIBRARY``).
"""
from .generators import CpuAnomalyGenerator, IoAnomalyGenerator, NetworkAnomalyGenerator
from .injector import Injection, InjectionSchedule, overlap
from .loop import ABResult, ClosedLoopSim, LoopResult, SCENARIOS, SimActuator, ab_compare
from .scenario import (
    EpisodeSet,
    Incident,
    LinkProfile,
    SCENARIO_LIBRARY,
    Scenario,
    ScenarioEngine,
    ScenarioResult,
    build_scenario,
    export_episodes,
    run_scenario,
)
from .sim import SimCluster, SimResult, WorkloadProfile, WORKLOAD_PROFILES

__all__ = [
    "ABResult",
    "ClosedLoopSim",
    "CpuAnomalyGenerator",
    "EpisodeSet",
    "Incident",
    "Injection",
    "InjectionSchedule",
    "IoAnomalyGenerator",
    "LinkProfile",
    "LoopResult",
    "NetworkAnomalyGenerator",
    "SCENARIOS",
    "SCENARIO_LIBRARY",
    "Scenario",
    "ScenarioEngine",
    "ScenarioResult",
    "SimActuator",
    "SimCluster",
    "SimResult",
    "WORKLOAD_PROFILES",
    "WorkloadProfile",
    "ab_compare",
    "build_scenario",
    "export_episodes",
    "overlap",
    "run_scenario",
]
