"""Fault tolerance: heartbeats, supervised restart, elastic re-mesh,
BigRoots-informed straggler mitigation, and the closed-loop policy engine
that turns confirmed root causes into guarded actions."""
from .elastic import ElasticPlan, plan_mesh_shape, reshard_plan
from .heartbeat import FailureDetector, HeartbeatWriter
from .mitigation import MitigationAction, MitigationPlanner
from .policy import (
    Action,
    ActionKind,
    Actuator,
    DEFAULT_RULES,
    GuardrailConfig,
    PolicyEngine,
    RecordingActuator,
    Rule,
    forecast_rule,
    load_policy,
)
from .supervisor import RestartBudgetExceeded, Supervisor

__all__ = [
    "Action",
    "ActionKind",
    "Actuator",
    "DEFAULT_RULES",
    "ElasticPlan",
    "FailureDetector",
    "GuardrailConfig",
    "HeartbeatWriter",
    "MitigationAction",
    "MitigationPlanner",
    "PolicyEngine",
    "RecordingActuator",
    "RestartBudgetExceeded",
    "Rule",
    "Supervisor",
    "forecast_rule",
    "load_policy",
    "plan_mesh_shape",
    "reshard_plan",
]
