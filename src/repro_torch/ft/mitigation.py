"""BigRoots-informed straggler mitigation — the loop the paper closes.

The paper's thesis: once the root cause of a straggler is known, the right
fix is targeted, not speculative re-execution.  This module turns analyzer
findings into concrete actions on this framework's knobs:

| root-cause feature (JAX schema) | action |
|---|---|
| cpu / disk / network (external contention, repeated on a host) | QUARANTINE_HOST → elastic re-mesh without it |
| read_bytes (input-shard skew) | REBALANCE_SHARDS (shrink the hot host's shard) |
| shuffle_read/write_bytes (MoE router imbalance) | TUNE_ROUTER (raise aux-loss coef / capacity factor) |
| ckpt_time | ASYNC_CKPT (move checkpoint writes off-step) |
| data_load_time / h2d_time | DEEPEN_PREFETCH |
| gc_time | POOL_BUFFERS (reduce allocation churn) |
| locality | REPLICATE_SHARDS (cache shards on local SSD) |
"""
from __future__ import annotations

import enum
from collections import Counter, deque
from dataclasses import dataclass, field

from ..core.analyzer import RootCause


class MitigationAction(enum.Enum):
    QUARANTINE_HOST = "quarantine_host"
    REBALANCE_SHARDS = "rebalance_shards"
    TUNE_ROUTER = "tune_router"
    ASYNC_CKPT = "async_ckpt"
    DEEPEN_PREFETCH = "deepen_prefetch"
    POOL_BUFFERS = "pool_buffers"
    REPLICATE_SHARDS = "replicate_shards"


_FEATURE_ACTION = {
    "cpu": MitigationAction.QUARANTINE_HOST,
    "disk": MitigationAction.QUARANTINE_HOST,
    "network": MitigationAction.QUARANTINE_HOST,
    "read_bytes": MitigationAction.REBALANCE_SHARDS,
    "shuffle_read_bytes": MitigationAction.TUNE_ROUTER,
    "shuffle_write_bytes": MitigationAction.TUNE_ROUTER,
    "ckpt_time": MitigationAction.ASYNC_CKPT,
    "data_load_time": MitigationAction.DEEPEN_PREFETCH,
    "h2d_time": MitigationAction.DEEPEN_PREFETCH,
    "d2h_time": MitigationAction.ASYNC_CKPT,
    "gc_time": MitigationAction.POOL_BUFFERS,
    "locality": MitigationAction.REPLICATE_SHARDS,
    # Spark-schema aliases (case-study traces)
    "jvm_gc_time": MitigationAction.POOL_BUFFERS,
    "memory_bytes_spilled": MitigationAction.POOL_BUFFERS,
    "disk_bytes_spilled": MitigationAction.POOL_BUFFERS,
}


@dataclass(frozen=True)
class Mitigation:
    action: MitigationAction
    target: str          # host for quarantine/rebalance; "-" for global knobs
    evidence: int        # number of findings supporting it
    detail: str = ""


@dataclass
class MitigationPlanner:
    """Aggregate findings over a window; recommend actions above thresholds.

    ``applied`` remembers the most recent ``applied_cap`` recommendations
    as a ring buffer: an always-on loop calling :meth:`plan` every step
    must not grow it forever (the same leak class
    ``RootCauseStream.seen`` had before it was bounded).  Pass
    ``applied_cap=None`` to restore the unbounded legacy behavior."""

    quarantine_threshold: int = 3    # distinct contention findings on a host
    skew_threshold: int = 2
    min_findings: int = 1
    applied_cap: int | None = 256
    applied: deque[Mitigation] = field(init=False)

    def __post_init__(self) -> None:
        self.applied = deque(maxlen=self.applied_cap)

    def plan(self, causes: list[RootCause]) -> list[Mitigation]:
        per_host_contention: Counter[str] = Counter()
        per_host_skew: Counter[str] = Counter()
        global_counts: Counter[MitigationAction] = Counter()
        for c in causes:
            action = _FEATURE_ACTION.get(c.feature)
            if action is None:
                continue
            if action is MitigationAction.QUARANTINE_HOST:
                per_host_contention[c.node] += 1
            elif action is MitigationAction.REBALANCE_SHARDS:
                per_host_skew[c.node] += 1
            else:
                global_counts[action] += 1

        plans: list[Mitigation] = []
        for host, n in per_host_contention.most_common():
            if n >= self.quarantine_threshold:
                plans.append(Mitigation(
                    MitigationAction.QUARANTINE_HOST, host, n,
                    f"{n} external-contention findings; drop host and "
                    f"re-mesh (ft.elastic)",
                ))
        for host, n in per_host_skew.most_common():
            if n >= self.skew_threshold:
                plans.append(Mitigation(
                    MitigationAction.REBALANCE_SHARDS, host, n,
                    f"{n} read_bytes-skew findings; shrink this host's shard",
                ))
        for action, n in global_counts.most_common():
            if n >= self.min_findings:
                plans.append(Mitigation(action, "-", n))
        self.applied.extend(plans)
        return plans
