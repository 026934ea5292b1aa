"""Feature registry: the pool of straggler features BigRoots reasons over.

Paper §III-A splits features into four kinds with distinct rules (§III-B):

- NUMERICAL  (paper Table II, ``B/B_avg``): stage-mean normalized magnitudes.
- TIME       (paper Table II, ``T/T_task``): duration-normalized blocking
  times, gated by the ``F > 0.2`` significance floor.
- RESOURCE   (Eq. 1-3): window-integrated system utilization, subject to edge
  detection (Eq. 6).
- DISCRETE   (Eq. 4/7): data locality.

Two schemas ship: ``SPARK_FEATURES`` replicates the paper's Spark setting
verbatim (used by the paper-table benchmarks); ``JAX_FEATURES`` is the
accelerator-pod adaptation (DESIGN.md §2 mapping table).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class FeatureKind(enum.Enum):
    NUMERICAL = "numerical"
    TIME = "time"
    RESOURCE = "resource"
    DISCRETE = "discrete"


@dataclass(frozen=True)
class FeatureSpec:
    name: str
    kind: FeatureKind
    # Human guidance attached to a root-cause finding (paper §I: the point of
    # root-cause analysis is actionable optimization).
    guidance: str = ""

    @property
    def is_resource(self) -> bool:
        return self.kind is FeatureKind.RESOURCE


class FeatureSchema:
    """An ordered, name-indexed collection of FeatureSpecs."""

    def __init__(self, specs: list[FeatureSpec]) -> None:
        self._specs = list(specs)
        self._by_name = {s.name: s for s in specs}
        if len(self._by_name) != len(self._specs):
            raise ValueError("duplicate feature names in schema")
        self._col_index = {s.name: j for j, s in enumerate(self._specs)}
        self._kind_cols = {
            kind: np.array(
                [j for j, s in enumerate(self._specs) if s.kind is kind],
                dtype=np.int64,
            )
            for kind in FeatureKind
        }

    def __iter__(self):
        return iter(self._specs)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __len__(self) -> int:
        return len(self._specs)

    def __getitem__(self, name: str) -> FeatureSpec:
        return self._by_name[name]

    @property
    def names(self) -> list[str]:
        return [s.name for s in self._specs]

    @property
    def specs(self) -> list[FeatureSpec]:
        return list(self._specs)

    @property
    def signature(self) -> tuple[tuple[str, FeatureKind], ...]:
        """(name, kind) pairs — what normalization/gating semantics depend
        on.  Two schemas with equal signatures are interchangeable for
        analysis (guidance text may differ)."""
        return tuple((s.name, s.kind) for s in self._specs)

    @property
    def col_index(self) -> dict[str, int]:
        """Feature name → column position in the schema-ordered matrix."""
        return self._col_index

    def spec_at(self, j: int) -> FeatureSpec:
        return self._specs[j]

    def cols_of_kind(self, kind: FeatureKind) -> np.ndarray:
        """Column indices of all features of ``kind`` (int64, schema order)."""
        return self._kind_cols[kind]

    def of_kind(self, kind: FeatureKind) -> list[FeatureSpec]:
        return [s for s in self._specs if s.kind is kind]

    def resource_names(self) -> list[str]:
        return [s.name for s in self._specs if s.kind is FeatureKind.RESOURCE]


# ---------------------------------------------------------------------------
# Paper schema (Spark, Table I/II + Eq. 1-3)
# ---------------------------------------------------------------------------
SPARK_FEATURES = FeatureSchema(
    [
        FeatureSpec("cpu", FeatureKind.RESOURCE,
                    "External CPU contention: quarantine the node or rebalance co-located jobs."),
        FeatureSpec("disk", FeatureKind.RESOURCE,
                    "External disk contention: use faster disks or isolate I/O-heavy co-tenants."),
        FeatureSpec("network", FeatureKind.RESOURCE,
                    "External network contention: co-schedule network-heavy jobs apart."),
        FeatureSpec("read_bytes", FeatureKind.NUMERICAL,
                    "Data skew on input: repartition input or change the partition key."),
        FeatureSpec("shuffle_read_bytes", FeatureKind.NUMERICAL,
                    "Shuffle skew: split hot keys / increase partitions."),
        FeatureSpec("shuffle_write_bytes", FeatureKind.NUMERICAL,
                    "Shuffle write skew: rebalance the partitioner."),
        FeatureSpec("memory_bytes_spilled", FeatureKind.NUMERICAL,
                    "Memory spill: raise executor memory or reduce partition size."),
        FeatureSpec("disk_bytes_spilled", FeatureKind.NUMERICAL,
                    "Disk spill: raise memory fraction or compress spills."),
        FeatureSpec("jvm_gc_time", FeatureKind.TIME,
                    "GC pressure: tune heap / object churn."),
        FeatureSpec("serialize_time", FeatureKind.TIME,
                    "Result serialization: shrink task results / faster serializer."),
        FeatureSpec("deserialize_time", FeatureKind.TIME,
                    "Executor deserialization: trim closure/broadcast size."),
        FeatureSpec("locality", FeatureKind.DISCRETE,
                    "Poor data locality: optimize data layout or raise locality wait."),
    ]
)


# ---------------------------------------------------------------------------
# Accelerator-pod adaptation (DESIGN.md §2): same kinds, SPMD-host semantics.
# ---------------------------------------------------------------------------
JAX_FEATURES = FeatureSchema(
    [
        FeatureSpec("cpu", FeatureKind.RESOURCE,
                    "Host CPU contention (input pipeline starved): quarantine host / move preprocessing off-host."),
        FeatureSpec("disk", FeatureKind.RESOURCE,
                    "Host disk contention (data cache / checkpoint I/O): stagger checkpoint writes, faster SSD."),
        FeatureSpec("network", FeatureKind.RESOURCE,
                    "DCN/storage NIC contention: stagger data fetch, move replicas closer."),
        FeatureSpec("read_bytes", FeatureKind.NUMERICAL,
                    "Input-shard skew: rebalance host data shards."),
        FeatureSpec("shuffle_read_bytes", FeatureKind.NUMERICAL,
                    "Expert/collective receive skew (MoE router imbalance): tune router aux loss / capacity factor."),
        FeatureSpec("shuffle_write_bytes", FeatureKind.NUMERICAL,
                    "Expert/collective send skew: rebalance token routing."),
        FeatureSpec("memory_bytes_spilled", FeatureKind.NUMERICAL,
                    "Host RAM pressure in input pipeline: shrink prefetch depth."),
        FeatureSpec("disk_bytes_spilled", FeatureKind.NUMERICAL,
                    "Pipeline cache spill: resize host cache."),
        FeatureSpec("gc_time", FeatureKind.TIME,
                    "Python GC pauses in the input pipeline: pool buffers, reduce allocation churn."),
        FeatureSpec("d2h_time", FeatureKind.TIME,
                    "Device→host transfer (metrics/ckpt gather) on critical path: make it async."),
        FeatureSpec("h2d_time", FeatureKind.TIME,
                    "Host→device batch upload stall: enable double-buffered prefetch."),
        FeatureSpec("data_load_time", FeatureKind.TIME,
                    "Input pipeline too slow: add workers / cache shards locally."),
        FeatureSpec("ckpt_time", FeatureKind.TIME,
                    "Checkpoint write blocked the step: use async checkpointing."),
        FeatureSpec("locality", FeatureKind.DISCRETE,
                    "Data shard read from remote store: replicate shards to local SSD cache."),
    ]
)


def get_schema(name: str) -> FeatureSchema:
    if name == "spark":
        return SPARK_FEATURES
    if name == "jax":
        return JAX_FEATURES
    raise KeyError(f"unknown feature schema: {name!r} (expected 'spark' or 'jax')")
