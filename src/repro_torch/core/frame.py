"""Columnar trace substrate: :class:`StageFrame` / :class:`TraceStore`.

Structure-of-arrays (SoA) layout
--------------------------------
The analyzer's unit of work is one stage = ``n`` tasks × ``F`` schema
features.  The dataclass representation (:class:`~repro_torch.core.records.Trace`
of :class:`~repro_torch.core.records.TaskRecord`) is array-of-structs: every
``analyze_stage`` call pays O(n·F) Python dict lookups to rebuild the
feature matrix, plus an O(n²) node-index loop.  At fleet scale (16k hosts
per step window) that is seconds per window — far too slow for always-on
diagnosis of every training/serving step.

A :class:`StageFrame` stores the same stage as parallel columns, built
*once* at ingest:

- ``task_ids``   — list[str], row ``i`` is task ``i`` everywhere below;
- ``node_names`` — sorted unique node names; ``node_codes`` (int64) indexes
  into it (``np.unique(..., return_inverse=True)``, replacing the O(n²)
  ``list.index`` pattern);
- ``starts`` / ``ends`` — float64 timestamps (``durations`` is derived);
- ``locality``   — int16 Eq. 4 codes;
- ``raw``        — ``[n, F]`` float64 block of raw feature values in schema
  column order (missing features are 0.0, exactly the semantics of
  ``task.features.get(name, 0.0)``);
- ``present``    — ``[n, F]`` bool: which entries the source feature dict
  actually contained.  ``raw`` alone cannot distinguish "recorded as 0.0"
  from "absent", and that distinction is what keeps the
  :class:`~repro_torch.core.records.TaskRecord` view and JSONL round trips exact;
- ``extras``     — sparse ``{row: {name: value}}`` for features outside the
  schema (kept only so no telemetry is silently dropped on round trip).

Everything the analyzer needs — normalization (Table II), peer means,
Eq. 5/6/7 gates — is then pure numpy over these columns; see
``BigRootsAnalyzer.analyze_stage``.

:class:`TraceStore` is the multi-stage container: an append-oriented
columnar ingest surface (``add_row``) with amortized O(1) growth per task
and *no* per-task object materialization on the hot path, plus the same
access/persistence API as :class:`~repro_torch.core.records.Trace` so analyzers,
reports, and launch scripts work on either.  The loop-based reference analyzer
(not part of this package yet) remains the ground truth the frame-based
fast path is property-tested against.
"""
from __future__ import annotations

import json
from typing import Iterable, Iterator, Mapping, Sequence

import numpy as np

from .features import FeatureKind, FeatureSchema
from .records import StageRecord, TaskRecord, Trace


class StageFrame:
    """One stage's tasks as structure-of-arrays (see module docstring)."""

    __slots__ = (
        "stage_id", "schema", "task_ids", "node_codes", "node_names",
        "starts", "ends", "locality", "raw", "present", "extras",
        "_tasks_cache",
    )

    def __init__(
        self,
        stage_id: str,
        schema: FeatureSchema,
        task_ids: list[str],
        node_codes: np.ndarray,
        node_names: np.ndarray,
        starts: np.ndarray,
        ends: np.ndarray,
        locality: np.ndarray,
        raw: np.ndarray,
        present: np.ndarray | None = None,
        extras: dict[int, dict[str, float]] | None = None,
    ) -> None:
        self.stage_id = stage_id
        self.schema = schema
        self.task_ids = task_ids
        self.node_codes = node_codes
        self.node_names = node_names
        self.starts = starts
        self.ends = ends
        self.locality = locality
        self.raw = raw
        self.present = (
            present if present is not None else np.ones(raw.shape, dtype=bool)
        )
        self.extras = extras or {}
        self._tasks_cache: list[TaskRecord] | None = None

    # -- construction -----------------------------------------------------
    @classmethod
    def from_tasks(
        cls, stage_id: str, tasks: Sequence[TaskRecord], schema: FeatureSchema
    ) -> "StageFrame":
        n = len(tasks)
        k = len(schema)
        col = schema.col_index
        loc_j = col.get("locality")
        raw = np.zeros((n, k), dtype=np.float64)
        present = np.zeros((n, k), dtype=bool)
        starts = np.empty(n, dtype=np.float64)
        ends = np.empty(n, dtype=np.float64)
        locality = np.zeros(n, dtype=np.int16)
        extras: dict[int, dict[str, float]] = {}
        task_ids = [t.task_id for t in tasks]
        nodes = [t.node for t in tasks]
        for i, t in enumerate(tasks):
            starts[i] = t.start
            ends[i] = t.end
            locality[i] = t.locality
            for name, v in t.features.items():
                j = col.get(name)
                if j is None or j == loc_j:
                    # Outside the schema (or shadowing the locality *field*,
                    # which owns that column): keep verbatim for round trips.
                    extras.setdefault(i, {})[name] = float(v)
                else:
                    raw[i, j] = float(v)
                    present[i, j] = True
        if loc_j is not None:
            raw[:, loc_j] = locality
        node_names, node_codes = _encode_nodes(nodes)
        return cls(stage_id, schema, task_ids, node_codes, node_names,
                   starts, ends, locality, raw, present, extras)

    @classmethod
    def from_columns(
        cls,
        stage_id: str,
        schema: FeatureSchema,
        task_ids: Sequence[str],
        nodes: Sequence[str],
        starts: np.ndarray,
        ends: np.ndarray,
        locality: np.ndarray | None = None,
        feature_columns: Mapping[str, np.ndarray] | None = None,
    ) -> "StageFrame":
        """Build directly from columns (array-native ingest; no dicts)."""
        n = len(task_ids)
        k = len(schema)
        col = schema.col_index
        raw = np.zeros((n, k), dtype=np.float64)
        present = np.zeros((n, k), dtype=bool)
        loc = (
            np.asarray(locality, dtype=np.int16)
            if locality is not None else np.zeros(n, dtype=np.int16)
        )
        loc_j = col.get("locality")
        for name, values in (feature_columns or {}).items():
            j = col.get(name)
            if j == loc_j and j is not None:
                raise ValueError(
                    "the locality column is owned by the task field: pass "
                    "locality=... instead of a 'locality' feature column"
                )
            if j is None:
                raise KeyError(f"feature column {name!r} not in schema")
            raw[:, j] = np.asarray(values, dtype=np.float64)
            present[:, j] = True
        if loc_j is not None:
            raw[:, loc_j] = loc
        node_names, node_codes = _encode_nodes(list(nodes))
        return cls(stage_id, schema, list(task_ids), node_codes, node_names,
                   np.asarray(starts, np.float64), np.asarray(ends, np.float64),
                   loc, raw, present)

    # -- shape / access ----------------------------------------------------
    def __len__(self) -> int:
        return len(self.task_ids)

    @property
    def durations(self) -> np.ndarray:
        return self.ends - self.starts

    def nodes(self) -> list[str]:
        """Sorted unique node names (mirrors ``StageRecord.nodes``)."""
        return [str(x) for x in self.node_names]

    def node_of(self, i: int) -> str:
        return str(self.node_names[self.node_codes[i]])

    # -- derived matrices --------------------------------------------------
    def normalized(self) -> np.ndarray:
        """BigRoots-normalized ``F[tasks, features]`` (paper Table II).

        numerical → raw / stage_mean(raw); time → raw / task_duration;
        resource and discrete stay raw.
        """
        F = self.pcc_matrix()
        tcols = self.schema.cols_of_kind(FeatureKind.TIME)
        if tcols.size:
            F[:, tcols] /= np.maximum(self.durations, 1e-12)[:, None]
        return F

    def pcc_matrix(self) -> np.ndarray:
        """PCC's raw-metric matrix: numerical stage-mean scaled for
        cross-feature comparability, time/resource/discrete absolute."""
        F = self.raw.copy()
        num = self.schema.cols_of_kind(FeatureKind.NUMERICAL)
        if len(self) and num.size:
            means = F[:, num].mean(axis=0)
            with np.errstate(invalid="ignore", divide="ignore"):
                F[:, num] = np.where(means > 0, F[:, num] / means, 0.0)
        return F

    # -- dataclass view (compatibility / persistence) ----------------------
    def task(self, i: int) -> TaskRecord:
        names = self.schema.names
        feats: dict[str, float] = {
            names[j]: float(self.raw[i, j])
            for j in np.nonzero(self.present[i])[0]
        }
        if self.extras:
            feats.update(self.extras.get(i, {}))
        return TaskRecord(
            task_id=self.task_ids[i],
            stage_id=self.stage_id,
            node=self.node_of(i),
            start=float(self.starts[i]),
            end=float(self.ends[i]),
            locality=int(self.locality[i]),
            features=feats,
        )

    @property
    def tasks(self) -> list[TaskRecord]:
        if self._tasks_cache is None:
            self._tasks_cache = [self.task(i) for i in range(len(self))]
        return self._tasks_cache

    def to_stage_record(self) -> StageRecord:
        return StageRecord(self.stage_id, list(self.tasks))


def as_frame(stage: "StageRecord | StageFrame", schema: FeatureSchema) -> StageFrame:
    """Coerce a stage to a StageFrame under ``schema``.

    A frame already carrying the same feature columns *and kinds* passes
    through untouched (kinds drive normalization and gating, so a
    same-names schema that reclassifies a feature must not pass); a
    sliding window (anything exposing ``seal()``) is snapshotted to its
    live-row frame; anything else (StageRecord, or a frame built under a
    different schema) is re-ingested via the TaskRecord view.
    """
    if isinstance(stage, StageFrame) and stage.schema.signature == schema.signature:
        return stage
    seal = getattr(stage, "seal", None)
    if callable(seal):
        sealed = seal()
        if sealed.schema.signature == schema.signature:
            return sealed
        stage = sealed
    return StageFrame.from_tasks(stage.stage_id, stage.tasks, schema)


def _encode_nodes(nodes: list[str]) -> tuple[np.ndarray, np.ndarray]:
    if not nodes:
        return np.empty(0, dtype=object), np.zeros(0, dtype=np.int64)
    names, codes = np.unique(nodes, return_inverse=True)
    return names, codes.astype(np.int64, copy=False)


class _StageBuilder:
    """Growable column buffers for one stage (amortized O(1) appends)."""

    __slots__ = ("stage_id", "schema", "n", "task_ids", "nodes", "starts",
                 "ends", "locality", "raw", "present", "extras", "_frame",
                 "_col", "_loc_j")

    _INITIAL = 16

    def __init__(self, stage_id: str, schema: FeatureSchema) -> None:
        self.stage_id = stage_id
        self.schema = schema
        self._col = schema.col_index
        self._loc_j = self._col.get("locality")
        self.n = 0
        cap = self._INITIAL
        k = len(schema)
        self.task_ids: list[str] = []
        self.nodes: list[str] = []
        self.starts = np.empty(cap, dtype=np.float64)
        self.ends = np.empty(cap, dtype=np.float64)
        self.locality = np.zeros(cap, dtype=np.int16)
        self.raw = np.zeros((cap, k), dtype=np.float64)
        self.present = np.zeros((cap, k), dtype=bool)
        self.extras: dict[int, dict[str, float]] = {}
        self._frame: StageFrame | None = None

    def _grow(self, need: int | None = None) -> None:
        cap = self.starts.shape[0]
        need = 2 * cap if need is None else need
        while cap < need:
            cap *= 2
        for name in ("starts", "ends", "locality", "raw", "present"):
            old = getattr(self, name)
            new = np.zeros((cap,) + old.shape[1:], dtype=old.dtype)
            new[: self.n] = old[: self.n]
            setattr(self, name, new)

    def add(
        self,
        task_id: str,
        node: str,
        start: float,
        end: float,
        locality: int,
        features: Mapping[str, float] | None,
    ) -> None:
        if self.n == self.starts.shape[0]:
            self._grow()
        i = self.n
        col = self._col
        loc_j = self._loc_j
        self.task_ids.append(task_id)
        self.nodes.append(node)
        self.starts[i] = start
        self.ends[i] = end
        self.locality[i] = locality
        if features:
            raw_row = self.raw[i]
            present_row = self.present[i]
            for name, v in features.items():
                j = col.get(name)
                if j is None or j == loc_j:
                    self.extras.setdefault(i, {})[name] = float(v)
                else:
                    raw_row[j] = float(v)
                    present_row[j] = True
        if loc_j is not None:
            self.raw[i, loc_j] = locality
        self.n += 1
        self._frame = None

    def absorb(self, frame: StageFrame) -> None:
        """Bulk-append another frame's rows as column copies — no TaskRecord
        materialization.  Node names are decoded from the source vocabulary
        in one vectorized gather; the *shared* vocabulary is rebuilt at the
        next :meth:`seal` (``np.unique`` over the combined name column), so
        disjoint and colliding per-host vocabularies both re-encode
        correctly.  Rows land after all existing rows, preserving the
        append-only ingest-order invariant ``seal`` relies on."""
        m = len(frame)
        if m == 0:
            return
        if self.n + m > self.starts.shape[0]:
            self._grow(self.n + m)
        i0 = self.n
        sl = slice(i0, i0 + m)
        self.task_ids.extend(frame.task_ids)
        self.nodes.extend(
            np.asarray(frame.node_names, dtype=object)[frame.node_codes].tolist()
        )
        self.starts[sl] = frame.starts
        self.ends[sl] = frame.ends
        self.locality[sl] = frame.locality
        self.raw[sl] = frame.raw
        self.present[sl] = frame.present
        for r, ex in frame.extras.items():
            self.extras[i0 + int(r)] = dict(ex)
        self.n += m
        self._frame = None

    def seal(self) -> StageFrame:
        # Rows are append-only, so handing out slice views is safe: a later
        # append writes past row n-1 (or into a fresh buffer after a grow)
        # and never mutates rows a sealed frame can see.
        if self._frame is None:
            n = self.n
            node_names, node_codes = _encode_nodes(self.nodes)
            self._frame = StageFrame(
                self.stage_id, self.schema, list(self.task_ids),
                node_codes, node_names,
                self.starts[:n], self.ends[:n], self.locality[:n],
                self.raw[:n], self.present[:n], dict(self.extras),
            )
        return self._frame


class TraceStore:
    """Columnar job trace: stages in arrival order, Trace-compatible API.

    The ingest surface is :meth:`add_row` — scalars plus one feature dict —
    so telemetry and benchmarks feed columns directly without materializing
    a :class:`TaskRecord` per task.  ``add_task``/``extend`` remain for
    dataclass sources, and JSONL persistence round-trips with
    :class:`~repro_torch.core.records.Trace` byte-for-byte.

    Multi-host aggregation: :meth:`merge` absorbs other stores column-wise
    (per-stage block concatenation; the shared node vocabulary is rebuilt
    at seal) — the launcher-side path for combining per-host traces into
    one fleet trace without a TaskRecord round trip.
    """

    def __init__(self, schema: FeatureSchema,
                 tasks: Iterable[TaskRecord] = ()) -> None:
        self.schema = schema
        self._builders: dict[str, _StageBuilder] = {}
        self.extend(tasks)

    # -- construction -----------------------------------------------------
    def add_row(
        self,
        task_id: str,
        stage_id: str,
        node: str,
        start: float,
        end: float,
        locality: int = 0,
        features: Mapping[str, float] | None = None,
    ) -> None:
        builder = self._builders.get(stage_id)
        if builder is None:
            builder = self._builders[stage_id] = _StageBuilder(
                stage_id, self.schema
            )
        builder.add(task_id, node, start, end, locality, features)

    def add_task(self, task: TaskRecord) -> None:
        self.add_row(task.task_id, task.stage_id, task.node, task.start,
                     task.end, task.locality, task.features)

    def extend(self, tasks: Iterable[TaskRecord]) -> None:
        for t in tasks:
            self.add_task(t)

    def merge(self, *others: "TraceStore") -> "TraceStore":
        """Absorb other stores' rows into this one, column-wise, in place.

        For every stage of every ``other`` (in argument order), the stage's
        column block is concatenated after this store's rows for the same
        ``stage_id`` (a new stage is created when this store has none), so
        ingest order is preserved per store and ``others`` append behind
        existing rows.  Node codes are re-encoded through the merged
        vocabulary when the stage next seals — disjoint and colliding
        per-host node sets both come out correct.

        Same-signature schemas take the columnar fast path (pure array
        copies); a foreign schema falls back to re-ingest through the
        TaskRecord view (correct, slower).  ``others`` are read, never
        mutated.  Returns ``self`` for chaining.
        """
        if len({id(o) for o in others}) != len(others):
            raise ValueError("the same store appears twice in a merge")
        for other in others:
            if other is self:
                raise ValueError("cannot merge a TraceStore into itself")
            columnar = other.schema.signature == self.schema.signature
            for frame in other.stages():
                if columnar:
                    builder = self._builders.get(frame.stage_id)
                    if builder is None:
                        builder = self._builders[frame.stage_id] = _StageBuilder(
                            frame.stage_id, self.schema
                        )
                    builder.absorb(frame)
                else:
                    self.extend(frame.tasks)
        return self

    # -- access ------------------------------------------------------------
    def stages(self) -> Iterator[StageFrame]:
        for builder in self._builders.values():
            yield builder.seal()

    def stage(self, stage_id: str) -> StageFrame:
        return self._builders[stage_id].seal()

    def stage_ids(self) -> list[str]:
        return list(self._builders)

    @property
    def num_tasks(self) -> int:
        return sum(b.n for b in self._builders.values())

    def __len__(self) -> int:
        return len(self._builders)

    # -- conversion --------------------------------------------------------
    def to_trace(self) -> Trace:
        return Trace(frame.to_stage_record() for frame in self.stages())

    @classmethod
    def from_trace(cls, trace: Trace, schema: FeatureSchema) -> "TraceStore":
        store = cls(schema)
        for stage in trace.stages():
            store.extend(stage.tasks)
        return store

    # -- persistence ---------------------------------------------------------
    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for frame in self.stages():
                for i in range(len(frame)):
                    f.write(frame.task(i).to_json() + "\n")

    @classmethod
    def load_jsonl(cls, path: str, schema: FeatureSchema) -> "TraceStore":
        store = cls(schema)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                store.add_row(
                    obj["task_id"], obj["stage_id"], obj["node"],
                    obj["start"], obj["end"], obj.get("locality", 0),
                    obj.get("features", {}),
                )
        return store
