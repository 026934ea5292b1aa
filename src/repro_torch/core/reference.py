"""Literal, loop-based transcription of the BigRoots equations.

This module exists as the *oracle* for property-testing the vectorized
production analyzer (`repro_torch.core.analyzer`): every rule is written as a
direct, slow, obviously-correct rendering of paper §III.  Tests assert the
two produce identical (task, feature) root-cause sets on random traces.
"""
from __future__ import annotations

import statistics

import numpy as np

from .analyzer import BigRootsThresholds, TimelineStore
from .features import FeatureKind, FeatureSchema
from .records import StageRecord


def _quantile(values: list[float], q: float) -> float:
    # Matches numpy's default 'linear' interpolation.
    return float(np.quantile(np.asarray(values, dtype=np.float64), q))


def _normalize(stage: StageRecord, schema: FeatureSchema) -> list[dict[str, float]]:
    out: list[dict[str, float]] = []
    # Per-feature stage means for numerical normalization (B / B_avg).
    means: dict[str, float] = {}
    for spec in schema:
        if spec.kind is FeatureKind.NUMERICAL:
            vals = [float(t.features.get(spec.name, 0.0)) for t in stage.tasks]
            means[spec.name] = sum(vals) / len(vals) if vals else 0.0
    for t in stage.tasks:
        row: dict[str, float] = {}
        dur = max(t.duration, 1e-12)
        for spec in schema:
            if spec.name == "locality":
                row[spec.name] = float(t.locality)
            elif spec.kind is FeatureKind.NUMERICAL:
                m = means[spec.name]
                row[spec.name] = float(t.features.get(spec.name, 0.0)) / m if m > 0 else 0.0
            elif spec.kind is FeatureKind.TIME:
                row[spec.name] = float(t.features.get(spec.name, 0.0)) / dur
            else:
                row[spec.name] = float(t.features.get(spec.name, 0.0))
        out.append(row)
    return out


def reference_root_causes(
    stage: StageRecord,
    schema: FeatureSchema,
    thresholds: BigRootsThresholds = BigRootsThresholds(),
    timelines: TimelineStore | None = None,
) -> set[tuple[str, str]]:
    """All (task_id, feature) root causes for one stage, per the paper text."""
    tasks = stage.tasks
    if not tasks:
        return set()
    th = thresholds
    durations = [t.duration for t in tasks]
    median = statistics.median(durations)
    stragglers = [i for i, d in enumerate(durations) if d > th.straggler * median]
    normals = [i for i, d in enumerate(durations) if not d > th.straggler * median]

    F = _normalize(stage, schema)
    found: set[tuple[str, str]] = set()

    # Eq. 7 precondition over normal tasks.
    loc_sum = sum(tasks[i].locality for i in normals)
    locality_vote = loc_sum < len(normals) / 2.0

    for i in stragglers:
        t = tasks[i]
        for spec in schema:
            name = spec.name
            f = F[i][name]
            if spec.kind is FeatureKind.DISCRETE:
                if t.locality == 2 and locality_vote:
                    found.add((t.task_id, name))
                continue

            # Eq. 5 condition 1: F > global_quantile_λq over all stage tasks.
            gq = _quantile([F[j][name] for j in range(len(tasks))], th.quantile)
            if not f > gq:
                continue

            # Eq. 5 condition 2 against inter-node and intra-node peers.
            inter = [F[j][name] for j in range(len(tasks)) if tasks[j].node != t.node]
            intra = [
                F[j][name]
                for j in range(len(tasks))
                if tasks[j].node == t.node and j != i
            ]
            fired = False
            if inter and f > (sum(inter) / len(inter)) * th.peer_mean:
                fired = True
            if intra and f > (sum(intra) / len(intra)) * th.peer_mean:
                fired = True
            if not fired:
                continue

            if spec.kind is FeatureKind.TIME and not f > th.time_floor:
                continue

            if spec.kind is FeatureKind.RESOURCE and timelines is not None:
                head = timelines.window_mean(t.node, name, t.start - th.edge_width, t.start)
                tail = timelines.window_mean(t.node, name, t.end, t.end + th.edge_width)
                if head is not None and tail is not None:
                    # Filter iff both edges present (rise at start AND drop at
                    # end); either side persisting high ⇒ external ⇒ keep.
                    external = (
                        head > th.edge_filter * f or tail > th.edge_filter * f
                    )
                    if not external:
                        continue
            found.add((t.task_id, name))
    return found
