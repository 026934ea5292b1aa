"""Pearson Correlation Coefficient baseline (paper Eq. 8, refs [17, 18]).

The comparison method BigRoots is evaluated against: a feature F is a
straggler's root cause iff

    |ρ(F, duration)| > λ_pearson   over all tasks of the stage, and
    F > quantile_{λ_max}(F)        for that straggler's value.

The paper calls the two knobs the *Pearson threshold* and *max threshold*
(§IV-B.2).  Features are the RAW metrics, as in the method's sources
(refs [17, 18] correlate raw workload/latency/system metrics): magnitudes
are stage-mean scaled for comparability, but blocking times stay absolute —
which is exactly why PCC inherits the paper's failure mode, "straggler
feature and task duration is not linearly correlated and features may
correlate with each other" (longer tasks mechanically accumulate more GC/
serialization time, so those features correlate with duration for *every*
straggler).

Shares the columnar :class:`~repro_torch.core.frame.StageFrame` substrate with
the BigRoots analyzer (``StageFrame.pcc_matrix`` is the raw-metric view),
so both methods read the same ingest-once float64 block.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .features import FeatureKind, FeatureSchema
from .frame import StageFrame, as_frame
from .records import StageRecord
from .straggler import DEFAULT_STRAGGLER_THRESHOLD, straggler_mask


@dataclass(frozen=True)
class PCCThresholds:
    pearson: float = 0.5       # λ_pearson: minimum |correlation coefficient|
    max_quantile: float = 0.9  # λ_max: how close to the stage max F must be
    straggler: float = DEFAULT_STRAGGLER_THRESHOLD


class PCCAnalyzer:
    def __init__(self, schema: FeatureSchema, thresholds: PCCThresholds = PCCThresholds()):
        self.schema = schema
        self.thresholds = thresholds

    def root_cause_set(self, trace) -> set[tuple[str, str]]:
        out: set[tuple[str, str]] = set()
        for stage in trace.stages():
            out |= self.analyze_stage(stage)
        return out

    def analyze_stage(self, stage: StageRecord | StageFrame) -> set[tuple[str, str]]:
        frame = as_frame(stage, self.schema)
        n = len(frame)
        if n < 2:
            return set()
        th = self.thresholds
        F = frame.pcc_matrix()
        durations = np.maximum(frame.durations, 1e-12)
        smask = straggler_mask(durations, th.straggler)
        if not smask.any():
            return set()

        # Pearson ρ(F_k, duration) per feature, zero-variance guarded.
        d = durations - durations.mean()
        d_norm = np.sqrt((d * d).sum())
        Fc = F - F.mean(axis=0, keepdims=True)
        f_norm = np.sqrt((Fc * Fc).sum(axis=0))
        with np.errstate(invalid="ignore", divide="ignore"):
            rho = (Fc * d[:, None]).sum(axis=0) / (f_norm * d_norm)
        rho = np.nan_to_num(rho, nan=0.0)

        with np.errstate(invalid="ignore"):
            q = np.quantile(F, th.max_quantile, axis=0)

        # Eq. 8 as one mask: straggler row AND correlated column AND
        # top-quantile value.  PCC treats locality as numeric-incapable;
        # the paper omits it.
        fired = smask[:, None] & (np.abs(rho) > th.pearson)[None, :] & (F > q[None, :])
        dcols = self.schema.cols_of_kind(FeatureKind.DISCRETE)
        if dcols.size:
            fired[:, dcols] = False

        names = self.schema.names
        ii, jj = np.nonzero(fired)
        return {
            (frame.task_ids[i], names[j])
            for i, j in zip(ii.tolist(), jj.tolist())
        }
