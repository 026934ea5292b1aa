"""BigRoots core: root-cause analysis of stragglers (paper's contribution).

Public API (what this package holds so far):

    from repro_torch.core import (
        TaskRecord, StageRecord, Trace,
        StageFrame, TraceStore,
        SlidingStageWindow, StreamingTraceStore, RootCauseStream,
        P2Quantile, P2ColumnSketch,
        FeatureKind, FeatureSpec, FeatureSchema, SPARK_FEATURES, JAX_FEATURES,
        BigRootsAnalyzer, BigRootsThresholds, RootCause, StageAnalysis,
        Attribution, WhatIfReplayer,
        straggler_mask, straggler_scale,
        FleetGateBatch, GateStaging, pack_windows, eval_gates_np,
        Forecaster,
        TraceSummary, summarize, render_markdown, per_stage_table,
    )
"""
from .analyzer import (
    ATTRIBUTION_VERSION,
    Attribution,
    BigRootsAnalyzer,
    BigRootsThresholds,
    RootCause,
    StageAnalysis,
    TimelineStore,
    attribution_from_wire,
    attribution_to_wire,
    build_causes,
    cause_from_wire,
    cause_to_wire,
    found_set,
    normalize_features,
    synthesize_cause,
)
from .features import (
    JAX_FEATURES,
    SPARK_FEATURES,
    FeatureKind,
    FeatureSchema,
    FeatureSpec,
    get_schema,
)
from .fleet import (
    FleetGateBatch,
    ForecastBatch,
    GateStaging,
    eval_gates_np,
    pack_sequences,
    pack_windows,
)
from .forecast import PREDICTED_STRAGGLER, Forecaster
from .frame import StageFrame, TraceStore
from .records import StageRecord, TaskRecord, Trace
from .report import TraceSummary, per_stage_table, render_markdown, summarize
from .sketch import MIN_SKETCH_SAMPLES, P2ColumnSketch, P2Quantile
from .straggler import DEFAULT_STRAGGLER_THRESHOLD, straggler_mask, straggler_scale
from .whatif import WhatIfReplayer
from .window import (
    CauseState,
    RootCauseStream,
    SlidingStageWindow,
    StreamingTraceStore,
)

__all__ = [
    "ATTRIBUTION_VERSION",
    "Attribution",
    "BigRootsAnalyzer",
    "BigRootsThresholds",
    "CauseState",
    "FleetGateBatch",
    "GateStaging",
    "ForecastBatch",
    "Forecaster",
    "DEFAULT_STRAGGLER_THRESHOLD",
    "FeatureKind",
    "FeatureSchema",
    "FeatureSpec",
    "JAX_FEATURES",
    "PREDICTED_STRAGGLER",
    "MIN_SKETCH_SAMPLES",
    "P2ColumnSketch",
    "P2Quantile",
    "RootCause",
    "RootCauseStream",
    "SPARK_FEATURES",
    "SlidingStageWindow",
    "StageAnalysis",
    "StageFrame",
    "StageRecord",
    "StreamingTraceStore",
    "TaskRecord",
    "TimelineStore",
    "Trace",
    "TraceStore",
    "TraceSummary",
    "WhatIfReplayer",
    "attribution_from_wire",
    "attribution_to_wire",
    "build_causes",
    "cause_from_wire",
    "cause_to_wire",
    "eval_gates_np",
    "found_set",
    "get_schema",
    "normalize_features",
    "pack_sequences",
    "pack_windows",
    "per_stage_table",
    "render_markdown",
    "synthesize_cause",
    "straggler_mask",
    "straggler_scale",
    "summarize",
]
