"""BigRoots core: root-cause analysis of stragglers (paper's contribution).

Public API:

    from repro_torch.core import (
        TaskRecord, StageRecord, Trace,
        StageFrame, TraceStore,
        SlidingStageWindow, StreamingTraceStore, RootCauseStream,
        P2Quantile, P2ColumnSketch,
        FeatureKind, FeatureSpec, FeatureSchema, SPARK_FEATURES, JAX_FEATURES,
        BigRootsAnalyzer, BigRootsThresholds, RootCause, StageAnalysis,
        PCCAnalyzer, PCCThresholds,
        Attribution, WhatIfReplayer,
        straggler_mask, straggler_scale,
        FleetGateBatch, GateStaging, pack_windows, eval_gates_np,
        evaluate, roc_sweep, auc, ConfusionCounts, score_auc, score_points,
        Forecaster, train_forecaster, evaluate_forecaster, lead_time_curve,
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
from .forecast import (
    PREDICTED_STRAGGLER,
    Forecaster,
    baseline_auc,
    evaluate_forecaster,
    lead_time_curve,
    train_forecaster,
)
from .frame import StageFrame, TraceStore
from .pcc import PCCAnalyzer, PCCThresholds
from .records import StageRecord, TaskRecord, Trace
from .report import TraceSummary, per_stage_table, render_markdown, summarize
from .roc import (
    ConfusionCounts,
    RocPoint,
    auc,
    evaluate,
    roc_sweep,
    score_auc,
    score_points,
)
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
    "ConfusionCounts",
    "DEFAULT_STRAGGLER_THRESHOLD",
    "FeatureKind",
    "FeatureSchema",
    "FeatureSpec",
    "FleetGateBatch",
    "ForecastBatch",
    "Forecaster",
    "GateStaging",
    "JAX_FEATURES",
    "MIN_SKETCH_SAMPLES",
    "P2ColumnSketch",
    "P2Quantile",
    "PCCAnalyzer",
    "PCCThresholds",
    "PREDICTED_STRAGGLER",
    "RocPoint",
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
    "auc",
    "baseline_auc",
    "build_causes",
    "cause_from_wire",
    "cause_to_wire",
    "eval_gates_np",
    "evaluate",
    "evaluate_forecaster",
    "found_set",
    "get_schema",
    "lead_time_curve",
    "normalize_features",
    "pack_sequences",
    "pack_windows",
    "per_stage_table",
    "render_markdown",
    "roc_sweep",
    "score_auc",
    "score_points",
    "straggler_mask",
    "straggler_scale",
    "summarize",
    "synthesize_cause",
    "train_forecaster",
]
