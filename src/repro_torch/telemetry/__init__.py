"""Telemetry: resource timelines, step events, the delta wire format and
its cross-process transport — the data-acquisition substrate under
BigRoots (DESIGN.md §2 mapping table)."""
from .events import (
    ForwardedDelta,
    GcTimer,
    StageDelta,
    StepDelta,
    StepTelemetry,
    WireFormatError,
)
from .timeline import ResourceTimeline, TimelineCursor
from .transport import DeltaClient, DeltaServer, Endpoint, RingSender, ShmRing

__all__ = [
    "DeltaClient",
    "DeltaServer",
    "Endpoint",
    "ForwardedDelta",
    "GcTimer",
    "ResourceTimeline",
    "RingSender",
    "ShmRing",
    "StageDelta",
    "StepDelta",
    "StepTelemetry",
    "TimelineCursor",
    "WireFormatError",
]
