"""Telemetry: system samplers (Eq. 1-3), resource timelines, step events,
the delta wire format and its cross-process transport — the
data-acquisition substrate under BigRoots (DESIGN.md §2 mapping table)."""
from .events import (
    ForwardedDelta,
    GcTimer,
    StageDelta,
    StepDelta,
    StepTelemetry,
    WireFormatError,
)
from .sampler import SystemSampler, read_cpu_sample, read_disk_sample, read_net_sample
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
    "SystemSampler",
    "TimelineCursor",
    "WireFormatError",
    "read_cpu_sample",
    "read_disk_sample",
    "read_net_sample",
]
