"""The program's own spans (``repro_torch.tracing``) that began inside a
traced window, for the per-layer metrics that read them.

The program records spans while a profiler session records, which the
traced window runs inside.  Where it records none (a program without
``repro_torch.tracing``, or no session), each function here returns None.
"""
from __future__ import annotations


def window(ctx: dict) -> list | None:
    """The program's spans that began inside ``[ctx["t0"], ctx["t1"]]``
    (seconds on ``perf_counter``, the spans' clock)."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    spans = tracing.spans(round(ctx["t0"] * 1e9), round(ctx["t1"] * 1e9))
    return spans or None


def ms_per(ctx: dict, name: str, per: str) -> float | None:
    """Milliseconds of the spans named ``name``, summed, over the count of
    those named ``per``."""
    spans = window(ctx)
    if spans is None:
        return None
    n = sum(s.name == per for s in spans)
    if not n:
        return None
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) \
        * 1e-6 / n


def self_ms(ctx: dict, name: str) -> float | None:
    """The mean over the spans named ``name`` of their self time: each
    one's milliseconds less those of its children."""
    spans = window(ctx)
    if spans is None:
        return None
    own = {id(s): s.end_ns - s.start_ns for s in spans if s.name == name}
    if not own:
        return None
    for s in spans:
        if s.parent is not None and id(s.parent) in own:
            own[id(s.parent)] -= s.end_ns - s.start_ns
    return sum(own.values()) * 1e-6 / len(own)
