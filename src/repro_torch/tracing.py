"""The program's own observability: named spans on the host clock.

A span is two host timestamps around a piece of the program's work (a
train step's forward, a serving round's decode step), with the span it
ran inside.  It adds no synchronisation and reads nothing from the
device, so a span around enqueued device work measures the host's enqueue
(with any wait for the device that the work itself makes) and a span
around a device read measures the wait for the device.  This
is not BigRoots' telemetry: ``telemetry/``'s ``StepScope.phase`` times
are features of the workload that the analyzer diagnoses; these spans
say where the program itself spends its time, for whoever profiles it.

Recording is on while a ``torch.profiler`` session records in this
process, and only then.  Off, :func:`span` costs one check and returns a
shared no-op.  On, each span records its name, its start and end on
``time.perf_counter_ns()`` (CLOCK_MONOTONIC on Linux), its thread, its
parent (the innermost span open on that thread) and the ids passed in
(the spans of one serving round share the round's), and opens
``torch.profiler.record_function(name)``, so that a trace with CPU
activity shows the program's spans beside its operators and kernels.

The profiler stamps its events in nanoseconds since the epoch.  Each
session stores an :class:`Anchor` as it starts: a ``time.time_ns()`` and
``time.perf_counter_ns()`` pair read back to back, which maps a profiler
stamp onto the spans' clock by one subtraction.

Spans are kept in memory, at most :data:`CAPACITY` a session, the rest
counted by :func:`dropped`.  A session's start clears those of the
session before; after a session ends they stay until the next one
starts.  Read them with :func:`spans` and :func:`anchor`.
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

#: Spans kept a session; later ones are counted, not kept.
CAPACITY = 1 << 20

_recording = torch._C._autograd._profiler_enabled


class Anchor(NamedTuple):
    """One instant on the epoch clock and on the spans' clock."""

    epoch_ns: int
    perf_ns: int

    def perf_ns_of(self, epoch_ns: int) -> int:
        """A profiler stamp (``epoch_ns``) on the spans' clock."""
        return epoch_ns - self.epoch_ns + self.perf_ns


class Span:
    """One recorded span; ``end_ns`` is None while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "thread", "parent", "ids")

    def __init__(self, name: str, thread: int, parent: Span | None,
                 ids: dict) -> None:
        self.name = name
        self.start_ns = 0
        self.end_ns: int | None = None
        self.thread = thread
        self.parent = parent
        self.ids = ids

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start_ns}, {self.end_ns}, "
                f"ids={self.ids})")


def _read_anchor(tries: int = 5) -> Anchor:
    """The ``time_ns`` / ``perf_counter_ns`` pair read with the smallest
    gap over ``tries``; the perf reading is the middle of the gap."""
    best = None
    for _ in range(tries):
        a = time.perf_counter_ns()
        epoch = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, Anchor(epoch, (a + b) // 2))
    return best[1]


class _Recorder:
    def __init__(self) -> None:
        self.spans: list[Span] = []
        self.dropped = 0
        self.anchor: Anchor | None = None
        self.local = threading.local()

    def begin(self) -> None:
        self.spans = []
        self.dropped = 0
        self.anchor = _read_anchor()

    def stack(self) -> list[Span]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_REC = _Recorder()


def _on_session_start(start=_profiler._run_on_profiler_start) -> None:
    start()
    _REC.begin()


# torch calls this as every profiler session starts, before it records.
_profiler._run_on_profiler_start = _on_session_start


class _Off:
    __slots__ = ()

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _On:
    __slots__ = ("span", "rf", "stack")

    def __init__(self, name: str, ids: dict) -> None:
        self.stack = stack = _REC.stack()
        self.span = Span(name, threading.get_ident(),
                         stack[-1] if stack else None, ids)
        self.rf = _profiler.record_function(name)

    def __enter__(self) -> Span:
        self.rf.__enter__()
        s = self.span
        self.stack.append(s)
        if len(_REC.spans) < CAPACITY:
            _REC.spans.append(s)
        else:
            _REC.dropped += 1
        s.start_ns = time.perf_counter_ns()
        return s

    def __exit__(self, *exc) -> None:
        self.span.end_ns = time.perf_counter_ns()
        self.stack.pop()
        self.rf.__exit__(*exc)


def span(name: str, **ids):
    """A context manager that records ``name`` with ``ids`` while a
    profiler session records, and does nothing otherwise."""
    if not _recording():
        return _OFF
    return _On(name, ids)


def spans(t0_ns: int | None = None, t1_ns: int | None = None) -> list[Span]:
    """The finished spans of the latest session that began inside
    ``[t0_ns, t1_ns]`` (either end open where None), in start order."""
    return [s for s in _REC.spans if s.end_ns is not None
            and (t0_ns is None or s.start_ns >= t0_ns)
            and (t1_ns is None or s.start_ns <= t1_ns)]


def anchor() -> Anchor | None:
    """The latest session's anchor (None before any session)."""
    return _REC.anchor


def dropped() -> int:
    """Spans of the latest session past :data:`CAPACITY`, not kept."""
    return _REC.dropped
