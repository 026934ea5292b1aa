"""Spans the benchmark records around the program's public entries.

A host span is two ``perf_counter`` readings.  A device span is a pair of
CUDA events recorded on the current stream around the call: its elapsed
time is what the device spent from the call's first queued operation to
its last, read once the window has closed.  Entries are wrapped by
replacing the attribute on their module or object; ``restore`` puts every
one back.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class Spans:
    def __init__(self, device: torch.device, events: bool) -> None:
        self.device = device
        #: device spans are recorded (traced runs on the card only)
        self.events = events and device.type == "cuda"
        self.host: list[tuple[str, float, float]] = []
        self.dev: dict[str, list] = {}
        self.calls: dict[str, list] = {}
        self._wrapped: list[tuple[object, str, object]] = []

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.host.append((name, t0, time.perf_counter()))

    @contextmanager
    def device_span(self, name: str):
        if not self.events:
            yield
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        try:
            yield
        finally:
            b.record()
            self.dev.setdefault(name, []).append((a, b))

    def wrap(self, owner, attr: str, name: str, *, host: bool = True,
             device: bool = False, sync: bool = False, record=None) -> None:
        """Replace ``owner.attr`` by a wrapper that records a host span
        (``host``) and a device span (``device``) named ``name`` around
        each call, with ``sync`` ending the host span when the device has
        finished the call's work, and passes the call's arguments and
        result to ``record(args, kwargs, out)`` if given."""
        fn = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            with self.device_span(name) if device else _null():
                out = fn(*args, **kwargs)
            if sync and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if host:
                self.host.append((name, t0, time.perf_counter()))
            if record is not None:
                self.calls.setdefault(name, []).append(
                    record(args, kwargs, out))
            return out

        setattr(owner, attr, wrapped)
        self._wrapped.append((owner, attr, fn))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._wrapped):
            setattr(owner, attr, fn)
        self._wrapped.clear()

    # -- reading -------------------------------------------------------------
    def host_ms(self, name: str, t0: float, t1: float) -> float:
        """Total milliseconds of ``name``'s host spans that began inside
        ``[t0, t1]``."""
        return sum((b - a) * 1e3 for n, a, b in self.host
                   if n == name and t0 <= a <= t1)

    def device_ms(self, name: str) -> list[float]:
        return [a.elapsed_time(b) for a, b in self.dev.get(name, [])]


@contextmanager
def _null():
    yield
