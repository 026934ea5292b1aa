"""The device's activity over a traced window, reduced in memory.

``torch.profiler`` records the CUDA activity (kernels, copies, sets) of
the window; nothing is written to disk.  From it come the seconds in which
some operation ran (the union of their intervals), the operations that
took most time, and the longest idle gaps, each named by the host span the
benchmark was in when the gap began.
"""
from __future__ import annotations

import time

import torch

TOP = 10


class DeviceTrace:
    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t_host0 = 0.0
        self.mono0 = 0

    def __enter__(self) -> "DeviceTrace":
        self.prof.__enter__()
        self.t_host0 = time.perf_counter()
        self.mono0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)

    def intervals(self) -> list[tuple[float, float, str]]:
        """Device operations as ``(start, end, name)`` on the host's
        ``perf_counter`` clock."""
        res = self.prof.profiler.kineto_results
        trace0 = res.trace_start_ns()
        # kineto's clock is the monotonic one on Linux; where it is not,
        # fall back to the profiler's own start as the window's start.
        same_clock = abs(trace0 - self.mono0) < 10_000_000_000
        out = []
        for e in res.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            if same_clock:
                s = self.t_host0 + (e.start_ns() - self.mono0) * 1e-9
            else:
                s = self.t_host0 + (e.start_ns() - trace0) * 1e-9
            out.append((s, s + e.duration_ns() * 1e-9, e.name()))
        return out

    def reduce(self, t0: float, t1: float, host_spans: list) -> dict:
        """Busy seconds in ``[t0, t1]``, the top operations and the longest
        idle gaps named by the innermost host span open at the gap's
        start."""
        ops = self.intervals()
        by_name: dict[str, float] = {}
        clipped = []
        for s, e, name in ops:
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            by_name[name] = by_name.get(name, 0.0) + (e - s)
            clipped.append((s, e))
        clipped.sort()
        busy, merged = 0.0, []
        for s, e in clipped:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged)
        gaps, prev = [], t0
        for s, e in merged:
            if s > prev:
                gaps.append((s - prev, prev))
            prev = max(prev, e)
        if t1 > prev:
            gaps.append((t1 - prev, prev))
        gaps.sort(reverse=True)
        spans = sorted(host_spans, key=lambda x: x[1])

        def at(t: float) -> str:
            name, start = "outside spans", -1.0
            for n, a, b in spans:
                if a > t:
                    break
                if a <= t < b and a >= start:
                    name, start = n, a
            return name

        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {
            "busy_s": busy,
            "kernels": len(clipped),
            "device_ops": [[n[:160], s] for n, s in top_ops],
            "idle_gaps": [[at(start), g] for g, start in gaps[:TOP]],
        }
