"""System utilization samplers — mpstat/iostat/sar analogs over /proc.

Paper §III-A.1 samples user CPU time (MPSTAT), I/O time (IOSTAT) and network
byte rate (SAR) at 1 Hz; the per-task features are the window averages of
those samples (Eq. 1-3).  Here the same three quantities are read straight
from ``/proc/stat``, ``/proc/diskstats`` and ``/proc/net/dev`` — no external
tools — and pushed into a :class:`ResourceTimeline`.

Robustness: in containers and on non-Linux hosts some of those files do not
exist (``/proc/diskstats`` is the usual casualty).  The sampler degrades
per metric instead of dying: a metric whose source file is missing or
unreadable is skipped for that tick (its Eq. 6 timeline simply has a gap —
the analyzer's edge detection already treats missing windows as "keep"),
the other metrics keep flowing, and :attr:`SystemSampler.metric_health` /
:meth:`SystemSampler.healthy` expose which sources are currently dark so a
supervisor can alarm on a starved timeline instead of silently losing the
``sampler-<host>`` thread.  All ``/proc`` paths are injectable for tests
(fake-/proc fixtures) and exotic mount points.

Overhead (paper Table VII analog, measured by ``benchmarks/table7_overhead``):
one read+parse of the three files per second, <1% of one core.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from .timeline import ResourceTimeline

_PROC_STAT = "/proc/stat"
_PROC_DISKSTATS = "/proc/diskstats"
_PROC_NETDEV = "/proc/net/dev"

# Device prefixes that are not physical disks.
_SKIP_DISK_PREFIXES = ("loop", "ram", "zram", "dm-", "sr", "fd", "md")

METRICS = ("cpu", "disk", "network")


@dataclass(frozen=True)
class CpuSample:
    user: int   # user + nice jiffies
    total: int  # all jiffies


@dataclass(frozen=True)
class DiskSample:
    io_ticks_ms: int  # time spent doing I/O, summed over physical devices


@dataclass(frozen=True)
class NetSample:
    bytes_total: int  # rx + tx over non-loopback interfaces


def read_cpu_sample(path: str = _PROC_STAT) -> CpuSample:
    with open(path) as f:
        line = f.readline()
    parts = line.split()
    vals = [int(x) for x in parts[1:]]
    user = vals[0] + vals[1]  # user + nice
    return CpuSample(user=user, total=sum(vals))


def read_disk_sample(path: str = _PROC_DISKSTATS) -> DiskSample:
    ticks = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 13:
                continue
            name = parts[2]
            if name.startswith(_SKIP_DISK_PREFIXES):
                continue
            # Only whole devices (skip partitions like sda1) — heuristic: skip
            # names ending in a digit unless nvme ('nvme0n1' is a whole device).
            if name[-1].isdigit() and not name.startswith("nvme"):
                continue
            if name.startswith("nvme") and "p" in name.split("n", 2)[-1]:
                continue
            ticks += int(parts[12])  # field 13: io_ticks (ms)
    return DiskSample(io_ticks_ms=ticks)


def read_net_sample(path: str = _PROC_NETDEV) -> NetSample:
    total = 0
    with open(path) as f:
        lines = f.readlines()[2:]
    for line in lines:
        if ":" not in line:
            continue
        name, rest = line.split(":", 1)
        if name.strip() == "lo":
            continue
        parts = rest.split()
        total += int(parts[0]) + int(parts[8])  # rx_bytes + tx_bytes
    return NetSample(bytes_total=total)


class SystemSampler:
    """1 Hz background sampler emitting Eq. 1-3 quantities into a timeline.

    Emitted metrics (matching the feature schema):
      cpu     — user-time fraction over the last interval (Eq. 1 integrand)
      disk    — I/O-time fraction over the last interval (Eq. 2 integrand)
      network — bytes/sec over the last interval (Eq. 3 integrand)

    Each metric is sampled independently; a missing/unreadable source file
    (``OSError``, including ``FileNotFoundError`` inside containers, and
    ``ValueError`` from a malformed line) marks that metric unhealthy for
    the tick and the sampler moves on — the thread never dies on a bad
    ``/proc``.  Health is visible via :attr:`metric_health` (metric →
    bool, last tick), :meth:`healthy` (all sources readable) and
    :attr:`read_errors` (cumulative per-metric failure counts).
    """

    def __init__(
        self,
        node: str,
        timeline: ResourceTimeline,
        interval: float = 1.0,
        clock=time.time,
        *,
        proc_stat: str = _PROC_STAT,
        proc_diskstats: str = _PROC_DISKSTATS,
        proc_netdev: str = _PROC_NETDEV,
    ) -> None:
        self.node = node
        self.timeline = timeline
        self.interval = interval
        self.clock = clock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # metric → (reader, source path); per-metric previous samples so one
        # dark source cannot stall the delta pipeline of the others.
        self._sources = {
            "cpu": (read_cpu_sample, proc_stat),
            "disk": (read_disk_sample, proc_diskstats),
            "network": (read_net_sample, proc_netdev),
        }
        self._prev: dict[str, tuple[object, float]] = {}
        self.metric_health: dict[str, bool] = {m: True for m in METRICS}
        self.read_errors: dict[str, int] = {m: 0 for m in METRICS}
        self.ticks = 0
        # Failures past the readers (e.g. a timeline sink raising):
        # tick_errors counts them cumulatively; last_tick_ok tracks only
        # the most recent tick so health recovers once the sink does
        # (mirroring the per-tick semantics of metric_health).
        self.tick_errors = 0
        self.last_tick_ok = True

    # -- health --------------------------------------------------------------
    def healthy(self) -> bool:
        """True iff every metric source was readable on the last tick and
        the last tick did not fail past the readers (sink/clock errors)."""
        return all(self.metric_health.values()) and self.last_tick_ok

    def missing_metrics(self) -> list[str]:
        return [m for m in METRICS if not self.metric_health[m]]

    # -- manual stepping (used by tests and by the serve loop) ---------------
    def sample_once(self) -> None:
        now = self.clock()
        cur: dict[str, object] = {}
        for metric, (reader, path) in self._sources.items():
            try:
                cur[metric] = reader(path)
                self.metric_health[metric] = True
            except (OSError, ValueError, IndexError):
                # Missing /proc file (containers), transient read hiccup, or
                # a malformed line: skip this metric, keep the rest alive.
                self.metric_health[metric] = False
                self.read_errors[metric] += 1
        self.ticks += 1
        for metric, sample in cur.items():
            prev = self._prev.get(metric)
            self._prev[metric] = (sample, now)
            if prev is None:
                continue
            psample, pt = prev
            dt = max(now - pt, 1e-9)
            if metric == "cpu":
                d_total = max(sample.total - psample.total, 1)
                value = max((sample.user - psample.user) / d_total, 0.0)
            elif metric == "disk":
                value = max(
                    min((sample.io_ticks_ms - psample.io_ticks_ms)
                        / (dt * 1000.0), 1.0),
                    0.0,
                )
            else:  # network
                value = max(
                    (sample.bytes_total - psample.bytes_total) / dt, 0.0
                )
            self.timeline.record(self.node, metric, now, value)

    # -- background thread -----------------------------------------------------
    def start(self) -> "SystemSampler":
        if self._thread is not None:
            raise RuntimeError("sampler already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"sampler-{self.node}")
        self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            try:
                self.sample_once()
                self.last_tick_ok = True
            except Exception:
                # Belt and braces: per-metric errors are handled inside
                # sample_once; anything else (e.g. a timeline sink bug)
                # must not kill the thread — but it must not be invisible
                # either, so it trips healthy() until a tick succeeds.
                self.tick_errors += 1
                self.last_tick_ok = False
            if self._stop.wait(self.interval):
                return

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "SystemSampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
