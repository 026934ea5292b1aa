"""Injection schedules: when/where/what anomaly runs (paper Table IV).

A schedule is ground truth for the verification experiments: a (straggler
task, resource feature) pair is *truly affected* when the task's window
overlaps an injection on its node (paper §IV-B: "If a task's duration
overlaps with AG injecting period, we consider this task is influenced").
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterable, Sequence


@dataclass(frozen=True)
class Injection:
    node: str
    kind: str       # 'cpu' | 'disk' | 'network'
    start: float
    end: float
    level: float = 0.9   # target utilization (cpu/disk) or bytes/s fraction of cap

    @property
    def duration(self) -> float:
        return self.end - self.start


def overlap(a0: float, a1: float, b0: float, b1: float) -> float:
    """Length of [a0,a1] ∩ [b0,b1]."""
    return max(0.0, min(a1, b1) - max(a0, b0))


class InjectionSchedule:
    def __init__(self, injections: Iterable[Injection] = ()) -> None:
        self.injections = list(injections)

    def __iter__(self):
        return iter(self.injections)

    def __len__(self) -> int:
        return len(self.injections)

    def for_node(self, node: str) -> list[Injection]:
        return [i for i in self.injections if i.node == node]

    def active(self, node: str, kind: str, t: float) -> float:
        """Max injected level of ``kind`` on ``node`` at time ``t`` (0 if none)."""
        level = 0.0
        for inj in self.injections:
            if inj.node == node and inj.kind == kind and inj.start <= t < inj.end:
                level = max(level, inj.level)
        return level

    def affected(self, node: str, kind: str, t0: float, t1: float,
                 min_overlap: float = 0.0) -> bool:
        """Did an injection of ``kind`` on ``node`` overlap [t0, t1]?"""
        return any(
            inj.node == node and inj.kind == kind
            and overlap(t0, t1, inj.start, inj.end) > min_overlap
            for inj in self.injections
        )

    # -- constructors ----------------------------------------------------------
    @staticmethod
    def intermittent(
        node: str,
        kind: str,
        job_duration: float,
        period: float = 25.0,
        burst: float = 12.0,
        level: float = 0.9,
        t0: float = 0.0,
    ) -> "InjectionSchedule":
        """Paper §IV-B.1: start the AG on one node intermittently."""
        injections = []
        t = t0
        while t < job_duration:
            injections.append(Injection(node, kind, t, min(t + burst, job_duration), level))
            t += period
        return InjectionSchedule(injections)

    @staticmethod
    def random_multi_node(
        nodes: Sequence[str],
        job_duration: float,
        rng: random.Random,
        kinds: Sequence[str] = ("cpu", "disk", "network"),
        events_per_node: tuple[int, int] = (1, 4),
        burst: float = 10.0,
        level: float = 0.9,
    ) -> "InjectionSchedule":
        """Paper §IV-B.4 / Table IV: random AGs across nodes for random periods."""
        injections = []
        for node in nodes:
            for _ in range(rng.randint(*events_per_node)):
                start = rng.uniform(0.0, max(job_duration - burst, 0.0))
                injections.append(
                    Injection(node, rng.choice(list(kinds)), start, start + burst, level)
                )
        return InjectionSchedule(sorted(injections, key=lambda i: (i.node, i.start)))
