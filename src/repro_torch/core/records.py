"""Task/stage data model for BigRoots root-cause analysis.

The unit of analysis is the *task* (paper §II-A): in Spark, one parallel
computation inside a stage; in this framework, one host's execution of one
training/serving step (see DESIGN.md §2 for the mapping).  A *stage* groups
the peer tasks a straggler is compared against.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Mapping


@dataclass(frozen=True)
class TaskRecord:
    """One task's raw measurements.

    ``features`` holds *raw* values (bytes, seconds, utilization fractions);
    normalization (``B/B_avg``, ``T/T_task`` — paper Table II) happens inside
    the analyzer so a record is self-describing and stage-independent.
    """

    task_id: str
    stage_id: str
    node: str
    start: float
    end: float
    locality: int = 0  # Eq. 4: 0=PROCESS_LOCAL, 1=NODE_LOCAL, 2=otherwise
    features: Mapping[str, float] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start

    def to_json(self) -> str:
        return json.dumps(
            {
                "task_id": self.task_id,
                "stage_id": self.stage_id,
                "node": self.node,
                "start": self.start,
                "end": self.end,
                "locality": self.locality,
                "features": dict(self.features),
            },
            sort_keys=True,
        )

    @staticmethod
    def from_json(line: str) -> "TaskRecord":
        obj = json.loads(line)
        return TaskRecord(
            task_id=obj["task_id"],
            stage_id=obj["stage_id"],
            node=obj["node"],
            start=obj["start"],
            end=obj["end"],
            locality=obj.get("locality", 0),
            features=obj.get("features", {}),
        )


@dataclass
class StageRecord:
    """All peer tasks of one stage (the straggler comparison group)."""

    stage_id: str
    tasks: list[TaskRecord] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.tasks)

    def durations(self) -> list[float]:
        return [t.duration for t in self.tasks]

    def nodes(self) -> list[str]:
        return sorted({t.node for t in self.tasks})


class Trace:
    """A job trace: stages in submission order, JSONL round-trippable.

    This is the offline artifact BigRoots analyzes (paper §I advocates offline
    analysis: production jobs repeat, so post-hoc diagnosis is cost-effective).
    """

    def __init__(self, stages: Iterable[StageRecord] = ()) -> None:
        self._stages: dict[str, StageRecord] = {}
        for s in stages:
            self._stages[s.stage_id] = s

    # -- construction -----------------------------------------------------
    def add_task(self, task: TaskRecord) -> None:
        stage = self._stages.setdefault(task.stage_id, StageRecord(task.stage_id))
        stage.tasks.append(task)

    def extend(self, tasks: Iterable[TaskRecord]) -> None:
        for t in tasks:
            self.add_task(t)

    # -- access ------------------------------------------------------------
    def stages(self) -> Iterator[StageRecord]:
        return iter(self._stages.values())

    def stage(self, stage_id: str) -> StageRecord:
        return self._stages[stage_id]

    def stage_ids(self) -> list[str]:
        return list(self._stages)

    @property
    def num_tasks(self) -> int:
        return sum(len(s) for s in self._stages.values())

    def __len__(self) -> int:
        return len(self._stages)

    # -- persistence ---------------------------------------------------------
    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for stage in self.stages():
                for task in stage.tasks:
                    f.write(task.to_json() + "\n")

    @staticmethod
    def load_jsonl(path: str) -> "Trace":
        trace = Trace()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    trace.add_task(TaskRecord.from_json(line))
        return trace
