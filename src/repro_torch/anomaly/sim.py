"""SimCluster: a deterministic Spark-like cluster simulator.

The paper verifies BigRoots on a 6-node Spark cluster by injecting resource
anomalies and checking the analyzer attributes stragglers to them (§IV).
This container has one CPU core, so the verification experiments run against
a seeded discrete-event simulation that reproduces the moving parts the
paper's experiments depend on:

- stages of parallel tasks scheduled onto per-node executor slots,
- per-task framework features with controllable skew (data/shuffle/GC/locality),
- per-node 1 Hz resource timelines (baseline noise + task self-load +
  injected anomalies) — the exact store edge detection (Eq. 6) reads,
- task durations that *respond* to external contention overlapping their
  window (so injections really produce stragglers),
- ground truth: which (task, resource feature) pairs an injection affected.

Everything is driven by one ``random.Random(seed)`` so tables are exactly
reproducible; the real anomaly generators in ``generators.py`` serve the
live-host demos instead.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field, replace

from ..core.records import TaskRecord, Trace
from ..telemetry.timeline import ResourceTimeline
from .injector import Injection, InjectionSchedule, overlap

RESOURCE_KINDS = ("cpu", "disk", "network")

# Delay seconds added per second of overlap at injection level 1.0.
# Calibrated to the paper's Fig. 7 ordering: disk > cpu > network.
DEFAULT_SENSITIVITY = {"cpu": 0.55, "disk": 0.85, "network": 0.08}

NET_CAP = 125e6  # 1 Gbps in bytes/s (paper's cluster interconnect)


@dataclass(frozen=True)
class WorkloadProfile:
    """Statistical shape of one Hibench-like workload (paper Table VI)."""

    name: str
    num_stages: int = 4
    tasks_per_stage: int = 40
    base_duration: float = 10.0
    duration_noise: float = 0.15        # lognormal sigma on the base
    # data / shuffle skew: with `skew_prob`, a task is 'hot' ×`skew_mag`
    read_bytes_mean: float = 64e6
    read_skew_prob: float = 0.0
    read_skew_mag: float = 8.0
    shuffle_mean: float = 16e6
    shuffle_skew_prob: float = 0.0
    shuffle_skew_mag: float = 10.0
    # how strongly duration follows bytes (data-dependence of runtime)
    bytes_weight: float = 0.7
    # GC behaviour
    gc_frac: float = 0.02               # baseline fraction of duration in GC
    gc_heavy_prob: float = 0.0          # prob of a GC-thrashing task
    gc_heavy_frac: float = 0.45
    # spills
    spill_prob: float = 0.0
    spill_bytes: float = 32e6
    # locality
    remote_prob: float = 0.02           # task reads remotely (locality=2)
    remote_delay: float = 6.0           # seconds added for remote read
    # task self resource usage — NODE-level utilization fraction the task
    # drives while running (drives edge-detection realism: a compute-bound
    # straggler shows high CPU *during its own window only*)
    cpu_self: tuple[float, float] = (0.02, 0.08)
    cpu_heavy_prob: float = 0.0         # compute-bound tasks (self ~0.5-0.85)
    disk_self: tuple[float, float] = (0.01, 0.05)
    io_heavy_prob: float = 0.0
    net_self_frac: float = 0.01        # fraction of NET_CAP a task uses
    # sensitivity to external contention
    sensitivity: dict = field(default_factory=lambda: dict(DEFAULT_SENSITIVITY))


# Profiles shaped after the paper's Table VI findings per workload.
WORKLOAD_PROFILES: dict[str, WorkloadProfile] = {
    "kmeans": WorkloadProfile(
        name="kmeans", num_stages=6, shuffle_skew_prob=0.10, shuffle_skew_mag=14.0,
        gc_heavy_prob=0.01, cpu_heavy_prob=0.05, io_heavy_prob=0.03),
    "bayes": WorkloadProfile(
        name="bayes", num_stages=5, shuffle_skew_prob=0.03, shuffle_skew_mag=9.0,
        cpu_heavy_prob=0.03),
    "lr": WorkloadProfile(
        name="lr", num_stages=8, read_skew_prob=0.18, read_skew_mag=10.0,
        io_heavy_prob=0.02, tasks_per_stage=60),
    "pca": WorkloadProfile(
        name="pca", num_stages=10, duration_noise=0.55, tasks_per_stage=60,
        cpu_heavy_prob=0.04, io_heavy_prob=0.03),
    "svm": WorkloadProfile(
        name="svm", num_stages=8, read_skew_prob=0.25, read_skew_mag=12.0,
        tasks_per_stage=60, net_self_frac=0.03, io_heavy_prob=0.05),
    "sort": WorkloadProfile(
        name="sort", num_stages=3, io_heavy_prob=0.12, disk_self=(0.05, 0.15),
        tasks_per_stage=30),
    "terasort": WorkloadProfile(name="terasort", num_stages=3, tasks_per_stage=30),
    "wordcount": WorkloadProfile(name="wordcount", num_stages=3, tasks_per_stage=30),
    "nweight": WorkloadProfile(
        name="nweight", num_stages=6, cpu_heavy_prob=0.10, net_self_frac=0.06,
        cpu_self=(0.05, 0.12)),
    "aggregation": WorkloadProfile(name="aggregation", num_stages=3, tasks_per_stage=30),
    "pagerank": WorkloadProfile(
        name="pagerank", num_stages=6, cpu_heavy_prob=0.08, cpu_self=(0.05, 0.12)),
    # The verification workload of §IV-B (NaiveBayes with large input).
    "naivebayes_large": WorkloadProfile(
        name="naivebayes_large", num_stages=6, tasks_per_stage=50,
        shuffle_skew_prob=0.04, shuffle_skew_mag=8.0, cpu_heavy_prob=0.04),
}


@dataclass
class _SimTask:
    task_id: str
    stage_id: str
    node: str
    start: float
    end: float
    locality: int
    features: dict[str, float]
    cpu_self: float
    disk_self: float
    net_self: float
    organic: frozenset = frozenset()  # features genuinely perturbed by the workload


@dataclass
class SimResult:
    trace: Trace
    timelines: ResourceTimeline
    truth: set[tuple[str, str]]          # union of AG-injected and organic causes
    job_duration: float
    schedule: InjectionSchedule
    profile: WorkloadProfile
    truth_ag: set[tuple[str, str]] = field(default_factory=set)       # injected
    truth_organic: set[tuple[str, str]] = field(default_factory=set)  # workload-intrinsic


class SimCluster:
    """Deterministic cluster: N nodes × S executor slots, FIFO stages."""

    def __init__(
        self,
        nodes: int = 5,
        slots_per_node: int = 4,
        seed: int = 0,
        profile: WorkloadProfile | str = "naivebayes_large",
        node_prefix: str = "slave",
        sample_hz: float = 1.0,
    ) -> None:
        if isinstance(profile, str):
            profile = WORKLOAD_PROFILES[profile]
        self.profile = profile
        self.nodes = [f"{node_prefix}{i + 1}" for i in range(nodes)]
        self.slots_per_node = slots_per_node
        self.seed = seed
        self.sample_dt = 1.0 / sample_hz

    # ------------------------------------------------------------------------
    def run(self, schedule: InjectionSchedule | None = None) -> SimResult:
        schedule = schedule or InjectionSchedule()
        rng = random.Random(self.seed)
        p = self.profile

        slots: list[tuple[str, int]] = [
            (node, s) for node in self.nodes for s in range(self.slots_per_node)
        ]
        free_at = {slot: 0.0 for slot in slots}
        tasks: list[_SimTask] = []
        stage_start = 0.0

        for stage_idx in range(p.num_stages):
            stage_id = f"stage{stage_idx:03d}"
            for slot in slots:
                free_at[slot] = max(free_at[slot], stage_start)
            for ti in range(p.tasks_per_stage):
                slot = min(slots, key=lambda s: free_at[s])
                node = slot[0]
                t0 = free_at[slot]
                task = self._make_task(rng, stage_id, stage_idx, ti, node, t0,
                                       schedule, tasks)
                free_at[slot] = task.end
                tasks.append(task)
            stage_start = max(free_at[slot] for slot in slots)

        job_end = max(t.end for t in tasks)
        timelines = self._build_timelines(tasks, schedule, job_end, rng)
        self._attach_resource_features(tasks, timelines)
        trace = Trace()
        for t in tasks:
            trace.add_task(
                TaskRecord(
                    task_id=t.task_id, stage_id=t.stage_id, node=t.node,
                    start=t.start, end=t.end, locality=t.locality,
                    features=t.features,
                )
            )
        truth_ag = self._ground_truth(tasks, schedule)
        truth_organic = {
            (t.task_id, feat) for t in tasks for feat in t.organic
        }
        return SimResult(
            trace=trace, timelines=timelines, truth=truth_ag | truth_organic,
            job_duration=job_end, schedule=schedule, profile=p,
            truth_ag=truth_ag, truth_organic=truth_organic,
        )

    # ------------------------------------------------------------------------
    def _make_task(
        self,
        rng: random.Random,
        stage_id: str,
        stage_idx: int,
        ti: int,
        node: str,
        t0: float,
        schedule: InjectionSchedule,
        scheduled: list["_SimTask"] | None = None,
    ) -> _SimTask:
        p = self.profile
        organic: set[str] = set()
        base = p.base_duration * math.exp(rng.gauss(0.0, p.duration_noise))

        read_bytes = p.read_bytes_mean * math.exp(rng.gauss(0.0, 0.1))
        if rng.random() < p.read_skew_prob:
            read_bytes *= p.read_skew_mag
            organic.add("read_bytes")
        shuffle_read = p.shuffle_mean * math.exp(rng.gauss(0.0, 0.1))
        shuffle_write = p.shuffle_mean * 0.5 * math.exp(rng.gauss(0.0, 0.1))
        if rng.random() < p.shuffle_skew_prob:
            shuffle_read *= p.shuffle_skew_mag
            shuffle_write *= p.shuffle_skew_mag * 0.5
            organic.add("shuffle_read_bytes")
            organic.add("shuffle_write_bytes")

        # Runtime follows data volume (data skew ⇒ straggler).
        data_factor = (
            (1.0 - p.bytes_weight)
            + p.bytes_weight
            * 0.5
            * (read_bytes / p.read_bytes_mean + shuffle_read / p.shuffle_mean)
        )
        dur = base * data_factor

        if rng.random() < p.gc_heavy_prob:
            gc_frac = p.gc_heavy_frac
            organic.add("jvm_gc_time")
        else:
            gc_frac = p.gc_frac
        locality = 2 if rng.random() < p.remote_prob else (
            1 if rng.random() < 0.1 else 0
        )
        if locality == 2:
            dur += p.remote_delay
            organic.add("locality")
        dur *= 1.0 + gc_frac  # GC pauses extend the task

        mem_spill = p.spill_bytes if rng.random() < p.spill_prob else 0.0
        disk_spill = mem_spill * 0.5

        cpu_self = rng.uniform(*p.cpu_self)
        if rng.random() < p.cpu_heavy_prob:
            cpu_self = rng.uniform(0.5, 0.85)
            dur *= 1.6  # compute-bound tasks run long (edge-detection cases)
        disk_self = rng.uniform(*p.disk_self)
        if rng.random() < p.io_heavy_prob:
            disk_self = rng.uniform(0.5, 0.85)
            dur *= 1.5
        net_self = p.net_self_frac * NET_CAP * rng.uniform(0.5, 1.5)

        # External contention delay (injections + heavy co-runners already
        # scheduled on this node): two-pass fixed point on the window.
        # Heavy co-runners are the organic "busy machine" channel — their
        # victims straggle with genuinely external high utilization, exactly
        # the resource findings of the paper's Table VI.
        #
        # Per-task response heterogeneity: real tasks respond very unevenly
        # to the same contention (paper §IV-B.4: "the resource contention AG
        # generates may not cause task delay"; §IV-B.1: duration and features
        # "not linearly correlated" — the stated reason PCC underperforms).
        # A lognormal response factor per (task, resource) models that.
        response = {
            k: math.exp(rng.gauss(-0.18, 0.6)) for k in RESOURCE_KINDS
        }
        co_heavy = []
        if scheduled is not None:
            co_heavy = [
                (x, ("cpu", x.cpu_self)) for x in scheduled
                if x.node == node and x.end > t0 and x.cpu_self >= 0.3
            ] + [
                (x, ("disk", x.disk_self)) for x in scheduled
                if x.node == node and x.end > t0 and x.disk_self >= 0.3
            ]
        end = t0 + dur
        contention_delay = {k: 0.0 for k in RESOURCE_KINDS}
        for _ in range(2):
            delay = {k: 0.0 for k in RESOURCE_KINDS}
            for kind in RESOURCE_KINDS:
                sens = p.sensitivity.get(kind, 0.0) * response[kind]
                for inj in schedule.for_node(node):
                    if inj.kind != kind:
                        continue
                    delay[kind] += sens * inj.level * overlap(
                        t0, end, inj.start, inj.end
                    )
            for x, (kind, level) in co_heavy:
                delay[kind] += (
                    p.sensitivity.get(kind, 0.0) * response[kind] * level
                    * overlap(t0, end, x.start, x.end)
                )
            contention_delay = delay
            end = t0 + dur + sum(delay.values())
        dur_final = end - t0
        # co-runner contention that meaningfully delayed this task is a
        # genuine (organic) resource root cause
        for kind, d in contention_delay.items():
            inj_part = sum(
                p.sensitivity.get(kind, 0.0) * response[kind] * inj.level
                * overlap(t0, end, inj.start, inj.end)
                for inj in schedule.for_node(node) if inj.kind == kind
            )
            if d - inj_part > max(0.5, 0.05 * dur_final):
                organic.add(kind)

        features = {
            "read_bytes": read_bytes,
            "shuffle_read_bytes": shuffle_read,
            "shuffle_write_bytes": shuffle_write,
            "memory_bytes_spilled": mem_spill,
            "disk_bytes_spilled": disk_spill,
            "jvm_gc_time": gc_frac * dur_final,
            "serialize_time": rng.uniform(0.005, 0.02) * dur_final,
            "deserialize_time": rng.uniform(0.005, 0.02) * dur_final,
        }
        return _SimTask(
            task_id=f"{stage_id}/t{ti:04d}",
            stage_id=stage_id,
            node=node,
            start=t0,
            end=end,
            locality=locality,
            features=features,
            cpu_self=cpu_self,
            disk_self=disk_self,
            net_self=net_self,
            organic=frozenset(organic),
        )

    # ------------------------------------------------------------------------
    def _build_timelines(
        self,
        tasks: list[_SimTask],
        schedule: InjectionSchedule,
        job_end: float,
        rng: random.Random,
    ) -> ResourceTimeline:
        tl = ResourceTimeline()
        by_node: dict[str, list[_SimTask]] = {n: [] for n in self.nodes}
        for t in tasks:
            by_node[t.node].append(t)
        # Pad one edge-width past the job so tail windows have samples.
        horizon = job_end + 10.0
        for node in self.nodes:
            node_tasks = by_node[node]
            t = 0.0
            while t <= horizon:
                running = [x for x in node_tasks if x.start <= t < x.end]
                cpu = min(
                    0.05 + 0.02 * rng.random()
                    + sum(x.cpu_self for x in running)
                    + schedule.active(node, "cpu", t),
                    1.0,
                )
                disk = min(
                    0.02 + 0.02 * rng.random()
                    + sum(x.disk_self for x in running)
                    + schedule.active(node, "disk", t),
                    1.0,
                )
                net = (
                    0.005 * NET_CAP * rng.random()
                    + sum(x.net_self for x in running)
                    + schedule.active(node, "network", t) * NET_CAP
                )
                tl.record(node, "cpu", t, cpu)
                tl.record(node, "disk", t, disk)
                tl.record(node, "network", t, net)
                t += self.sample_dt
        return tl

    def _attach_resource_features(
        self, tasks: list[_SimTask], tl: ResourceTimeline
    ) -> None:
        """Eq. 1-3: task resource features = window means over the task."""
        for t in tasks:
            for metric in RESOURCE_KINDS:
                val = tl.window_mean(t.node, metric, t.start, t.end)
                t.features[metric] = val if val is not None else 0.0

    def _ground_truth(
        self, tasks: list[_SimTask], schedule: InjectionSchedule
    ) -> set[tuple[str, str]]:
        """(task, resource feature) pairs genuinely affected by an injection.

        Paper §IV-B: a task is influenced when its window overlaps the
        injection period; require the overlap to be non-trivial (>1 s or
        >10% of the task) to exclude grazing contact.
        """
        truth: set[tuple[str, str]] = set()
        for t in tasks:
            dur = t.end - t.start
            min_ov = min(1.0, 0.1 * dur)
            for kind in RESOURCE_KINDS:
                if schedule.affected(t.node, kind, t.start, t.end, min_overlap=min_ov):
                    truth.add((t.task_id, kind))
        return truth


def perturbed_profile(base: WorkloadProfile, **overrides) -> WorkloadProfile:
    return replace(base, **overrides)
