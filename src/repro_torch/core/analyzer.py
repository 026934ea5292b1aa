"""BigRoots root-cause analyzer — vectorized production implementation.

Implements paper §III-B: per stage, build the feature pool, find stragglers
(duration > λs × median), then identify root-cause features via the
kind-specific statistical gates:

- numerical (Eq. 5):  F > global_quantile_{λq}  AND  F > mean(F_peer)·λp,
  where the peer group is *inter-node* or *intra-node* separately (§III-A
  observations 1 & 2 — intra-node peers would be drowned out by the much more
  numerous inter-node tasks if pooled).
- time:      Eq. 5 plus the significance floor F > time_floor (paper: 0.2 —
  a blocking time that is a tiny fraction of the task cannot be the cause).
- resource:  Eq. 5 plus *edge detection* (Eq. 6): utilization that rises when
  the task starts and falls when it ends was generated by the task itself and
  is filtered out; contention already present before the task and persisting
  after it is external and kept.  (The paper's Eq. 6 prose/inequality conflict
  is resolved per the prose — see DESIGN.md §2.)
- discrete (locality, Eq. 7): straggler locality == 2 while normal tasks are
  mostly local: sum(locality(normal)) < num(normal)/2.

The hot path is array-native end to end: stages arrive as columnar
:class:`~repro_torch.core.frame.StageFrame` blocks (dataclass ``StageRecord``
inputs are converted once at the boundary), every gate is boolean-mask
algebra over the ``[n_tasks, n_features]`` matrix, Eq. 6 edge queries for
the whole stage resolve in one batched ``window_means`` call, and all
``RootCause`` records fall out of a single ``np.nonzero``.  The streaming
path's Eq. 5 gate algebra is the one piece that runs on the device: the
fleet sweep packs every window into one batch and evaluates it in one
launch of the CUDA kernel in :mod:`repro_torch.kernels.bigroots_gates`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Protocol, Sequence

import numpy as np

from ..device import resolve_device
from .features import FeatureKind, FeatureSchema
from .fleet import GateStaging, eval_gates_np, pack_windows
from .frame import StageFrame, as_frame
from .records import StageRecord, TaskRecord, Trace
from .straggler import DEFAULT_STRAGGLER_THRESHOLD, straggler_mask
from .window import SlidingStageWindow


class TimelineStore(Protocol):
    """Resource timelines used by edge detection (Eq. 6).

    ``window_mean`` returns the mean value of ``metric`` on ``node`` over
    ``[t0, t1]``, or None when no samples cover the window (edge detection is
    then skipped for that task — the conservative choice: keep the feature).

    Stores may additionally provide the batched form
    ``window_means(nodes, metrics, t0s, t1s) -> np.ndarray`` (NaN where no
    samples cover a window); the analyzer uses it to resolve all edge
    queries of a stage in one call instead of 2×stragglers×features Python
    round-trips.  :class:`repro_torch.telemetry.timeline.ResourceTimeline` does.
    """

    def window_mean(self, node: str, metric: str, t0: float, t1: float) -> float | None: ...


@dataclass(frozen=True)
class BigRootsThresholds:
    """All analysis thresholds (paper §IV-B.2 'quantile/median thresholds')."""

    quantile: float = 0.9        # λq in Eq. 5
    peer_mean: float = 1.5       # λp in Eq. 5
    time_floor: float = 0.2      # the F > 0.2 gate for TIME features
    edge_filter: float = 0.5     # λe in Eq. 6 ("filter threshold")
    edge_width: float = 3.0      # seconds monitored before/after ("edge width")
    straggler: float = DEFAULT_STRAGGLER_THRESHOLD  # λs (Mantri 1.5×median)


#: Version of the Attribution record layout.  Bump when fields change
#: meaning; wire consumers (v3 attribution block) check it before trusting
#: the numbers.
ATTRIBUTION_VERSION = 1


@dataclass(frozen=True)
class Attribution:
    """What-if counterfactual price of one cause (``repro_torch.core.whatif``).

    ``estimated_recovery_s`` is the stage critical-path (barrier makespan)
    time recovered if the implicated task's duration were rebased to its
    Eq. 5 peer mean; ``throughput_delta`` is that recovery as a fraction
    of the stage's baseline wall time (``baseline_s``) — the share of the
    step the fleet gets back.  ``cumulative_recovery_s`` is maintained by
    :class:`~repro_torch.core.window.RootCauseStream`: the recovery this cause
    key accumulated across dedup/decay/re-emit cycles (equal to
    ``estimated_recovery_s`` on first emission).  A shared critical path
    is split equally among the causes implicating the same task, so
    per-stage attributions never double count (see ``repro_torch.core.whatif``).
    """

    estimated_recovery_s: float
    throughput_delta: float
    cumulative_recovery_s: float
    tasks_rebased: int
    baseline_s: float
    version: int = ATTRIBUTION_VERSION


@dataclass(frozen=True)
class RootCause:
    """One identified (straggler task, feature) root cause."""

    task_id: str
    stage_id: str
    node: str
    feature: str
    kind: FeatureKind
    value: float              # normalized feature value F
    peer_groups: tuple[str, ...]  # which observation fired: 'inter' and/or 'intra'
    guidance: str = ""
    # Escalation level assigned by RootCauseStream on re-emergence after a
    # decay cycle (1 = first sighting; see repro_torch.core.window.CauseState),
    # capped at RootCauseStream.MAX_SEVERITY.
    severity: int = 1
    # What-if counterfactual price (repro_torch.core.whatif), attached only when
    # an attributor runs — attribution off leaves it None and the cause
    # stream byte-identical to an unattributed build.
    attribution: Attribution | None = None

    @property
    def key(self) -> tuple[str, str]:
        return (self.task_id, self.feature)


#: Gate-bit → peer-group tags shared by every emission site: bit0 = the
#: inter-node Eq. 5 gate fired, bit1 = intra-node, 4 = a stage-level
#: finding (discrete Eq. 7 locality, or synthesized fleet findings).
GROUP_TABLE: dict[int, tuple[str, ...]] = {
    0: (), 1: ("inter",), 2: ("intra",), 3: ("inter", "intra"),
    4: ("stage",),
}


def build_causes(
    schema: FeatureSchema,
    stage_id: str,
    task_ids: Sequence[str],
    nodes: Sequence[str],
    cols: Sequence[int],
    vals: Sequence[float],
    gbits: Sequence[int],
) -> list[RootCause]:
    """The single gate-driven :class:`RootCause` emission path.

    Every analyzer construction site (batch ``analyze_stage``, the
    streaming ``_finish_window`` used by both per-window analysis and the
    ``analyze_fleet`` sweep) lands here with per-fired-pair parallel
    sequences, so the schema-coupled fields (kind, guidance) and the
    peer-group vocabulary (:data:`GROUP_TABLE`) live in exactly one
    place.  Synthesized findings that never gated (host dropout) go
    through :func:`synthesize_cause` instead.
    """
    specs = schema.specs
    names = schema.names
    causes: list[RootCause] = []
    for tid, node, j, value, gb in zip(task_ids, nodes, cols, vals, gbits):
        spec = specs[j]
        causes.append(
            RootCause(
                task_id=tid,
                stage_id=stage_id,
                node=node,
                feature=names[j],
                kind=spec.kind,
                value=float(value),
                peer_groups=GROUP_TABLE[gb],
                guidance=spec.guidance,
            )
        )
    return causes


def synthesize_cause(
    *,
    task_id: str,
    stage_id: str,
    node: str,
    feature: str,
    value: float,
    guidance: str,
    kind: FeatureKind = FeatureKind.DISCRETE,
    peer_groups: tuple[str, ...] = ("fleet",),
    severity: int = 1,
) -> RootCause:
    """Construction path for causes that never passed the Eq. 5 gates
    (e.g. the fleet aggregator's ``host_dropout`` escalation): the same
    pipeline schema as :func:`build_causes`, for findings synthesized from
    liveness/operational signals rather than feature columns."""
    return RootCause(
        task_id=task_id, stage_id=stage_id, node=node, feature=feature,
        kind=kind, value=float(value), peer_groups=peer_groups,
        guidance=guidance, severity=severity,
    )


# -- wire form (StepDelta v3 attribution block) ------------------------------

def attribution_to_wire(a: Attribution) -> dict:
    """JSON-able dict with a fixed key order (byte-stable headers)."""
    return {
        "estimated_recovery_s": a.estimated_recovery_s,
        "throughput_delta": a.throughput_delta,
        "cumulative_recovery_s": a.cumulative_recovery_s,
        "tasks_rebased": a.tasks_rebased,
        "baseline_s": a.baseline_s,
        "version": a.version,
    }


def attribution_from_wire(d: dict) -> Attribution:
    return Attribution(
        estimated_recovery_s=float(d["estimated_recovery_s"]),
        throughput_delta=float(d["throughput_delta"]),
        cumulative_recovery_s=float(d["cumulative_recovery_s"]),
        tasks_rebased=int(d["tasks_rebased"]),
        baseline_s=float(d["baseline_s"]),
        version=int(d.get("version", ATTRIBUTION_VERSION)),
    )


def cause_to_wire(c: RootCause) -> dict:
    """JSON-able form of a cause for the StepDelta v3 attribution block
    (``repro_torch.telemetry.events``).  Key order is fixed so re-serializing a
    decoded cause is byte-identical."""
    return {
        "task_id": c.task_id,
        "stage_id": c.stage_id,
        "node": c.node,
        "feature": c.feature,
        "kind": c.kind.name,
        "value": c.value,
        "peer_groups": list(c.peer_groups),
        "guidance": c.guidance,
        "severity": c.severity,
        "attribution": (
            None if c.attribution is None
            else attribution_to_wire(c.attribution)
        ),
    }


def cause_from_wire(d: dict) -> RootCause:
    a = d.get("attribution")
    return RootCause(
        task_id=str(d["task_id"]),
        stage_id=str(d["stage_id"]),
        node=str(d["node"]),
        feature=str(d["feature"]),
        kind=FeatureKind[d["kind"]],
        value=float(d["value"]),
        peer_groups=tuple(d["peer_groups"]),
        guidance=str(d.get("guidance", "")),
        severity=int(d.get("severity", 1)),
        attribution=None if a is None else attribution_from_wire(a),
    )


class StageAnalysis:
    """Per-stage result: stragglers found + root causes emitted.

    ``straggler_scales`` (duration / median per straggler — the Fig. 3-6
    y-axis values) is built lazily: during an incident sweep a window can
    carry thousands of stragglers, and formatting a dict nobody reads
    costs more than the Eq. 5 gates themselves.  Constructing with an
    explicit dict (or the ``scales_fn`` deferred form) are equivalent;
    the property materializes once and caches.
    """

    __slots__ = ("stage_id", "num_tasks", "straggler_ids", "root_causes",
                 "median_duration", "_scales", "_scales_fn")

    def __init__(
        self,
        stage_id: str,
        num_tasks: int,
        straggler_ids: list[str],
        root_causes: list[RootCause],
        median_duration: float,
        straggler_scales: dict[str, float] | None = None,
        *,
        scales_fn=None,
    ) -> None:
        self.stage_id = stage_id
        self.num_tasks = num_tasks
        self.straggler_ids = straggler_ids
        self.root_causes = root_causes
        self.median_duration = median_duration
        self._scales_fn = scales_fn
        self._scales = (
            straggler_scales if straggler_scales is not None
            else (None if scales_fn is not None else {})
        )

    @property
    def straggler_scales(self) -> dict[str, float]:
        if self._scales is None:
            self._scales = self._scales_fn()
            self._scales_fn = None
        return self._scales

    def __repr__(self) -> str:  # keep the old dataclass-ish debugging shape
        return (
            f"StageAnalysis(stage_id={self.stage_id!r}, "
            f"num_tasks={self.num_tasks}, "
            f"stragglers={len(self.straggler_ids)}, "
            f"root_causes={len(self.root_causes)}, "
            f"median_duration={self.median_duration})"
        )


def normalize_features(
    tasks: Sequence[TaskRecord], schema: FeatureSchema
) -> tuple[np.ndarray, np.ndarray]:
    """Build the normalized feature matrix F[tasks, features] (paper Table II).

    numerical → raw / stage_mean(raw); time → raw / task_duration;
    resource → raw (Eq. 1-3 already produce window-normalized utilization);
    discrete → raw locality code.  Returns (F, durations).

    Thin wrapper over :meth:`StageFrame.normalized` kept for API
    compatibility; array-native callers should build a frame once instead.
    """
    frame = StageFrame.from_tasks("", list(tasks), schema)
    return frame.normalized(), np.maximum(frame.durations, 1e-12)


def _peer_means(F: np.ndarray, node_idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-task inter-node and intra-node peer means, vectorized.

    inter_mean[i, k] = mean of F[:, k] over tasks on nodes != node(i)
    intra_mean[i, k] = mean of F[:, k] over tasks on node(i), excluding i
    Entries with an empty peer group are NaN.
    """
    n, k = F.shape
    num_nodes = int(node_idx.max()) + 1 if n else 0
    # Per-node column sums in ONE flattened bincount over node_idx·k + col
    # (no Python loop over feature columns; same row-ascending accumulation
    # order per bin as the per-column form, so results are bit-identical).
    flat_idx = (node_idx[:, None] * k + np.arange(k, dtype=np.int64)).ravel()
    node_sum = np.bincount(
        flat_idx, weights=F.ravel(), minlength=num_nodes * k
    ).reshape(num_nodes, k)
    node_cnt = np.bincount(node_idx, minlength=num_nodes).astype(np.float64)
    total_sum = F.sum(axis=0)

    cnt_i = node_cnt[node_idx]                    # tasks on my node
    inter_cnt = n - cnt_i
    intra_cnt = cnt_i - 1.0

    with np.errstate(invalid="ignore", divide="ignore"):
        inter = (total_sum[None, :] - node_sum[node_idx]) / inter_cnt[:, None]
        intra = (node_sum[node_idx] - F) / intra_cnt[:, None]
    inter[inter_cnt <= 0] = np.nan
    intra[intra_cnt <= 0] = np.nan
    return inter, intra


def _lazy_scales(ids: list[str], durs: np.ndarray, median: float):
    """Deferred straggler_scales builder (see StageAnalysis docstring);
    ``durs`` must be an owned copy — live-window buffers churn."""
    def scales_fn() -> dict[str, float]:
        if median > 0:
            return {t: d / median for t, d in zip(ids, durs.tolist())}
        return {t: 0.0 for t in ids}

    return scales_fn


def _unpack_gbits(gbits: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Kernel gate bits → (fired, gate_inter, gate_intra) bool matrices.

    The kernel reports inter/intra bits only where the full Eq. 5 gate
    fired (0 elsewhere); emission reads the bits only at fired positions,
    so the sparser matrices are interchangeable with the numpy path's
    dense ones.
    """
    return gbits > 0, (gbits & 1) > 0, (gbits & 2) > 0


class BigRootsAnalyzer:
    """The paper's analyzer (Fig. 1 workflow) over a :class:`Trace` or
    :class:`~repro_torch.core.frame.TraceStore`.

    Streaming gate evaluation is backend-switched: ``backend="torch"``
    (default) dispatches windows of at least ``backend_min_rows`` live
    rows — and every :meth:`analyze_fleet` sweep — through the batched
    Eq. 5 gate kernel in ``repro_torch.kernels.bigroots_gates`` on
    ``device``, fed by the ``repro_torch.core.fleet`` packer;
    ``backend="numpy"`` evaluates the gates in-process (the oracle).
    ``device=None`` means the GPU and raises when there is none; the CPU
    is used only when the caller names it, and then the kernel's plain
    PyTorch version runs.  A failure to build, load or launch the kernel
    raises — there is no quiet switch to numpy.  Straggler detection,
    Eq. 6 edge detection, Eq. 7 locality voting and RootCause emission
    always run host-side; the backends are byte-identical on the
    equivalence suite (float64 end to end).

    Fleet-scale use: shard per-host telemetry, merge it launcher-side
    (``TraceStore.merge`` / ``SlidingStageWindow.merge`` /
    :class:`repro_torch.serve.FleetAggregator`), and run :meth:`analyze_fleet`
    over the merged windows — Eq. 5's inter-node peer groups only exist
    after the merge, so N per-host analyses are not a substitute.
    """

    BACKENDS = ("numpy", "torch")

    def __init__(
        self,
        schema: FeatureSchema,
        thresholds: BigRootsThresholds = BigRootsThresholds(),
        timelines: TimelineStore | None = None,
        window_exact_quantiles: bool = False,
        backend: str = "torch",
        backend_min_rows: int = 4096,
        device=None,
    ) -> None:
        if backend not in self.BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r} (expected one of {self.BACKENDS})"
            )
        self.schema = schema
        self.thresholds = thresholds
        self.timelines = timelines
        # Streaming (SlidingStageWindow) path: use exact np.quantile for the
        # λq gate instead of the window's P² sketch.  Slower (O(n) per
        # feature per analyze) but bit-identical to the batch path — the
        # reference mode for equivalence tests.
        self.window_exact_quantiles = window_exact_quantiles
        # Gate-evaluation backend for the streaming path (see class
        # docstring): "numpy" evaluates gates in-process; "torch" routes
        # windows with at least ``backend_min_rows`` live rows (and every
        # ``analyze_fleet`` sweep) through
        # ``repro_torch.kernels.bigroots_gates`` on ``device``.
        self.backend = backend
        self.backend_min_rows = int(backend_min_rows)
        self.device = resolve_device(device)
        self._tl_cursor = None
        self._pack_scratch = None  # reused FleetGateBatch (see pack_windows)
        self.staging = GateStaging(self.device)

    # -- public API ----------------------------------------------------------
    def analyze(self, trace) -> list[StageAnalysis]:
        """Analyze every stage of a Trace (StageRecords) or TraceStore
        (StageFrames) — both expose ``stages()``."""
        return [self.analyze_stage(stage) for stage in trace.stages()]

    def root_causes(self, trace) -> list[RootCause]:
        out: list[RootCause] = []
        for sa in self.analyze(trace):
            out.extend(sa.root_causes)
        return out

    # -- per stage -------------------------------------------------------------
    def analyze_stage(
        self, stage: StageRecord | StageFrame | SlidingStageWindow
    ) -> StageAnalysis:
        if isinstance(stage, SlidingStageWindow):
            return self._analyze_window(stage)
        frame = as_frame(stage, self.schema)
        n = len(frame)
        if n == 0:
            return StageAnalysis(frame.stage_id, 0, [], [], 0.0)
        th = self.thresholds
        schema = self.schema
        durations = frame.durations
        median = float(np.median(durations))
        smask = straggler_mask(durations, th.straggler)

        F = frame.normalized()
        inter, intra = _peer_means(F, frame.node_codes)

        # Eq. 5 gates, vectorized over the whole stage.
        with np.errstate(invalid="ignore"):
            q = np.quantile(F, th.quantile, axis=0)            # global_quantile_λq
            gate_q = F > q[None, :]
            gate_inter = F > inter * th.peer_mean
            gate_intra = F > intra * th.peer_mean
        # NaN peer means (empty peer group) must not fire.
        gate_inter &= ~np.isnan(inter)
        gate_intra &= ~np.isnan(intra)

        # Kind-specific rules as mask algebra over [n, F].
        fired = smask[:, None] & gate_q & (gate_inter | gate_intra)
        tcols = schema.cols_of_kind(FeatureKind.TIME)
        if tcols.size:
            fired[:, tcols] &= F[:, tcols] > th.time_floor
        rcols = schema.cols_of_kind(FeatureKind.RESOURCE)
        if rcols.size and self.timelines is not None:
            ii, kk = np.nonzero(fired[:, rcols])
            if ii.size:
                jj = rcols[kk]
                keep = self._edge_keep_batch(frame, ii, jj, F[ii, jj])
                drop = ~keep
                fired[ii[drop], jj[drop]] = False
        dcols = schema.cols_of_kind(FeatureKind.DISCRETE)
        if dcols.size:
            # Eq. 7: straggler reads remotely while normal tasks are local.
            normal_loc = frame.locality[~smask]
            locality_vote = float(normal_loc.sum()) < normal_loc.size / 2.0
            disc = smask & (frame.locality == 2) & locality_vote
            fired[:, dcols] = disc[:, None]

        straggler_idx = np.nonzero(smask)[0]
        straggler_ids = [frame.task_ids[i] for i in straggler_idx]

        causes: list[RootCause] = []
        ci, cj = np.nonzero(fired)
        if ci.size:
            is_disc = np.zeros(len(schema), dtype=bool)
            if dcols.size:
                is_disc[dcols] = True
            gbits = (
                gate_inter[ci, cj].astype(np.int8)
                + 2 * gate_intra[ci, cj].astype(np.int8)
            )
            gbits[is_disc[cj]] = 4
            causes = build_causes(
                schema, frame.stage_id,
                [frame.task_ids[i] for i in ci.tolist()],
                [frame.node_of(i) for i in ci.tolist()],
                cj.tolist(), F[ci, cj].tolist(), gbits.tolist(),
            )
        return StageAnalysis(
            stage_id=frame.stage_id,
            num_tasks=n,
            straggler_ids=straggler_ids,
            root_causes=causes,
            median_duration=median,
            scales_fn=_lazy_scales(straggler_ids, durations[straggler_idx],
                                   median),
        )

    # -- streaming (sliding-window) path ------------------------------------
    def _analyze_window(self, w: SlidingStageWindow) -> StageAnalysis:
        """Incremental ``analyze_stage`` over a live sliding window.

        Reuses the window's running aggregates instead of recomputing the
        stage: the λq gate reads the P² sketch (or exact quantiles below
        :data:`MIN_SKETCH_SAMPLES` live rows / in
        ``window_exact_quantiles`` mode), peer means come from the running
        per-node Σv / counts, and the gate matrices are built for the
        straggler rows only — O(stragglers · F) gate work plus two light
        O(n) vector passes (median, straggler mask) per call, against the
        batch path's full O(n · F) normalize + quantile + peer-matrix
        recompute.  All gates are evaluated in the window's per-row-fixed
        gate space (see ``repro_torch.core.window``), which is equivalent to the
        batch normalization for every rule.

        Gate evaluation dispatches on :attr:`backend`: windows with at
        least :attr:`backend_min_rows` live rows route through the gate
        kernel (``repro_torch.kernels.bigroots_gates``); smaller windows
        and ``backend="numpy"`` stay in-process.
        """
        if self.schema.signature != w.schema.signature:
            # Foreign schema: fall back through the sealed frame.
            return self.analyze_stage(w.seal())
        pre = self._window_prelude(w)
        if isinstance(pre, StageAnalysis):
            return pre
        n, median, s_rows, straggler_ids, scales_fn = pre
        V = w.v[s_rows]                          # [s, F] gate-space values
        # quantiles() itself falls back to exact below MIN_SKETCH_SAMPLES
        # live rows or on a λq mismatch with the window's sketch.
        q = w.quantiles(self.thresholds.quantile,
                        exact=self.window_exact_quantiles)
        if self.backend != "numpy" and n >= self.backend_min_rows:
            batch = pack_windows([(w, s_rows, n, V, q)], self.schema,
                                 self.thresholds.time_floor,
                                 scratch=self._pack_scratch,
                                 pin=self._pin)
            self._pack_scratch = batch
            gbits = self._eval_gates_batch(batch)[0, : V.shape[0]]
            fired, gate_inter, gate_intra = _unpack_gbits(gbits)
        else:
            fired, gate_inter, gate_intra = self._gates_numpy(w, s_rows, n, V, q)
        return self._finish_window(w, n, median, s_rows, straggler_ids,
                                   scales_fn, V, fired, gate_inter, gate_intra)

    def _window_prelude(
        self, w: SlidingStageWindow
    ) -> StageAnalysis | tuple[int, float, np.ndarray, list[str], object]:
        """Straggler detection over a live window: O(n) median + mask.
        Returns a finished StageAnalysis for the trivial cases (empty
        window, no stragglers), else ``(n, median, s_rows, straggler_ids,
        scales_fn)``."""
        n = w.live_count
        if n == 0:
            return StageAnalysis(w.stage_id, 0, [], [], 0.0)
        sl = w.live_slice()
        durations = w.live_durations()  # zero-copy view on the slice path
        median = float(np.median(durations))
        th = self.thresholds
        smask = durations > th.straggler * median  # straggler_mask, median reused
        s_local = np.nonzero(smask)[0]
        s_rows = (sl.start + s_local) if sl is not None else w.live_index()[s_local]
        straggler_ids = w.task_ids_at(s_rows)
        scales_fn = _lazy_scales(straggler_ids, durations[s_local], median)
        if s_rows.size == 0:
            return StageAnalysis(w.stage_id, n, [], [], median,
                                 scales_fn=scales_fn)
        return n, median, s_rows, straggler_ids, scales_fn

    def _gates_numpy(
        self,
        w: SlidingStageWindow,
        s_rows: np.ndarray,
        n: int,
        V: np.ndarray,
        q: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Eq. 5 gates over the straggler rows, in-process numpy."""
        th = self.thresholds
        codes = w.node_codes[s_rows]
        cnt_i = w.node_counts[codes]
        inter_cnt = n - cnt_i
        intra_cnt = cnt_i - 1.0
        node_vsum = w.node_vsums[codes]
        with np.errstate(invalid="ignore", divide="ignore"):
            inter = (w.vsum[None, :] - node_vsum) / inter_cnt[:, None]
            intra = (node_vsum - V) / intra_cnt[:, None]
        inter[inter_cnt <= 0] = np.nan
        intra[intra_cnt <= 0] = np.nan
        with np.errstate(invalid="ignore"):
            gate_q = V > q[None, :]
            gate_inter = V > inter * th.peer_mean
            gate_intra = V > intra * th.peer_mean
        gate_inter &= ~np.isnan(inter)
        gate_intra &= ~np.isnan(intra)
        return gate_q & (gate_inter | gate_intra), gate_inter, gate_intra

    @property
    def _pin(self) -> bool:
        """Pack into pinned host memory when the batch goes to a GPU."""
        return self.backend == "torch" and self.device.type == "cuda"

    def _eval_gates_batch(self, batch) -> np.ndarray:
        """Run a packed FleetGateBatch through the selected gate backend:
        the kernel on :attr:`device` (``"torch"``) or the numpy oracle."""
        th = self.thresholds
        if self.backend == "torch":
            return self.staging.run(batch, th.peer_mean)
        return eval_gates_np(batch, th.peer_mean)

    def analyze_fleet(self, windows) -> list[StageAnalysis]:
        """Fleet sweep: analyze many sliding windows with ONE batched gate
        evaluation (a single kernel launch on the torch backend).

        Per window the O(n) prelude (median, straggler mask) and the
        post-gate stages (Eq. 6 edge detection, Eq. 7 locality, emission)
        run host-side exactly as in :meth:`analyze_stage`; only the Eq. 5
        gate algebra is packed across windows (``repro_torch.core.fleet``) and
        dispatched on :attr:`backend` — results are byte-identical to
        per-window analysis for every backend.  Non-window stages and
        foreign-schema windows fall back to :meth:`analyze_stage`.
        """
        windows = list(windows)
        results: list[StageAnalysis | None] = [None] * len(windows)
        entries: list[tuple] = []
        for i, w in enumerate(windows):
            if not isinstance(w, SlidingStageWindow) or (
                self.schema.signature != w.schema.signature
            ):
                results[i] = self.analyze_stage(w)
                continue
            pre = self._window_prelude(w)
            if isinstance(pre, StageAnalysis):
                results[i] = pre
                continue
            n, median, s_rows, straggler_ids, scales_fn = pre
            V = w.v[s_rows]
            q = w.quantiles(self.thresholds.quantile,
                            exact=self.window_exact_quantiles)
            entries.append((i, w, n, median, s_rows, straggler_ids, scales_fn,
                            V, q))
        if entries:
            batch = pack_windows(
                [(w, s_rows, n, V, q)
                 for (_, w, n, _, s_rows, _, _, V, q) in entries],
                self.schema, self.thresholds.time_floor,
                scratch=self._pack_scratch, pin=self._pin,
            )
            self._pack_scratch = batch
            gbits = self._eval_gates_batch(batch)
            for k, (i, w, n, median, s_rows, straggler_ids, scales_fn, V, q) in (
                enumerate(entries)
            ):
                fired, gate_inter, gate_intra = _unpack_gbits(
                    gbits[k, : V.shape[0]]
                )
                results[i] = self._finish_window(
                    w, n, median, s_rows, straggler_ids, scales_fn, V,
                    fired, gate_inter, gate_intra,
                )
        return results

    def _finish_window(
        self,
        w: SlidingStageWindow,
        n: int,
        median: float,
        s_rows: np.ndarray,
        straggler_ids: list[str],
        scales_fn,
        V: np.ndarray,
        fired: np.ndarray,
        gate_inter: np.ndarray,
        gate_intra: np.ndarray,
    ) -> StageAnalysis:
        """Kind-specific post-gates (TIME floor, NUMERICAL guard, Eq. 6
        edge detection, Eq. 7 locality) + RootCause emission.  The guards
        are idempotent re-applications on the kernel path (the kernel
        already folded them in) and the authoritative pass on the numpy
        path."""
        th = self.thresholds
        schema = self.schema
        codes = w.node_codes[s_rows]
        # Numerical columns: the batch path zeroes the whole column when the
        # stage mean is <= 0 (every gate false); apply the same guard here.
        num = schema.cols_of_kind(FeatureKind.NUMERICAL)
        means = np.ones(len(schema), dtype=np.float64)
        if num.size:
            means[num] = w.vsum[num] / n
            fired[:, num] &= means[num] > 0
        tcols = schema.cols_of_kind(FeatureKind.TIME)
        if tcols.size:
            fired[:, tcols] &= V[:, tcols] > th.time_floor
        rcols = schema.cols_of_kind(FeatureKind.RESOURCE)
        if rcols.size and self.timelines is not None:
            ii, kk = np.nonzero(fired[:, rcols])
            if ii.size:
                jj = rcols[kk]
                rows = s_rows[ii]
                names = schema.names
                keep = self._edge_keep(
                    [w.node_name(int(c)) for c in w.node_codes[rows]],
                    [names[j] for j in jj.tolist()],
                    w.starts[rows], w.ends[rows], V[ii, jj],
                    self._window_timelines(),
                )
                drop = ~keep
                fired[ii[drop], jj[drop]] = False
        dcols = schema.cols_of_kind(FeatureKind.DISCRETE)
        if dcols.size:
            s_loc = w.locality[s_rows]
            normal_loc_sum = w.locality_sum - float(s_loc.sum())
            normal_n = n - s_rows.size
            locality_vote = normal_loc_sum < normal_n / 2.0
            disc = (s_loc == 2) & locality_vote
            fired[:, dcols] = disc[:, None]

        causes: list[RootCause] = []
        ci, cj = np.nonzero(fired)
        if ci.size:
            # Emission metadata, vectorized per fired pair: reported value
            # (batch-normalized F for numerical columns) and gate bits;
            # the shared builder turns the parallel sequences into causes.
            vals = V[ci, cj] / means[cj]
            is_disc = np.zeros(len(schema), dtype=bool)
            if dcols.size:
                is_disc[dcols] = True
            gbits = (
                gate_inter[ci, cj].astype(np.int8)
                + 2 * gate_intra[ci, cj].astype(np.int8)
            )
            gbits[is_disc[cj]] = 4
            causes = build_causes(
                schema, w.stage_id,
                [straggler_ids[i] for i in ci.tolist()],
                [w.node_name(int(codes[i])) for i in ci.tolist()],
                cj.tolist(), vals.tolist(), gbits.tolist(),
            )
        return StageAnalysis(
            stage_id=w.stage_id,
            num_tasks=n,
            straggler_ids=straggler_ids,
            root_causes=causes,
            median_duration=median,
            scales_fn=scales_fn,
        )

    def _window_timelines(self):
        """Timeline store for streaming Eq. 6 queries: an incremental cursor
        when the store offers one (step-loop queries advance monotonically,
        so the cursor skips re-searching the whole series), else the store
        itself."""
        tl = self.timelines
        if tl is not None and hasattr(tl, "cursor"):
            if self._tl_cursor is None or self._tl_cursor.timeline is not tl:
                self._tl_cursor = tl.cursor()
            return self._tl_cursor
        return tl

    # -- helpers -----------------------------------------------------------
    def _edge_keep_batch(
        self,
        frame: StageFrame,
        ii: np.ndarray,
        jj: np.ndarray,
        values: np.ndarray,
    ) -> np.ndarray:
        names = self.schema.names
        return self._edge_keep(
            [str(frame.node_names[c]) for c in frame.node_codes[ii]],
            [names[j] for j in jj.tolist()],
            frame.starts[ii], frame.ends[ii], values, self.timelines,
        )

    def _edge_keep(
        self,
        nodes: list[str],
        metrics: list[str],
        starts: np.ndarray,
        ends: np.ndarray,
        values: np.ndarray,
        tl,
    ) -> np.ndarray:
        """Edge detection (Eq. 6) for candidate (task, feature) pairs: keep
        only *external* contention.

        The paper's prose: utilization that *rises after the task begins and
        drops after it ends* was generated by the task itself → filter it out.
        So a feature is filtered iff BOTH edges are present (head AND tail
        below λe × during-task level); contention persisting on either side
        of the window is external and kept.  (A task that outlives a
        contention burst still shows the high head edge.)
        A missing head or tail window (no samples) skips the filter (keep).
        """
        th = self.thresholds
        if hasattr(tl, "window_means"):
            head = np.asarray(
                tl.window_means(nodes, metrics, starts - th.edge_width, starts),
                dtype=np.float64,
            )
            tail = np.asarray(
                tl.window_means(nodes, metrics, ends, ends + th.edge_width),
                dtype=np.float64,
            )
        else:  # protocol-minimal store: per-query fallback
            head = np.empty(len(nodes), dtype=np.float64)
            tail = np.empty(len(nodes), dtype=np.float64)
            for x, (node, metric) in enumerate(zip(nodes, metrics)):
                h = tl.window_mean(node, metric,
                                   float(starts[x]) - th.edge_width,
                                   float(starts[x]))
                t = tl.window_mean(node, metric, float(ends[x]),
                                   float(ends[x]) + th.edge_width)
                head[x] = np.nan if h is None else h
                tail[x] = np.nan if t is None else t
        with np.errstate(invalid="ignore"):
            external = (head > th.edge_filter * values) | (
                tail > th.edge_filter * values
            )
        return external | np.isnan(head) | np.isnan(tail)


def found_set(causes: Iterable[RootCause]) -> set[tuple[str, str]]:
    """(task_id, feature) pairs — the unit of the paper's TP/FP accounting."""
    return {c.key for c in causes}
