"""What-if counterfactual replay: price each confirmed cause in recovered
step time.

BigRoots (Eq. 5/6/7) says *why* a task straggled; the what-if question
(arXiv 2505.05713, "Understanding Stragglers in Large Model Training
Using What-if Analysis") is *how much it cost*.  For every confirmed
:class:`~repro_torch.core.analyzer.RootCause`, :class:`WhatIfReplayer` replays
the implicated stage with that cause removed — the straggler's duration
rebased to its Eq. 5 peer mean — and emits an
:class:`~repro_torch.core.analyzer.Attribution` carrying

- ``estimated_recovery_s``: the stage critical-path (barrier makespan)
  time recovered by the rebase, and
- ``throughput_delta``: that recovery as a fraction of the stage's
  baseline wall time — the share of the step the fleet gets back.

Rebase rule (per cause, per the Eq. 5 peer groups that fired): the
inter-node peer mean duration when ``"inter"`` is among the cause's
``peer_groups``, the intra-node peer mean for intra-only findings, the
stage mean for stage-level (discrete / synthesized) findings.  The rebase
is clamped so it never *slows* a task (``min(duration, peer_mean)``), and
only straggler rows (duration > λs × stage median — the same Mantri
threshold the analyzer uses) are rebased at all, so a cause with no
straggler row attributes exactly 0.

The critical-path re-solve is batched exactly like the Eq. 5 gate
kernel: every touched stage packs into one padded ``[W, R]`` batch (the
``pack_windows`` row-bucket idiom from ``repro_torch.core.fleet``), and a
single top-2 reduction produces all per-row counterfactual makespans —
removing row *i* leaves ``max(second_max, rebased_end_i)`` unless the
max is tied, in which case removing one copy changes nothing.
``backend="torch"`` (default) runs the reduction on ``device`` in float64
torch ops; ``backend="numpy"`` is the same arithmetic in-process (the
oracle).  Only max, compare and subtract are involved, so the two agree
exactly.  ``device=None`` means the GPU and raises when there is none.

Invariants (pinned in ``tests/test_whatif.py``):

- every attribution is non-negative;
- per stage, attributed recoveries sum to at most the stage's straggler
  excess over peer mean — a shared critical path is split *equally*
  among the causes implicating the same task, never double counted;
- a cause whose task has no straggler row in the source attributes
  exactly 0 (and a cause whose stage the source does not hold at all is
  left unattributed: ``attribution is None``).
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..device import resolve_device
from .analyzer import Attribution, RootCause
from .features import FeatureSchema
from .frame import as_frame
from .straggler import DEFAULT_STRAGGLER_THRESHOLD
from .window import SlidingStageWindow

#: Pad the row axis of the replay batch to multiples of this (the
#: ``pack_windows`` bucket), which keeps the batch shapes stable across
#: ticks and guarantees R >= 2 for the top-2 reduction.
ROW_BUCKET = 256


def _replay_np(
    ends: np.ndarray, rebased: np.ndarray, mask: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row counterfactual makespans over a padded ``[W, R]`` batch.

    Returns ``(t0[W], recovery[W, R])`` where ``t0`` is each window's
    baseline makespan (max live end) and ``recovery[w, i]`` the makespan
    reduction from replacing row i's end with ``rebased[w, i]``.  The
    numpy oracle for the torch backend (same arithmetic, same shapes).
    """
    neg = np.where(mask, ends, -np.inf)
    order = np.sort(neg, axis=1)
    top1 = order[:, -1]
    top2 = order[:, -2]
    tied = (neg == top1[:, None]).sum(axis=1) > 1
    excl = np.where(
        (neg == top1[:, None]) & ~tied[:, None], top2[:, None], top1[:, None]
    )
    t_cf = np.maximum(excl, np.where(mask, rebased, -np.inf))
    rec = np.where(mask, np.maximum(top1[:, None] - t_cf, 0.0), 0.0)
    return top1, rec


def _replay_torch(
    ends: torch.Tensor, rebased: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_replay_np` on tensors (float64 ``ends``/``rebased``, bool
    ``mask``, all ``[W, R]`` on one device): the same max / compare /
    subtract arithmetic, so the result is exactly the oracle's."""
    ninf = torch.full_like(ends, -torch.inf)
    neg = torch.where(mask, ends, ninf)
    top = torch.topk(neg, 2, dim=1).values
    top1 = top[:, 0:1]
    top2 = top[:, 1:2]
    at_top = neg == top1
    tied = at_top.sum(dim=1, keepdim=True) > 1
    excl = torch.where(at_top & ~tied, top2, top1)
    t_cf = torch.maximum(excl, torch.where(mask, rebased, ninf))
    rec = torch.where(mask, (top1 - t_cf).clamp(min=0.0),
                      torch.zeros_like(ends))
    return top1[:, 0], rec


def _peer_mean_durations(
    durs: np.ndarray, codes: np.ndarray
) -> tuple[np.ndarray, np.ndarray, float]:
    """Per-row inter-node / intra-node peer mean *durations* (the Eq. 5
    peer groups applied to the duration column) plus the stage mean.
    Empty peer groups fall back to the stage mean."""
    n = durs.size
    num_nodes = int(codes.max()) + 1 if n else 0
    node_sum = np.bincount(codes, weights=durs, minlength=num_nodes)
    node_cnt = np.bincount(codes, minlength=num_nodes).astype(np.float64)
    total = float(durs.sum())
    stage_mean = total / n if n else 0.0
    cnt_i = node_cnt[codes]
    with np.errstate(invalid="ignore", divide="ignore"):
        inter = (total - node_sum[codes]) / (n - cnt_i)
        intra = (node_sum[codes] - durs) / (cnt_i - 1.0)
    inter = np.where(n - cnt_i > 0, inter, stage_mean)
    intra = np.where(cnt_i - 1.0 > 0, intra, stage_mean)
    return inter, intra, stage_mean


class _StageView:
    """Uniform columnar view over one stage of any supported source."""

    __slots__ = ("n", "starts", "ends", "durs", "codes", "row_of")

    def __init__(self, n, starts, ends, durs, codes, task_ids) -> None:
        self.n = n
        self.starts = starts
        self.ends = ends
        self.durs = durs
        self.codes = codes
        self.row_of = {tid: i for i, tid in enumerate(task_ids)}


class WhatIfReplayer:
    """Counterfactual replay engine over live windows / trace stores.

    ``attribute(source, causes)`` returns the causes with
    :class:`~repro_torch.core.analyzer.Attribution` attached wherever ``source``
    holds the implicated stage (others keep ``attribution=None``), after
    one batched critical-path re-solve over every touched stage.
    ``source`` may be a single
    :class:`~repro_torch.core.window.SlidingStageWindow`, anything exposing
    ``stages()`` (``StreamingTraceStore`` / ``TraceStore`` / ``Trace``),
    or a ``StageFrame``/``StageRecord``.

    This is the attributor :class:`~repro_torch.core.window.RootCauseStream`
    (and through it :class:`~repro_torch.serve.FleetAggregator` /
    ``Diagnosis.local(attribution=True)``) plugs in; it is stateless
    across calls, so one instance can
    serve many streams.
    """

    BACKENDS = ("numpy", "torch")

    def __init__(
        self,
        schema: FeatureSchema | None = None,
        *,
        backend: str = "torch",
        row_bucket: int = ROW_BUCKET,
        straggler_threshold: float = DEFAULT_STRAGGLER_THRESHOLD,
        device=None,
    ) -> None:
        if backend not in self.BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r} (expected one of {self.BACKENDS})"
            )
        self.schema = schema
        self.backend = backend
        self.device = resolve_device(device)
        self.row_bucket = max(int(row_bucket), 2)
        self.straggler_threshold = float(straggler_threshold)
        # stage_id -> joint recovery of the last attribute() call: the
        # makespan reduction with *every* implicated row rebased at once
        # (what acting on the whole diagnosis would buy — per-cause
        # exclusive recoveries shadow each other when stragglers are
        # concurrent, so their sum under-prices a multi-straggler stage).
        self.last_stage_recovery: dict[str, float] = {}

    # -- source adaptation --------------------------------------------------
    def _stage_view(self, stage) -> _StageView:
        if isinstance(stage, SlidingStageWindow):
            idx = stage.live_index()
            return _StageView(
                idx.size,
                stage.starts[idx], stage.ends[idx],
                stage.durations[idx], stage.node_codes[idx],
                stage.task_ids_at(idx),
            )
        frame = as_frame(stage, self.schema) if self.schema is not None \
            else stage
        return _StageView(
            len(frame), frame.starts, frame.ends,
            np.maximum(frame.durations, 0.0), frame.node_codes,
            frame.task_ids,
        )

    def _stage_map(self, source) -> dict:
        if isinstance(source, SlidingStageWindow):
            return {source.stage_id: source}
        stages = getattr(source, "stages", None)
        if stages is not None:
            return {s.stage_id: s for s in stages()}
        return {source.stage_id: source}

    # -- backend dispatch ---------------------------------------------------
    def _run(self, ends, rebased, mask):
        if self.backend == "torch":
            dev = self.device
            t0, rec = _replay_torch(
                torch.from_numpy(ends).to(dev),
                torch.from_numpy(rebased).to(dev),
                torch.from_numpy(mask).to(dev),
            )
            return t0.cpu().numpy(), rec.cpu().numpy()
        return _replay_np(ends, rebased, mask)

    # -- the replay ---------------------------------------------------------
    def attribute(self, source, causes) -> list[RootCause]:
        """One replay tick: rebase, batched critical-path re-solve, and
        per-cause :class:`~repro_torch.core.analyzer.Attribution` attach."""
        causes = list(causes)
        if not causes:
            return causes
        stages = self._stage_map(source)
        touched: dict[str, list[int]] = {}
        for k, c in enumerate(causes):
            if c.stage_id in stages:
                touched.setdefault(c.stage_id, []).append(k)
        if not touched:
            return causes
        views = {sid: self._stage_view(stages[sid]) for sid in touched}
        max_rows = max(v.n for v in views.values())
        bucket = self.row_bucket
        R = max(bucket, -(-max_rows // bucket) * bucket)
        W = len(touched)
        ends = np.zeros((W, R), dtype=np.float64)
        rebased = np.zeros((W, R), dtype=np.float64)
        mask = np.zeros((W, R), dtype=bool)

        # Per stage: straggler mask, peer-mean rebase targets, and the
        # row -> causes fan-out (a shared row's recovery splits equally).
        plans = []  # (sid, w_idx, view, baseline_s, row -> [cause idx])
        for w_idx, (sid, kks) in enumerate(touched.items()):
            v = views[sid]
            row_causes: dict[int, list[int]] = {}
            if v.n:
                ends[w_idx, : v.n] = v.ends
                rebased[w_idx, : v.n] = v.ends
                mask[w_idx, : v.n] = True
                median = float(np.median(v.durs))
                smask = v.durs > self.straggler_threshold * median
                inter, intra, stage_mean = _peer_mean_durations(
                    v.durs, v.codes
                )
                for k in kks:
                    c = causes[k]
                    row = v.row_of.get(c.task_id)
                    if row is None or not smask[row]:
                        continue
                    if "inter" in c.peer_groups:
                        peer = float(inter[row])
                    elif "intra" in c.peer_groups:
                        peer = float(intra[row])
                    else:
                        peer = stage_mean
                    target = min(float(v.durs[row]), max(peer, 0.0))
                    new_end = float(v.starts[row]) + target
                    rebased[w_idx, row] = min(rebased[w_idx, row], new_end)
                    row_causes.setdefault(row, []).append(k)
                baseline = float(v.ends.max() - v.starts.min())
            else:
                baseline = 0.0
            plans.append((sid, w_idx, v, baseline, row_causes))

        t0, rec = self._run(ends, rebased, mask)

        out = causes
        self.last_stage_recovery = {
            sid: (
                max(
                    float(t0[w_idx])
                    - float(np.where(mask[w_idx], rebased[w_idx],
                                     -np.inf).max()),
                    0.0,
                )
                if v.n else 0.0
            )
            for sid, w_idx, v, _baseline, _rc in plans
        }
        for sid, w_idx, v, baseline, row_causes in plans:
            attributed: dict[int, Attribution] = {}
            for row, kks in row_causes.items():
                share = float(rec[w_idx, row]) / len(kks)
                moved = rebased[w_idx, row] < ends[w_idx, row]
                for k in kks:
                    attributed[k] = Attribution(
                        estimated_recovery_s=share,
                        throughput_delta=(
                            share / baseline if baseline > 0 else 0.0
                        ),
                        cumulative_recovery_s=share,
                        tasks_rebased=1 if moved else 0,
                        baseline_s=baseline,
                    )
            zero = None
            for k in touched[sid]:
                a = attributed.get(k)
                if a is None:
                    # Stage found but no straggler row to rebase: the
                    # counterfactual is exactly today — attribute 0.
                    if zero is None:
                        zero = Attribution(
                            estimated_recovery_s=0.0,
                            throughput_delta=0.0,
                            cumulative_recovery_s=0.0,
                            tasks_rebased=0,
                            baseline_s=baseline,
                        )
                    a = zero
                out[k] = replace(out[k], attribution=a)
        return out
