"""Sliding stage windows: the streaming, in-loop analysis substrate.

:class:`~repro_torch.core.frame.TraceStore` is append-only — its stages are resealed
whole per query, so running BigRoots *inside* the train/serve loop
re-pays O(n·F) work every step.  A :class:`SlidingStageWindow` is the
always-on counterpart: it ingests task rows incrementally, retires rows
that fall out of the stage window, and maintains the running aggregates
the analyzer's Eq. 5/6/7 gates need, so
``BigRootsAnalyzer.analyze_stage(window)`` costs O(changed rows) for
aggregate maintenance plus two light O(n) vector passes (median /
straggler mask) instead of a full reseal + recompute.

Layout & lifecycle
------------------
Rows live in the same SoA column layout as :class:`~repro_torch.core.frame.StageFrame`
(``starts/ends/locality/raw/present`` plus the derived gate-space matrix
``v``, see below), appended at the tail of capacity-doubled buffers.
Retirement is by tombstone: a ``live`` mask row is cleared and the row's
contribution is subtracted from every running aggregate — O(retired · F),
order-independent, so out-of-order arrivals and boundary-straddling tasks
need no re-sort.  When the buffer fills or dead rows outnumber live ones,
*epoch compaction* copies the live rows to the front, recomputes every
aggregate exactly (cancelling float drift from add/subtract cycles), and
re-anchors the quantile sketch from the live rows; node codes stay stable
across compactions (the node table is append-only — hosts are a bounded
fleet, dead nodes just hold zero counts).

Retirement policy: a row is live while ``end > watermark`` — a task that
*straddles* the boundary (started before it, still running after) stays in
the window; only tasks that finished at or before the watermark retire.
The watermark advances via :meth:`advance` (time-based ``span``) and/or a
``max_rows`` cap (oldest-by-end rows beyond the cap retire).  A row whose
``end`` is already at or below the watermark on arrival is counted in
``late_drops`` and never ingested.

Gate space (``v``)
------------------
Every Eq. 5 gate can be evaluated on a per-row-fixed value: TIME features
normalize by the row's own duration (fixed at ingest), RESOURCE/DISCRETE
are raw, and NUMERICAL gates are scale-invariant — ``F/mean > q(F/mean)``
iff ``raw > q(raw)`` for a positive stage mean, for the quantile and both
peer-mean gates alike (all sides share the 1/mean factor).  So the window
stores ``v`` (raw with TIME columns duration-normalized), keeps running
``Σv`` / ``Σv²`` / per-node ``Σv`` for peer means, and feeds the quantile
sketch with ``v`` rows; the analyzer only divides by the stage mean when
*reporting* a numerical cause's value (and force-drops numerical gates
when the mean is ≤ 0, matching the batch path's all-zero column).

λq sketch maintenance
---------------------
Single-row adds stream into a :class:`~repro_torch.core.sketch.P2ColumnSketch`
(O(1) per row).  P² supports neither deletion nor batch absorption, so
retirement and bulk :meth:`add_rows` accumulate *sketch lag*; once lag
exceeds ``sketch_lag_frac ×`` live rows the next :meth:`quantiles` call
re-anchors the sketch exactly from the live window (amortized O(changed)).
Below :data:`~repro_torch.core.sketch.MIN_SKETCH_SAMPLES` live rows the gate is
exact ``np.quantile`` — tiny stages answer seed-identically.

Multi-host merge
----------------
:meth:`SlidingStageWindow.merge` is the launcher-side aggregation
primitive: it unions other windows' live rows into this one under a
reconciled (max) watermark, re-encodes node codes through a shared
vocabulary, then recomputes every running aggregate exactly and re-anchors
the sketch — analyzing a merged window is byte-identical to analyzing the
union of surviving rows (``tests/test_merge.py``).
:meth:`StreamingTraceStore.merge` lifts it per stage, and
:class:`repro_torch.serve.FleetAggregator` drives it from per-host wire deltas.

:class:`StreamingTraceStore` is the multi-stage container (TraceStore's
streaming sibling): ``add_row``/``add_rows`` route to per-stage windows and
``stages()`` yields the windows themselves so ``analyzer.analyze(store)``
takes the incremental path per stage.  :class:`RootCauseStream` is the
in-loop face: analyze-after-each-step with emit-once deduping that
*decays* — confirmations are suppressed while a cause stays hot, re-emitted
with escalated severity when it re-confirms after ``decay_steps`` clean
windows, and forgotten entirely after ``forget_steps``, so the dedup state
stays bounded over an unbounded serve loop (see the class docstring).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import Iterator, Mapping, Sequence

import numpy as np

from .features import FeatureKind, FeatureSchema
from .frame import StageFrame
from .records import TaskRecord
from .sketch import MIN_SKETCH_SAMPLES, P2ColumnSketch, exact_quantile


class SlidingStageWindow:
    """One stage as a sliding window of task rows with running aggregates.

    Ingest via :meth:`add_row` (per task) or :meth:`add_rows` (one step's
    columnar fleet report); retire via :meth:`advance` / ``max_rows``;
    analyze incrementally with ``BigRootsAnalyzer.analyze_stage(window)``;
    union per-host windows launcher-side with :meth:`merge`.

    Parameters
    ----------
    stage_id, schema:
        As for :class:`~repro_torch.core.frame.StageFrame`.
    span:
        Seconds of task-*end* time retained behind the watermark
        (``advance(now)`` retires rows with ``end <= now - span``).
        ``None`` disables time-based retirement.
    max_rows:
        Cap on live rows; the oldest rows by ``end`` retire beyond it.
        ``None`` disables the cap.
    quantile:
        λq tracked by the P² sketch (must match the analyzer's
        ``thresholds.quantile`` for the sketch to serve the gate; a
        mismatched query falls back to the exact computation).
    sketch_lag_frac:
        Re-anchor the sketch from live rows once
        ``changed-rows-since-anchor > frac × live``.
    """

    _INITIAL = 64
    #: Process-wide creation counter: `uid` distinguishes a window object
    #: from a later one recreated under the same stage_id (consumers that
    #: cache per-stage state, e.g. RootCauseStream's change stamps, key on
    #: it so a drop-and-recreate never aliases the old window).
    _uids = itertools.count()

    def __init__(
        self,
        stage_id: str,
        schema: FeatureSchema,
        *,
        span: float | None = None,
        max_rows: int | None = None,
        quantile: float = 0.9,
        sketch_lag_frac: float = 1.0,
        p2_batch_limit: int = 32,
    ) -> None:
        # span=None and max_rows=None is legal: an unbounded window (pure
        # streaming aggregates, no retirement).
        self.stage_id = stage_id
        self.schema = schema
        self.uid = next(SlidingStageWindow._uids)
        self.span = None if span is None else float(span)
        self.max_rows = None if max_rows is None else int(max_rows)
        self.quantile = float(quantile)
        self.sketch_lag_frac = float(sketch_lag_frac)
        self.p2_batch_limit = int(p2_batch_limit)
        self._col = schema.col_index
        self._loc_j = self._col.get("locality")
        k = len(schema)
        self._tcols = schema.cols_of_kind(FeatureKind.TIME)

        cap = self._INITIAL
        self._n = 0                      # rows in buffers (live + dead)
        self.live_count = 0
        # Live rows are *usually* the contiguous block [_live_lo, _n): adds
        # append at the tail, and in-order retirement eats the head.  While
        # that invariant holds, analyze-time reads are zero-copy slice
        # views; an out-of-order retirement breaks it (fancy-index gathers
        # until the next compaction restores it).
        self._live_lo = 0
        self._contig = True
        self._task_ids = np.empty(cap, dtype=object)
        self._live = np.zeros(cap, dtype=bool)
        self._node_codes = np.zeros(cap, dtype=np.int64)
        self._starts = np.zeros(cap, dtype=np.float64)
        self._ends = np.zeros(cap, dtype=np.float64)
        self._durs = np.zeros(cap, dtype=np.float64)
        self._locality = np.zeros(cap, dtype=np.int16)
        self._raw = np.zeros((cap, k), dtype=np.float64)
        self._present = np.zeros((cap, k), dtype=bool)
        self._v = np.zeros((cap, k), dtype=np.float64)
        self._extras: dict[int, dict[str, float]] = {}

        self._node_names: list[str] = []
        self._node_index: dict[str, int] = {}
        self._node_cnt = np.zeros(0, dtype=np.float64)
        self._node_vsum = np.zeros((0, k), dtype=np.float64)

        self.vsum = np.zeros(k, dtype=np.float64)
        self.vsumsq = np.zeros(k, dtype=np.float64)
        self.locality_sum = 0.0

        self._sketch = P2ColumnSketch(self.quantile, k)
        self._sketch_lag = 0
        self._q_cache: np.ndarray | None = None

        self.watermark = -np.inf
        self.t_max = -np.inf
        self.total_added = 0
        self.retired_total = 0
        self.late_drops = 0
        self.compactions = 0

    # -- ingest ------------------------------------------------------------
    def add_row(
        self,
        task_id: str,
        node: str,
        start: float,
        end: float,
        locality: int = 0,
        features: Mapping[str, float] | None = None,
    ) -> bool:
        """Ingest one task row; returns False (and drops it) if the row is
        already behind the watermark."""
        end = float(end)
        if end <= self.watermark:
            self.late_drops += 1
            return False
        i = self._append_slot()
        col, loc_j = self._col, self._loc_j
        self._task_ids[i] = task_id
        self._starts[i] = start
        self._ends[i] = end
        self._durs[i] = end - float(start)
        self._locality[i] = locality
        raw_row = self._raw[i]
        present_row = self._present[i]
        raw_row[:] = 0.0
        present_row[:] = False
        if features:
            for name, val in features.items():
                j = col.get(name)
                if j is None or j == loc_j:
                    self._extras.setdefault(i, {})[name] = float(val)
                else:
                    raw_row[j] = float(val)
                    present_row[j] = True
        if loc_j is not None:
            raw_row[loc_j] = locality
        v_row = self._v[i]
        v_row[:] = raw_row
        if self._tcols.size:
            v_row[self._tcols] = raw_row[self._tcols] / max(
                end - float(start), 1e-12
            )
        code = self._node_code(node)
        self._node_codes[i] = code
        self._live[i] = True
        self._n += 1
        self.live_count += 1
        self.total_added += 1
        self.t_max = max(self.t_max, end)
        # aggregates
        self.vsum += v_row
        self.vsumsq += v_row * v_row
        self.locality_sum += locality
        self._node_cnt[code] += 1.0
        self._node_vsum[code] += v_row
        self._sketch.add(v_row)
        self._q_cache = None
        self._enforce_max_rows()
        self._maybe_anchor()
        return True

    def add_rows(
        self,
        task_ids: Sequence[str],
        nodes: Sequence[str],
        starts: np.ndarray,
        ends: np.ndarray,
        locality: np.ndarray | None = None,
        feature_columns: Mapping[str, np.ndarray] | None = None,
        present_columns: Mapping[str, np.ndarray] | None = None,
    ) -> int:
        """Columnar bulk ingest (one step's fleet report): vectorized over
        the batch.  Rows already behind the watermark are dropped; returns
        the number ingested.  Batches larger than ``p2_batch_limit`` skip
        the per-row P² updates and instead add sketch lag (the next
        :meth:`quantiles` past the lag budget re-anchors exactly).

        Feature columns outside the schema are kept per-row as extras —
        the same silent-extras semantics as :meth:`add_row` and the
        TaskRecord dict ingest (telemetry rows carry arbitrary counters),
        deliberately unlike ``StageFrame.from_columns`` which raises.
        Extras never participate in gating.

        ``present_columns`` optionally carries a per-row bool mask per
        feature column: a row whose mask is False is treated as if its
        feature dict lacked the entry (recorded-as-0.0 vs absent — the
        distinction the wire format preserves so sealed TaskRecord views
        round-trip exactly).  Masked-out extras are dropped per row."""
        starts = np.asarray(starts, dtype=np.float64)
        ends = np.asarray(ends, dtype=np.float64)
        m_in = len(task_ids)
        keep = ends > self.watermark
        if not keep.all():
            self.late_drops += int(m_in - keep.sum())
            sel = np.nonzero(keep)[0]
            task_ids = [task_ids[int(x)] for x in sel]
            nodes = [nodes[int(x)] for x in sel]
            starts, ends = starts[sel], ends[sel]
            if locality is not None:
                locality = np.asarray(locality)[sel]
            if feature_columns:
                feature_columns = {
                    nm: np.asarray(c)[sel] for nm, c in feature_columns.items()
                }
            if present_columns:
                present_columns = {
                    nm: np.asarray(c)[sel] for nm, c in present_columns.items()
                }
        m = len(task_ids)
        if m == 0:
            return 0
        k = len(self.schema)
        col, loc_j = self._col, self._loc_j
        raw = np.zeros((m, k), dtype=np.float64)
        present = np.zeros((m, k), dtype=bool)
        loc = (
            np.asarray(locality, dtype=np.int16)
            if locality is not None else np.zeros(m, dtype=np.int16)
        )
        extra_cols: list[tuple[str, np.ndarray, np.ndarray | None]] = []
        for name, vals in (feature_columns or {}).items():
            j = col.get(name)
            mask = (
                np.asarray(present_columns[name], dtype=bool)
                if present_columns and name in present_columns else None
            )
            if j is None or j == loc_j:
                # Outside the schema — or shadowing the locality *field*,
                # which owns that column: keep per-row as extras, exactly
                # the add_row dict semantics (telemetry counters are
                # arbitrary names; the wire path must not die on one).
                extra_cols.append(
                    (name, np.asarray(vals, dtype=np.float64), mask)
                )
                continue
            vals = np.asarray(vals, dtype=np.float64)
            if mask is None:
                raw[:, j] = vals
                present[:, j] = True
            else:
                # Masked-out rows behave exactly as an absent dict entry.
                raw[:, j] = np.where(mask, vals, 0.0)
                present[:, j] = mask
        if loc_j is not None:
            raw[:, loc_j] = loc
        v = raw.copy()
        if self._tcols.size:
            v[:, self._tcols] /= np.maximum(ends - starts, 1e-12)[:, None]

        self._reserve(m)  # compaction-safe: reserve before encoding nodes
        codes = self._encode_batch(nodes)
        i0 = self._n
        sl = slice(i0, i0 + m)
        self._task_ids[sl] = task_ids
        self._starts[sl] = starts
        self._ends[sl] = ends
        self._durs[sl] = ends - starts
        self._locality[sl] = loc
        self._raw[sl] = raw
        self._present[sl] = present
        self._v[sl] = v
        self._node_codes[sl] = codes
        self._live[sl] = True
        for name, vals, mask in extra_cols:
            keep_rows = range(m) if mask is None else np.nonzero(mask)[0].tolist()
            for r in keep_rows:
                self._extras.setdefault(i0 + int(r), {})[name] = float(vals[r])
        self._n += m
        self.live_count += m
        self.total_added += m
        self.t_max = max(self.t_max, float(ends.max()))

        self.vsum += v.sum(axis=0)
        self.vsumsq += (v * v).sum(axis=0)
        self.locality_sum += float(loc.sum())
        self._scatter(codes, v, 1.0)
        if m <= self.p2_batch_limit:
            for row in v:
                self._sketch.add(row)
        else:
            self._sketch_lag += m
        self._q_cache = None
        self._enforce_max_rows()
        self._maybe_anchor()
        return m

    # -- multi-host merge --------------------------------------------------
    def merge(self, *others: "SlidingStageWindow") -> int:
        """Union other windows' live rows into this one (launcher-side
        fleet aggregation).  Returns the number of rows ingested.

        Semantics, in order:

        1. **Watermark reconciliation** — the merged watermark is the max
           over all participants; this window's own live rows at or behind
           it retire (tombstoned, counted in ``retired_total``), and
           another window's live rows behind it are refused on arrival
           (counted in ``late_drops``) — exactly the ``add_row`` late-row
           rule, so "live iff end > watermark" holds fleet-wide.
        2. **Union** — each other's surviving live rows are bulk-copied
           behind this window's rows in argument order (SoA column copies;
           gate-space ``v`` is copied, not recomputed — it is per-row-fixed).
           Node codes re-encode through this window's append-only node
           table, so disjoint and colliding per-host vocabularies both
           merge into one shared vocabulary.
        3. **Exact reconciliation** — every running aggregate (count, Σv,
           Σv², per-node sums) is recomputed exactly from the merged live
           rows and the P² sketch is re-anchored exactly (epoch
           compaction), cancelling each participant's accumulated float
           drift: analyzing the merged window is byte-identical to
           analyzing a window that ingested the union of surviving rows in
           merged order.  ``max_rows`` is then enforced as usual.

        ``others`` are read, never mutated.  Schemas must share a
        signature (a foreign schema raises — seal and re-ingest instead).
        The merged sketch tracks *this* window's ``quantile``.
        """
        if len({id(o) for o in others}) != len(others):
            raise ValueError("the same window appears twice in a merge")
        wm = self.watermark
        for o in others:
            if o is self:
                raise ValueError("cannot merge a window into itself")
            if o.schema.signature != self.schema.signature:
                raise ValueError(
                    f"schema mismatch merging stage {o.stage_id!r} into "
                    f"{self.stage_id!r}: seal() and re-ingest instead"
                )
            wm = max(wm, o.watermark)

        # 1. Retire own rows behind the merged watermark.  Aggregates are
        # recomputed exactly below, so only the masks/counters move here.
        retired = 0
        if wm > self.watermark:
            self.watermark = wm
            dead = self._live[: self._n] & (self._ends[: self._n] <= wm)
            idx = np.nonzero(dead)[0]
            if idx.size:
                self._tombstone(idx)
                self.retired_total += int(idx.size)
                retired += int(idx.size)

        # 2. Bulk-append each other's surviving live rows.  Capacity for
        # the whole union is reserved once up front: per-source reserves
        # would trigger mid-merge epoch compactions whose exact recomputes
        # the final compaction discards anyway.
        picks: list[tuple[SlidingStageWindow, np.ndarray]] = []
        total = 0
        for o in others:
            idx = o.live_index()
            if idx.size:
                keep = o._ends[idx] > wm
                if not keep.all():
                    self.late_drops += int(idx.size - keep.sum())
                    idx = idx[keep]
            if idx.size:
                picks.append((o, idx))
                total += int(idx.size)
        if total:
            self._reserve(total)  # may epoch-compact once; aggregates redone below
        ingested = 0
        for o, idx in picks:
            m = int(idx.size)
            # Shared vocabulary: re-encode the other's codes through this
            # window's node table (grows it; dead nodes hold zero counts).
            remap = np.fromiter(
                (self._node_code(nm) for nm in o._node_names),
                dtype=np.int64, count=len(o._node_names),
            )
            i0 = self._n
            sl = slice(i0, i0 + m)
            self._task_ids[sl] = o._task_ids[idx]
            self._starts[sl] = o._starts[idx]
            self._ends[sl] = o._ends[idx]
            self._durs[sl] = o._durs[idx]
            self._locality[sl] = o._locality[idx]
            self._raw[sl] = o._raw[idx]
            self._present[sl] = o._present[idx]
            self._v[sl] = o._v[idx]
            self._node_codes[sl] = remap[o._node_codes[idx]]
            self._live[sl] = True
            if o._extras:
                for r, oi in enumerate(idx.tolist()):
                    ex = o._extras.get(oi)
                    if ex is not None:
                        self._extras[i0 + r] = dict(ex)
            self._n += m
            self.live_count += m
            self.total_added += m
            self.t_max = max(self.t_max, float(o._ends[idx].max()))
            ingested += m

        # 3. Exact reconciliation (no-op merge skips it: nothing changed).
        if ingested or retired:
            self._compact(self._starts.shape[0])
            self._enforce_max_rows()
        return ingested

    # -- retirement --------------------------------------------------------
    def advance(self, now: float | None = None) -> int:
        """Move the watermark to ``(now or t_max) - span`` and retire rows
        whose ``end`` is at or behind it.  Returns rows retired."""
        retired = 0
        if self.span is not None:
            now = self.t_max if now is None else float(now)
            watermark = now - self.span
            if watermark > self.watermark:
                self.watermark = watermark
                live = self._live[: self._n]
                dead = live & (self._ends[: self._n] <= watermark)
                idx = np.nonzero(dead)[0]
                if idx.size:
                    self._retire_rows(idx)
                    retired += idx.size
        retired += self._enforce_max_rows()
        return retired

    def _enforce_max_rows(self) -> int:
        if self.max_rows is None or self.live_count <= self.max_rows:
            return 0
        excess = self.live_count - self.max_rows
        if self._contig:
            live_idx = None
            ends = self._ends[self._live_lo : self._n]  # view, no copy
        else:
            live_idx = np.nonzero(self._live[: self._n])[0]
            ends = self._ends[live_idx]
        # The cap implies a watermark: the excess-th smallest end becomes the
        # boundary, and the *whole cohort* at or below it retires — so the
        # "live iff end > watermark" invariant holds exactly, ties are never
        # split arbitrarily, and a late arrival at a retired end is refused
        # consistently.  Tied ends can dip the window below max_rows.
        boundary = float(np.partition(ends, excess - 1)[excess - 1])
        self.watermark = max(self.watermark, boundary)
        dead = np.nonzero(ends <= self.watermark)[0]
        rows = (self._live_lo + dead) if live_idx is None else live_idx[dead]
        self._retire_rows(rows)
        return int(dead.size)

    def _tombstone(self, idx: np.ndarray) -> None:
        """Clear live flags for rows ``idx`` and maintain the contiguity
        fast-path bookkeeping (head retirement keeps the live block a
        slice; anything else degrades to fancy indexing until the next
        compaction).  Aggregates and retirement counters are the caller's
        job — merge recomputes them exactly, _retire_rows subtracts."""
        self._live[idx] = False
        if self._contig:
            lo, hi = int(idx.min()), int(idx.max())
            if lo == self._live_lo and hi - lo + 1 == idx.size:
                self._live_lo = hi + 1
            else:
                self._contig = False
        self.live_count -= int(idx.size)

    def _retire_rows(self, idx: np.ndarray) -> None:
        v = self._v[idx]
        self.vsum -= v.sum(axis=0)
        self.vsumsq -= (v * v).sum(axis=0)
        self.locality_sum -= float(self._locality[idx].sum())
        self._scatter(self._node_codes[idx], v, -1.0)
        self._tombstone(idx)
        self.retired_total += idx.size
        self._sketch_lag += idx.size
        self._q_cache = None
        # Compact when dead rows dominate (keeps live extraction O(2·live)).
        if self._n - self.live_count > max(self.live_count, self._INITIAL):
            self._compact(self._starts.shape[0])

    # -- quantiles ---------------------------------------------------------
    def quantiles(self, q: float | None = None, exact: bool = False) -> np.ndarray:
        """Per-column λq gate thresholds over the live window.

        Sketch estimate by default; exact ``np.quantile`` when ``exact``,
        when the live window is below :data:`MIN_SKETCH_SAMPLES` rows, or
        when ``q`` differs from the sketched quantile.  A sketch whose lag
        (rows added in bulk / retired since the last anchor) exceeds
        ``sketch_lag_frac × live`` is re-anchored exactly first.
        """
        q = self.quantile if q is None else float(q)
        if (
            exact
            or q != self.quantile
            or self.live_count < MIN_SKETCH_SAMPLES
        ):
            return exact_quantile(self.live_v(), q)
        self._maybe_anchor()
        if self._q_cache is None:
            self._q_cache = self._sketch.values()
        return self._q_cache

    def _anchor_sketch(self) -> None:
        self._sketch.reset_from(self.live_v())
        self._sketch_lag = 0
        self._q_cache = None

    def _maybe_anchor(self) -> None:
        """Re-anchor the sketch at ingest time once the lag budget is spent,
        or when bulk ingest outran an uninitialized sketch (maintenance
        belongs to the write path; reads stay O(1))."""
        if self.live_count < MIN_SKETCH_SAMPLES:
            return
        if (
            self._sketch_lag > self.sketch_lag_frac * self.live_count
            or self._sketch.n < MIN_SKETCH_SAMPLES
        ):
            self._anchor_sketch()

    # -- access ------------------------------------------------------------
    def live_slice(self) -> slice | None:
        """The live rows as a contiguous slice, or None if out-of-order
        retirement punched holes (restored at the next compaction).  Slice
        consumers read zero-copy views — the analyze-time fast path."""
        if self._contig:
            return slice(self._live_lo, self._n)
        return None

    def live_index(self) -> np.ndarray:
        if self._contig:
            return np.arange(self._live_lo, self._n, dtype=np.int64)
        return np.nonzero(self._live[: self._n])[0]

    def live_v(self) -> np.ndarray:
        if self._contig:
            return self._v[self._live_lo : self._n]
        return self._v[self.live_index()]

    def live_durations(self) -> np.ndarray:
        if self._contig:
            return self._durs[self._live_lo : self._n]
        return self._durs[self.live_index()]

    @property
    def starts(self) -> np.ndarray:
        return self._starts[: self._n]

    @property
    def ends(self) -> np.ndarray:
        return self._ends[: self._n]

    @property
    def durations(self) -> np.ndarray:
        return self._durs[: self._n]

    @property
    def locality(self) -> np.ndarray:
        return self._locality[: self._n]

    @property
    def v(self) -> np.ndarray:
        return self._v[: self._n]

    @property
    def node_codes(self) -> np.ndarray:
        return self._node_codes[: self._n]

    @property
    def node_counts(self) -> np.ndarray:
        return self._node_cnt

    @property
    def node_vsums(self) -> np.ndarray:
        return self._node_vsum

    def task_id(self, i: int) -> str:
        return self._task_ids[i]

    def task_ids_at(self, idx: np.ndarray) -> list[str]:
        return self._task_ids[idx].tolist()

    def node_name(self, code: int) -> str:
        return self._node_names[code]

    def __len__(self) -> int:
        return self.live_count

    def column_stats(self) -> tuple[np.ndarray, np.ndarray]:
        """(mean, variance) per gate-space column over the live window,
        straight from the running count/sum/sum-of-squares."""
        n = max(self.live_count, 1)
        mean = self.vsum / n
        var = np.maximum(self.vsumsq / n - mean * mean, 0.0)
        return mean, var

    # -- compatibility views -----------------------------------------------
    def seal(self) -> StageFrame:
        """Snapshot the live rows as an immutable StageFrame (copies)."""
        idx = self.live_index()
        nodes = [self._node_names[c] for c in self._node_codes[idx]]
        names, codes = (
            np.unique(nodes, return_inverse=True)
            if nodes else (np.empty(0, dtype=object), np.zeros(0, np.int64))
        )
        extras = {
            r: dict(self._extras[int(i)])
            for r, i in enumerate(idx) if int(i) in self._extras
        }
        return StageFrame(
            self.stage_id, self.schema,
            [self._task_ids[int(i)] for i in idx],
            codes.astype(np.int64, copy=False), names,
            self._starts[idx].copy(), self._ends[idx].copy(),
            self._locality[idx].copy(), self._raw[idx].copy(),
            self._present[idx].copy(), extras,
        )

    @property
    def tasks(self) -> list[TaskRecord]:
        """Live rows as TaskRecords (compatibility view; O(n) — not hot)."""
        return self.seal().tasks

    def export_live(self) -> dict:
        """Snapshot the live rows as plain columnar blocks (copies), shaped
        for re-ingest through ``add_rows``: the aggregator-HA journal path
        serializes these as a StageDelta so a restarted aggregator rebuilds
        the window exactly (schema columns with present masks, plus extras
        re-flattened to masked columns — re-ingest restores them as extras).
        The locality *field* travels in the ``locality`` array, never as a
        feature column (``add_rows`` re-derives that column from it)."""
        idx = self.live_index()
        columns: dict[str, np.ndarray] = {}
        present: dict[str, np.ndarray] = {}
        for name, j in self._col.items():
            if j == self._loc_j:
                continue
            columns[name] = self._raw[idx, j].copy()
            present[name] = self._present[idx, j].copy()
        extra_names = sorted(
            {nm for i in idx if int(i) in self._extras
             for nm in self._extras[int(i)]}
        )
        for nm in extra_names:
            vals = np.zeros(len(idx), dtype=np.float64)
            mask = np.zeros(len(idx), dtype=bool)
            for r, i in enumerate(idx):
                row = self._extras.get(int(i))
                if row is not None and nm in row:
                    vals[r] = row[nm]
                    mask[r] = True
            columns[nm] = vals
            present[nm] = mask
        return {
            "stage_id": self.stage_id,
            "task_ids": [self._task_ids[int(i)] for i in idx],
            "nodes": [self._node_names[c] for c in self._node_codes[idx]],
            "starts": self._starts[idx].copy(),
            "ends": self._ends[idx].copy(),
            "locality": self._locality[idx].copy(),
            "columns": columns,
            "present": present,
        }

    # -- internals ---------------------------------------------------------
    def _scatter(self, codes: np.ndarray, v: np.ndarray, sign: float) -> None:
        """Add/subtract per-node counts and column sums for a row batch
        (per-column ``bincount`` — far faster than ``np.ufunc.at``)."""
        cap = self._node_cnt.shape[0]
        self._node_cnt += sign * np.bincount(codes, minlength=cap)
        nv = self._node_vsum
        for col in range(v.shape[1]):
            nv[:, col] += sign * np.bincount(
                codes, weights=v[:, col], minlength=cap
            )

    def _encode_batch(self, nodes: Sequence[str]) -> np.ndarray:
        get = self._node_index.get
        codes = [get(nd) for nd in nodes]
        if None in codes:
            for i, c in enumerate(codes):
                if c is None:
                    codes[i] = self._node_code(nodes[i])
        return np.asarray(codes, dtype=np.int64)

    def _node_code(self, node: str) -> int:
        code = self._node_index.get(node)
        if code is None:
            code = self._node_index[node] = len(self._node_names)
            self._node_names.append(node)
            if code >= self._node_cnt.shape[0]:
                grow = max(2 * self._node_cnt.shape[0], 8)
                cnt = np.zeros(grow, dtype=np.float64)
                cnt[: self._node_cnt.shape[0]] = self._node_cnt
                self._node_cnt = cnt
                vs = np.zeros((grow, self._node_vsum.shape[1]), dtype=np.float64)
                vs[: self._node_vsum.shape[0]] = self._node_vsum
                self._node_vsum = vs
        return code

    def _append_slot(self) -> int:
        if self._n == self._starts.shape[0]:
            self._reserve(1)
        return self._n

    def _reserve(self, extra: int) -> None:
        cap = self._starts.shape[0]
        if self._n + extra <= cap:
            return
        # Full: compact (dropping tombstones), growing only if the live
        # rows themselves need the room.
        new_cap = cap
        while new_cap < 2 * (self.live_count + extra):
            new_cap *= 2
        self._compact(max(new_cap, self._INITIAL))

    def _compact(self, new_cap: int) -> None:
        """Epoch compaction: copy live rows to the front of (possibly
        bigger) buffers, recompute every aggregate exactly (cancels float
        drift from add/subtract cycles), re-anchor the sketch.  Node codes
        stay stable across compactions (the node table is append-only —
        hosts are a bounded fleet; dead nodes simply hold zero counts)."""
        idx = self.live_index()
        m = idx.size
        k = len(self.schema)
        new_cap = max(new_cap, self._INITIAL, m)

        def fresh(old, shape_tail=()):
            return np.zeros((new_cap,) + shape_tail, dtype=old.dtype)

        extras = self._extras
        if extras:
            keep = {int(i) for i in idx} & extras.keys()
            remap = {int(i): r for r, i in enumerate(idx)}
            self._extras = {remap[i]: extras[i] for i in keep}
        task_ids = np.empty(new_cap, dtype=object)
        task_ids[:m] = self._task_ids[idx]
        starts, ends = fresh(self._starts), fresh(self._ends)
        durs = fresh(self._durs)
        locality = fresh(self._locality)
        raw, present = fresh(self._raw, (k,)), fresh(self._present, (k,))
        v = fresh(self._v, (k,))
        node_codes = np.zeros(new_cap, dtype=np.int64)
        starts[:m] = self._starts[idx]
        ends[:m] = self._ends[idx]
        durs[:m] = self._durs[idx]
        locality[:m] = self._locality[idx]
        raw[:m] = self._raw[idx]
        present[:m] = self._present[idx]
        v[:m] = self._v[idx]
        node_codes[:m] = self._node_codes[idx]
        self._starts, self._ends, self._locality = starts, ends, locality
        self._durs = durs
        self._raw, self._present, self._v = raw, present, v
        self._task_ids = task_ids
        self._node_codes = node_codes
        self._live = np.zeros(new_cap, dtype=bool)
        self._live[:m] = True
        self._n = m
        self.live_count = m
        self._live_lo = 0
        self._contig = True

        live_v = v[:m]
        codes = node_codes[:m]
        self.vsum = live_v.sum(axis=0)
        self.vsumsq = (live_v * live_v).sum(axis=0)
        self.locality_sum = float(locality[:m].sum())
        self._node_cnt = np.zeros(self._node_cnt.shape[0], dtype=np.float64)
        self._node_vsum = np.zeros_like(self._node_vsum)
        self._scatter(codes, live_v, 1.0)
        self._anchor_sketch()
        self.compactions += 1


class StreamingTraceStore:
    """Multi-stage container of sliding windows — TraceStore's streaming
    sibling.

    Same ingest surface (``add_row``/``add_task``/``extend``) and access
    idiom, but ``stages()`` yields the :class:`SlidingStageWindow` objects
    themselves, so ``BigRootsAnalyzer.analyze(store)`` runs the incremental
    per-window path; ``frames()``/``dump_jsonl`` provide sealed snapshots
    for reports and persistence.
    """

    def __init__(
        self,
        schema: FeatureSchema,
        *,
        span: float | None = None,
        max_rows: int | None = None,
        quantile: float = 0.9,
    ) -> None:
        self.schema = schema
        self.span = span
        self.max_rows = max_rows
        self.quantile = quantile
        self._windows: dict[str, SlidingStageWindow] = {}

    def add_row(
        self,
        task_id: str,
        stage_id: str,
        node: str,
        start: float,
        end: float,
        locality: int = 0,
        features: Mapping[str, float] | None = None,
    ) -> bool:
        w = self.window_for(stage_id)
        ok = w.add_row(task_id, node, start, end, locality, features)
        if ok and self.span is not None:
            w.advance()
        return ok

    def add_rows(
        self,
        stage_id: str,
        task_ids: Sequence[str],
        nodes: Sequence[str],
        starts: np.ndarray,
        ends: np.ndarray,
        locality: np.ndarray | None = None,
        feature_columns: Mapping[str, np.ndarray] | None = None,
        present_columns: Mapping[str, np.ndarray] | None = None,
    ) -> int:
        """Columnar bulk ingest into one stage's window (see
        :meth:`SlidingStageWindow.add_rows`); creates the window on first
        sight and advances its watermark under a time ``span``."""
        w = self.window_for(stage_id)
        m = w.add_rows(task_ids, nodes, starts, ends, locality,
                       feature_columns, present_columns)
        if m and self.span is not None:
            w.advance()
        return m

    def add_task(self, task: TaskRecord) -> bool:
        return self.add_row(task.task_id, task.stage_id, task.node,
                            task.start, task.end, task.locality, task.features)

    def extend(self, tasks) -> None:
        for t in tasks:
            self.add_task(t)

    def window_for(self, stage_id: str) -> SlidingStageWindow:
        """The stage's live window, created on first sight with this
        store's span/max_rows/quantile configuration."""
        w = self._windows.get(stage_id)
        if w is None:
            w = self._windows[stage_id] = SlidingStageWindow(
                stage_id, self.schema, span=self.span,
                max_rows=self.max_rows, quantile=self.quantile,
            )
        return w

    def merge(self, *others: "StreamingTraceStore") -> int:
        """Union other streaming stores into this one, per stage, via
        :meth:`SlidingStageWindow.merge` (watermark reconciliation +
        exact aggregate/sketch re-anchor per window).  Windows are created
        for stages this store has not seen.  Returns total rows ingested;
        ``others`` are never mutated."""
        if len({id(o) for o in others}) != len(others):
            raise ValueError("the same store appears twice in a merge")
        ingested = 0
        for other in others:
            if other is self:
                raise ValueError("cannot merge a StreamingTraceStore into itself")
            for w in other.stages():
                ingested += self.window_for(w.stage_id).merge(w)
        return ingested

    def drop_stage(self, stage_id: str) -> bool:
        """Forget a stage's window entirely (fleet-aggregation retention:
        an always-on loop opens a new step-window stage every N steps and
        must shed exhausted ones to stay bounded)."""
        return self._windows.pop(stage_id, None) is not None

    def window(self, stage_id: str) -> SlidingStageWindow:
        return self._windows[stage_id]

    def stages(self) -> Iterator[SlidingStageWindow]:
        yield from self._windows.values()

    def stage(self, stage_id: str) -> SlidingStageWindow:
        return self._windows[stage_id]

    def frames(self) -> Iterator[StageFrame]:
        for w in self._windows.values():
            yield w.seal()

    def stage_ids(self) -> list[str]:
        return list(self._windows)

    @property
    def num_tasks(self) -> int:
        return sum(w.live_count for w in self._windows.values())

    def __len__(self) -> int:
        return len(self._windows)

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for frame in self.frames():
                for i in range(len(frame)):
                    f.write(frame.task(i).to_json() + "\n")


@dataclass
class CauseState:
    """Dedup/decay bookkeeping for one (task, feature) cause key."""

    first_step: int           # step of first confirmation
    last_confirmed: int       # step of the latest confirmation
    confirmations: int = 1    # total confirmations observed (all cycles)
    emits: int = 1            # times this key was emitted to the caller
    severity: int = 1         # escalation level: +1 per re-emergence after
    #                           decay, capped at RootCauseStream.MAX_SEVERITY
    recovered_s: float = 0.0  # what-if recovery accumulated across emissions

    def clean_windows(self, step: int) -> int:
        return step - self.last_confirmed


class RootCauseStream:
    """Emit-once live diagnosis with bounded out-of-window memory.

    Runs the incremental analyzer against a window (or every window of a
    :class:`StreamingTraceStore`) after each step and returns only the
    root causes not currently deduped.

    Dedup policy (the ROADMAP's out-of-window straggler memory): a key's
    repeat confirmations within ``decay_steps`` steps of the last one are
    suppressed (emit-once) but counted in its :class:`CauseState`.  Once a
    key stays *clean* (unconfirmed) for more than ``decay_steps`` steps it
    is dormant: the next confirmation **re-emits** it with ``severity``
    escalated by one — a cause that keeps coming back is a worse cause,
    not a duplicate.  Escalation is capped at :data:`MAX_SEVERITY`
    (override with ``max_severity=``): severity is an urgency *level*,
    not a counter, and an unbounded value would let one flapping cause
    outrank every rule threshold forever (``CauseState.confirmations``
    keeps the full count).  A key clean for more than ``forget_steps``
    steps (default ``8 × decay_steps``) is dropped entirely, which bounds
    ``seen`` by the distinct causes of the last ``forget_steps`` steps
    instead of the whole history of a long-running serve loop.
    ``decay_steps=None`` restores the legacy grow-forever/emit-once-ever
    behavior.

    What-if attribution: pass ``attributor=`` (a
    :class:`~repro_torch.core.whatif.WhatIfReplayer`) and every *emitted* cause
    carries an :class:`~repro_torch.core.analyzer.Attribution` priced against
    the current source windows.  The stream aggregates recovered time
    across the dedup lifecycle: each key's :class:`CauseState` accumulates
    ``recovered_s`` over its emissions, and a decay/re-emit carries the
    running total as ``cumulative_recovery_s`` (a cause that keeps coming
    back keeps costing), with the stream-wide sum in ``recovered_total``.
    With no attributor the emitted stream is byte-identical to an
    attribution-less build.

    >>> stream = RootCauseStream(analyzer, telem.live_window)
    >>> ... inside the train loop, once per step ...
    >>> for cause in stream.step():
    ...     log.warning("straggler %s: %s (sev %d)", cause.task_id,
    ...                 cause.feature, cause.severity)
    """

    #: Documented ceiling for severity escalation on decay/re-emit.
    MAX_SEVERITY = 8

    def __init__(
        self,
        analyzer,
        source,
        *,
        decay_steps: int | None = 256,
        forget_steps: int | None = None,
        attributor=None,
        max_severity: int | None = None,
    ) -> None:
        if decay_steps is not None and decay_steps < 1:
            raise ValueError("decay_steps must be >= 1 (or None to disable)")
        self.analyzer = analyzer
        self.source = source
        self.decay_steps = decay_steps
        if forget_steps is None and decay_steps is not None:
            forget_steps = 8 * decay_steps
        if forget_steps is not None and decay_steps is not None:
            forget_steps = max(forget_steps, decay_steps)
        self.forget_steps = forget_steps
        self.attributor = attributor
        self.max_severity = (
            self.MAX_SEVERITY if max_severity is None else int(max_severity)
        )
        if self.max_severity < 1:
            raise ValueError("max_severity must be >= 1")
        self.seen: dict[tuple[str, str], CauseState] = {}
        self.last_analysis = None
        self.steps = 0
        self.emitted = 0
        self.reemitted = 0
        self.forgotten = 0
        self.recovered_total = 0.0
        # Per-stage content stamps for StreamingTraceStore sources: a
        # window whose (uid, total_added, retired_total) is unchanged since
        # the last step is skipped — its rows, and therefore its analysis,
        # are identical, so re-running it would only burn the sweep budget
        # and keep re-confirming stale causes forever (blocking
        # decay/forget).  The uid guards against a stage dropped and
        # recreated between steps aliasing the old stamp.
        self._window_stamps: dict[str, tuple[int, int, int]] = {}

    def state(self, key: tuple[str, str]) -> CauseState | None:
        return self.seen.get(key)

    def step(self) -> list:
        if isinstance(self.source, StreamingTraceStore):
            # Multi-window source: one batched fleet sweep per step when
            # the analyzer offers it (byte-identical to the per-window
            # loop, one gate launch instead of W — see analyze_fleet),
            # over the *changed* windows only: an always-on loop retains
            # exhausted stage windows, and re-analyzing frozen rows every
            # step both multiplies sweep cost by the retention cap and
            # re-confirms stale causes forever (defeating decay/forget).
            all_windows = list(self.source.stages())
            stamps = {
                w.stage_id: (w.uid, w.total_added, w.retired_total)
                for w in all_windows
            }
            # Row-stamp purity has one exception: Eq. 6 edge detection
            # reads the live ResourceTimeline, whose samples covering a
            # task's tail window ([end, end+edge_width]) arrive *after*
            # the row does.  Until the fleet clock (max t_max) passes a
            # window's last end + edge_width, its resource verdicts can
            # still change, so it stays in the sweep even when unchanged.
            settle = 0.0
            if getattr(self.analyzer, "timelines", None) is not None:
                th = getattr(self.analyzer, "thresholds", None)
                settle = float(getattr(th, "edge_width", 0.0) or 0.0)
            now = max((w.t_max for w in all_windows), default=-np.inf)
            windows = [
                w for w in all_windows
                if self._window_stamps.get(w.stage_id) != stamps[w.stage_id]
                or (settle > 0.0 and w.t_max + settle > now)
            ]
            fleet = getattr(self.analyzer, "analyze_fleet", None)
            if fleet is not None:
                analyses = fleet(windows)
            else:
                analyses = [self.analyzer.analyze_stage(w) for w in windows]
            # Mark windows seen only after their analysis ran: a raise
            # above leaves them pending, so a caller that survives a
            # transient analyzer failure retries them next tick instead of
            # skipping their causes forever.  (Dropped stages fall out.)
            self._window_stamps = stamps
        else:
            analyses = [self.analyzer.analyze_stage(self.source)]
        # Keep the previous analysis through idle ticks (all windows
        # unchanged → nothing re-analyzed).
        if analyses:
            self.last_analysis = analyses[-1]
        self.steps += 1
        step = self.steps
        decay = self.decay_steps
        fresh = []
        for sa in analyses:
            for cause in sa.root_causes:
                st = self.seen.get(cause.key)
                if st is None:
                    self.seen[cause.key] = CauseState(
                        first_step=step, last_confirmed=step
                    )
                    fresh.append(cause)
                    continue
                dormant = decay is not None and st.clean_windows(step) > decay
                st.confirmations += 1
                st.last_confirmed = step
                if dormant:
                    # Re-emergence after a clean spell: escalate (capped)
                    # and re-emit.
                    st.severity = min(st.severity + 1, self.max_severity)
                    st.emits += 1
                    self.reemitted += 1
                    fresh.append(replace(cause, severity=st.severity))
        if self.attributor is not None and fresh:
            fresh = self._attribute(fresh)
        self.emitted += len(fresh)
        if self.forget_steps is not None:
            horizon = self.forget_steps
            expired = [k for k, st in self.seen.items()
                       if st.clean_windows(step) > horizon]
            for k in expired:
                del self.seen[k]
            self.forgotten += len(expired)
        return fresh

    def _attribute(self, fresh: list) -> list:
        """Price this tick's emissions via the attributor and fold each
        estimate into its key's lifetime ``recovered_s`` — a re-emitted
        cause carries the total recovered time it has cost across
        decay/re-emit cycles, not just this sighting's estimate."""
        attributed = self.attributor.attribute(self.source, fresh)
        out = []
        for cause in attributed:
            a = cause.attribution
            if a is None:
                out.append(cause)
                continue
            self.recovered_total += a.estimated_recovery_s
            cum = a.estimated_recovery_s
            st = self.seen.get(cause.key)
            if st is not None:
                st.recovered_s += a.estimated_recovery_s
                cum = st.recovered_s
            out.append(replace(
                cause, attribution=replace(a, cumulative_recovery_s=cum),
            ))
        return out
