"""Resource timelines: per-(node, metric) time series with window queries.

The store behind Eq. 1-3 (window-averaged utilization) and Eq. 6 (edge
detection needs the mean utilization just before a task starts and just after
it ends).  Series are numpy-backed with prefix sums over capacity-doubled
buffers: appends are amortized O(1), the prefix sum extends incrementally for
in-order samples (one stable argsort only when out-of-order merges actually
happened), window means are two ``searchsorted`` calls plus a prefix-sum
difference, and the batched :meth:`window_means` resolves all edge queries of
a whole stage in one call — a multi-hour trace with thousands of nodes stays
fast.  A single lock makes interleaved writer/reader threads safe (the live
loops sample from a background ``SystemSampler`` thread while the step loop
queries).
"""
from __future__ import annotations

import json
import threading
from typing import Iterable, Sequence

import numpy as np


class _Series:
    """One (node, metric) series in growable buffers + incremental prefix sum.

    ``_ts/_vals`` hold ``n`` valid samples; ``_csum[:n+1]`` is the prefix sum
    of ``_vals`` valid up to ``_csum_n`` samples.  Callers must hold the
    owning timeline's lock for every method and for reads of the views.
    """

    __slots__ = ("_ts", "_vals", "_csum", "n", "_csum_n", "_sorted",
                 "sort_gen")

    _INITIAL = 64

    def __init__(self) -> None:
        cap = self._INITIAL
        self._ts = np.empty(cap, dtype=np.float64)
        self._vals = np.empty(cap, dtype=np.float64)
        self._csum = np.zeros(cap + 1, dtype=np.float64)
        self.n = 0
        self._csum_n = 0
        self._sorted = True
        # Bumped whenever seal() re-sorts: cursors key their position hints
        # on it (a re-sort invalidates any remembered index).
        self.sort_gen = 0

    def _reserve(self, extra: int) -> None:
        need = self.n + extra
        cap = self._ts.shape[0]
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        for name in ("_ts", "_vals"):
            old = getattr(self, name)
            new = np.empty(cap, dtype=np.float64)
            new[: self.n] = old[: self.n]
            setattr(self, name, new)
        csum = np.zeros(cap + 1, dtype=np.float64)
        csum[: self._csum_n + 1] = self._csum[: self._csum_n + 1]
        self._csum = csum

    def append(self, t: float, v: float) -> None:
        self._reserve(1)
        if self._sorted and self.n and t < self._ts[self.n - 1]:
            self._sorted = False
        self._ts[self.n] = t
        self._vals[self.n] = v
        self.n += 1

    def extend(self, ts: np.ndarray, vals: np.ndarray) -> None:
        m = ts.shape[0]
        if m == 0:
            return
        self._reserve(m)
        if self._sorted and (
            (self.n and ts[0] < self._ts[self.n - 1])
            or (m > 1 and np.any(np.diff(ts) < 0))
        ):
            self._sorted = False
        self._ts[self.n : self.n + m] = ts
        self._vals[self.n : self.n + m] = vals
        self.n += m

    def seal(self) -> "_Series":
        """Make ``ts``/``csum`` views consistent: sort if out-of-order merges
        happened (rare), then extend the prefix sum over new samples only."""
        n = self.n
        if not self._sorted:
            order = np.argsort(self._ts[:n], kind="stable")
            self._ts[:n] = self._ts[:n][order]
            self._vals[:n] = self._vals[:n][order]
            self._sorted = True
            self._csum_n = 0
            self.sort_gen += 1
        if self._csum_n < n:
            m = self._csum_n
            self._csum[m + 1 : n + 1] = self._csum[m] + np.cumsum(
                self._vals[m:n]
            )
            self._csum_n = n
        return self

    @property
    def ts(self) -> np.ndarray:
        return self._ts[: self.n]

    @property
    def vals(self) -> np.ndarray:
        return self._vals[: self.n]

    @property
    def csum(self) -> np.ndarray:
        return self._csum[: self.n + 1]


class ResourceTimeline:
    """Append-mostly store of (t, value) samples keyed by (node, metric).

    Thread-safe: writers (e.g. the ``SystemSampler`` background thread) and
    readers (per-step ``window_mean`` in the telemetry loop) serialize on one
    internal lock.
    """

    def __init__(self) -> None:
        self._series: dict[tuple[str, str], _Series] = {}
        self._lock = threading.Lock()

    def _get(self, node: str, metric: str) -> _Series:
        key = (node, metric)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _Series()
        return s

    # -- writing ---------------------------------------------------------------
    def record(self, node: str, metric: str, t: float, value: float) -> None:
        with self._lock:
            self._get(node, metric).append(float(t), float(value))

    def record_many(self, node: str, metric: str,
                    samples: Iterable[tuple[float, float]]) -> None:
        pairs = list(samples)
        if not pairs:
            return
        arr = np.asarray(pairs, dtype=np.float64)
        with self._lock:
            self._get(node, metric).extend(arr[:, 0], arr[:, 1])

    # -- queries ------------------------------------------------------------
    def window_mean(self, node: str, metric: str, t0: float, t1: float) -> float | None:
        """Mean of samples with t0 <= t <= t1; None if no samples in window."""
        with self._lock:
            s = self._series.get((node, metric))
            if s is None or s.n == 0:
                return None
            s.seal()
            lo = int(np.searchsorted(s.ts, t0, side="left"))
            hi = int(np.searchsorted(s.ts, t1, side="right"))
            if hi <= lo:
                return None
            return float((s.csum[hi] - s.csum[lo]) / (hi - lo))

    def window_means(
        self,
        nodes: Sequence[str],
        metrics: Sequence[str],
        t0s: np.ndarray,
        t1s: np.ndarray,
    ) -> np.ndarray:
        """Batched :meth:`window_mean`: element i is the mean of
        (nodes[i], metrics[i]) over [t0s[i], t1s[i]], NaN where no samples
        cover the window (or the series doesn't exist).

        Queries are grouped per series so each series is sealed once and all
        its windows resolve in two vectorized ``searchsorted`` calls — this
        is how all Eq. 6 edge queries of a stage collapse into one call.
        """
        t0s = np.asarray(t0s, dtype=np.float64)
        t1s = np.asarray(t1s, dtype=np.float64)
        out = np.full(len(nodes), np.nan, dtype=np.float64)
        groups: dict[tuple[str, str], list[int]] = {}
        for idx, key in enumerate(zip(nodes, metrics)):
            groups.setdefault(key, []).append(idx)
        with self._lock:
            for key, idx_list in groups.items():
                s = self._series.get(key)
                if s is None or s.n == 0:
                    continue
                s.seal()
                idx = np.asarray(idx_list, dtype=np.int64)
                lo = np.searchsorted(s.ts, t0s[idx], side="left")
                hi = np.searchsorted(s.ts, t1s[idx], side="right")
                ok = hi > lo
                if np.any(ok):
                    out[idx[ok]] = (
                        s.csum[hi[ok]] - s.csum[lo[ok]]
                    ) / (hi[ok] - lo[ok])
        return out

    def cursor(self) -> "TimelineCursor":
        """Incremental query cursor for monotonically advancing windows
        (the in-loop Eq. 6 edge queries of a streaming analyzer)."""
        return TimelineCursor(self)

    def series(self, node: str, metric: str) -> tuple[list[float], list[float]]:
        with self._lock:
            s = self._series.get((node, metric))
            if s is None:
                return [], []
            s.seal()
            return s.ts.tolist(), s.vals.tolist()

    def nodes(self) -> list[str]:
        with self._lock:
            return sorted({n for (n, _m) in self._series})

    def metrics(self, node: str) -> list[str]:
        with self._lock:
            return sorted({m for (n, m) in self._series if n == node})

    def __len__(self) -> int:
        with self._lock:
            return sum(s.n for s in self._series.values())

    # -- persistence -------------------------------------------------------
    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            with self._lock:
                rows = [
                    (node, metric, s.seal().ts.tolist(), s.vals.tolist())
                    for (node, metric), s in self._series.items()
                ]
            for node, metric, ts, vals in rows:
                f.write(json.dumps({"node": node, "metric": metric,
                                    "ts": ts, "vals": vals}) + "\n")

    @staticmethod
    def load_jsonl(path: str) -> "ResourceTimeline":
        tl = ResourceTimeline()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                tl.record_many(obj["node"], obj["metric"],
                               zip(obj["ts"], obj["vals"]))
        return tl


class TimelineCursor:
    """Incremental :meth:`ResourceTimeline.window_means` for in-loop use.

    A streaming analyzer issues edge-detection windows whose bounds advance
    monotonically with wall time (each step queries slightly later windows
    than the last).  The cursor remembers, per series, the smallest index
    the previous call resolved to and restricts the next ``searchsorted``
    to the suffix from there — the binary search runs over the recent tail
    instead of the whole multi-hour series.  Correctness guards:

    - the hint is only used when every queried ``t0`` lies strictly after
      the sample just before the hint (otherwise: full search — answers are
      *always* exact, the cursor is only a lower-bound accelerator);
    - a series re-sort (out-of-order bulk merge) bumps ``sort_gen``, which
      invalidates the hint;
    - the effective hint is the minimum over the *last two* calls: the
      analyzer alternates head windows (``start - edge_width``) and tail
      windows (``end``) per step, and the head of step k+1 starts before
      the tail of step k — a single-call hint would trip the exactness
      guard on every other call and degenerate to full searches.

    Same query contract as :meth:`ResourceTimeline.window_means` /
    :meth:`ResourceTimeline.window_mean`, so it satisfies the analyzer's
    ``TimelineStore`` protocol and slots in transparently.
    """

    def __init__(self, timeline: ResourceTimeline) -> None:
        self.timeline = timeline
        # key -> (sort_gen, prev-call min lo, last-call min lo)
        self._hints: dict[tuple[str, str], tuple[int, int, int]] = {}

    def window_means(
        self,
        nodes: Sequence[str],
        metrics: Sequence[str],
        t0s: np.ndarray,
        t1s: np.ndarray,
    ) -> np.ndarray:
        tl = self.timeline
        t0s = np.asarray(t0s, dtype=np.float64)
        t1s = np.asarray(t1s, dtype=np.float64)
        out = np.full(len(nodes), np.nan, dtype=np.float64)
        groups: dict[tuple[str, str], list[int]] = {}
        for i, key in enumerate(zip(nodes, metrics)):
            groups.setdefault(key, []).append(i)
        with tl._lock:
            for key, idx_list in groups.items():
                s = tl._series.get(key)
                if s is None or s.n == 0:
                    continue
                s.seal()
                idx = np.asarray(idx_list, dtype=np.int64)
                gen, prev_lo, last_lo = self._hints.get(key, (-1, 0, 0))
                base = min(prev_lo, last_lo) if gen == s.sort_gen else 0
                if base > s.n or (
                    base > 0 and s._ts[base - 1] >= float(t0s[idx].min())
                ):
                    base = 0
                tail = s.ts[base:]
                lo = base + np.searchsorted(tail, t0s[idx], side="left")
                hi = base + np.searchsorted(tail, t1s[idx], side="right")
                ok = hi > lo
                if np.any(ok):
                    out[idx[ok]] = (
                        s.csum[hi[ok]] - s.csum[lo[ok]]
                    ) / (hi[ok] - lo[ok])
                carry = last_lo if gen == s.sort_gen else 0
                self._hints[key] = (s.sort_gen, carry, int(lo.min()))
        return out

    def window_mean(self, node: str, metric: str, t0: float, t1: float) -> float | None:
        got = self.window_means([node], [metric], np.array([t0]), np.array([t1]))
        return None if np.isnan(got[0]) else float(got[0])
