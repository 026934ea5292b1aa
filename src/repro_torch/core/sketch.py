"""Streaming quantile sketches for the λq gate (Eq. 5).

``np.quantile`` over the full stage is the single most expensive piece of
``analyze_stage`` at fleet scale (~25% of analyze time at 16k hosts: the
exact partition is O(n) per feature column, re-paid on every query).  The
sliding-window substrate (:mod:`repro_torch.core.window`) replaces it with the
P² algorithm (Jain & Chlamtac, CACM 1985): five markers per tracked
quantile, updated in O(1) per observation, no sample retention.

Two classes:

- :class:`P2Quantile` — one quantile of one scalar stream.  The shape the
  per-step telemetry loop feeds (one task row per step).
- :class:`P2ColumnSketch` — the same five-marker state vectorized across
  all ``F`` schema columns at once, so a window ingesting a task row pays
  one batch of small numpy ops instead of ``F`` Python-level updates.

Exactness contract (the tiny-stage edge): with fewer than
:data:`MIN_SKETCH_SAMPLES` observations the sketch holds the raw samples
and ``value()`` returns the *exact* ``np.quantile`` (linear
interpolation) — a stage too small for the markers to initialize keeps
seed-identical λq gates.  From 5 samples up, the estimate is the classic
P² marker height, which converges to the true quantile for stationary
streams but is approximate ("sketch tolerance"); consumers that need
exactness (property tests, tiny stages) use
:meth:`P2ColumnSketch.reset_from` / exact fallbacks in the window.

P² supports neither deletion nor merging, so a sliding window re-anchors
its sketch from the live rows at epoch boundaries (retirement pressure /
compaction) via :meth:`P2ColumnSketch.reset_from`, which initializes the
markers at the exact quantiles of the current window — between epochs the
estimate covers live rows plus recently retired ones, and the drift is
bounded by the rebuild policy (see ``SlidingStageWindow``).  The same
mechanism makes multi-host merges exact: ``SlidingStageWindow.merge``
ends in a ``reset_from`` over the merged live rows, so a fresh merge
always answers the exact quantiles (``tests/test_merge.py`` pins this
bit-for-bit).
"""
from __future__ import annotations

import numpy as np

#: Below this many observations the sketch answers from the raw samples
#: (exact ``np.quantile``); the P² markers need 5 points to initialize.
MIN_SKETCH_SAMPLES = 5


def exact_quantiles(values: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """Exact per-column quantiles [len(qs), F] of ``values [n, F]`` with one
    ``np.partition`` pass over all bracketing order statistics (the cheap
    way to re-anchor all five P² markers at once).

    The interpolation replicates numpy's ``_lerp`` bit-for-bit (including
    its form switch at t >= 0.5) — that exactness is what keeps tiny-stage
    λq gates seed-identical to ``np.quantile``.
    """
    values = np.asarray(values, dtype=np.float64)
    n = values.shape[0]
    qs = np.asarray(qs, dtype=np.float64)
    if n == 0:
        return np.full((qs.size,) + values.shape[1:], np.nan)
    pos = qs * (n - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    frac = pos - lo
    kth = np.unique(np.concatenate([lo, hi]))
    part = np.partition(values, kth, axis=0)
    a, b = part[lo], part[hi]
    shape = (-1,) + (1,) * (values.ndim - 1)
    t = frac.reshape(shape)
    return np.where(t >= 0.5, b - (b - a) * (1.0 - t), a + (b - a) * t)


def exact_quantile(values: np.ndarray, q: float) -> np.ndarray:
    """Exact per-column q-quantile of ``values [n, F]`` via a 2-point
    ``np.partition`` — same 'linear' interpolation as ``np.quantile`` but
    ~3× cheaper (partitions at the two bracketing order statistics only).
    """
    values = np.asarray(values, dtype=np.float64)
    if values.ndim == 1:
        values = values[:, None]
    return exact_quantiles(values, np.array([q]))[0]


class P2ColumnSketch:
    """P² marker state for one target quantile, vectorized over ``width``
    independent columns (all columns share one observation count: every
    ingested row supplies a value for every column, mirroring the
    ``features.get(name, 0.0)`` semantics of the stage matrix)."""

    __slots__ = ("q", "width", "n", "_heights", "_pos", "_desired", "_dn",
                 "_buf")

    def __init__(self, q: float, width: int) -> None:
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = float(q)
        self.width = int(width)
        self._dn = np.array(
            [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0], dtype=np.float64
        )[:, None]
        self._reset_empty()

    def _reset_empty(self) -> None:
        self.n = 0
        self._buf: list[np.ndarray] = []
        self._heights = np.zeros((5, self.width), dtype=np.float64)
        self._pos = np.tile(
            np.arange(1.0, 6.0)[:, None], (1, self.width)
        )
        self._desired = 1.0 + 4.0 * self._dn

    def _init_from_buffer(self) -> None:
        self._heights = np.sort(np.stack(self._buf, axis=0), axis=0)
        self._buf = []

    def add(self, row: np.ndarray) -> None:
        """Ingest one observation per column (``row`` has shape [width])."""
        row = np.asarray(row, dtype=np.float64)
        if self.n < MIN_SKETCH_SAMPLES:
            self._buf.append(row.copy())
            self.n += 1
            if self.n == MIN_SKETCH_SAMPLES:
                self._init_from_buffer()
            return
        h, pos = self._heights, self._pos
        # Clamp the extreme markers, then locate each column's cell k∈0..3.
        np.minimum(h[0], row, out=h[0])
        np.maximum(h[4], row, out=h[4])
        k = (
            (row >= h[1]).astype(np.int64)
            + (row >= h[2])
            + (row >= h[3])
        )
        pos += np.arange(5)[:, None] > k[None, :]
        self._desired += self._dn
        # Adjust interior markers; invariant pos[i+1]-pos[i] >= 1 keeps all
        # denominators below >= 1.
        for i in (1, 2, 3):
            d = self._desired[i] - pos[i]
            move = ((d >= 1.0) & (pos[i + 1] - pos[i] > 1.0)) | (
                (d <= -1.0) & (pos[i - 1] - pos[i] < -1.0)
            )
            if not move.any():
                continue
            s = np.where(d >= 0.0, 1.0, -1.0)
            nm, nc, nn = pos[i - 1], pos[i], pos[i + 1]
            hm, hc, hn = h[i - 1], h[i], h[i + 1]
            with np.errstate(invalid="ignore", divide="ignore"):
                par = hc + (s / (nn - nm)) * (
                    (nc - nm + s) * (hn - hc) / (nn - nc)
                    + (nn - nc - s) * (hc - hm) / (nc - nm)
                )
                lin = hc + s * (
                    np.where(s > 0, hn, hm) - hc
                ) / (np.where(s > 0, nn, nm) - nc)
            new_h = np.where((hm < par) & (par < hn), par, lin)
            h[i] = np.where(move, new_h, hc)
            pos[i] = nc + np.where(move, s, 0.0)
        self.n += 1

    def values(self) -> np.ndarray:
        """Per-column quantile estimate [width].

        Exact (``np.quantile`` over the retained samples) below
        :data:`MIN_SKETCH_SAMPLES`; the P² middle-marker height after.
        """
        if self.n == 0:
            return np.full(self.width, np.nan)
        if self.n < MIN_SKETCH_SAMPLES:
            return exact_quantile(np.stack(self._buf, axis=0), self.q)
        return self._heights[2].copy()

    def reset_from(self, values: np.ndarray) -> None:
        """Re-anchor the markers exactly from ``values [n, width]`` (epoch
        compaction: cancels both retired-row influence and marker drift)."""
        values = np.asarray(values, dtype=np.float64)
        n = values.shape[0]
        if n < MIN_SKETCH_SAMPLES:
            self._reset_empty()
            for row in values:
                self.add(row)
            return
        self.n = n
        self._buf = []
        qs = np.array([0.0, self.q / 2.0, self.q, (1.0 + self.q) / 2.0, 1.0])
        self._heights = exact_quantiles(values, qs)
        # Theoretical marker positions, forced strictly increasing *within*
        # [1, n]: the extreme markers are pinned (rank 1 and rank n — a
        # position beyond n would claim order statistics that don't exist
        # and bias every subsequent estimate), interior markers are pushed
        # apart forward then pulled back below their right neighbor.
        pos = np.rint(1.0 + (n - 1) * qs).astype(np.float64)
        pos[0], pos[4] = 1.0, float(n)
        for i in range(1, 4):
            pos[i] = max(pos[i], pos[i - 1] + 1.0)
        for i in range(3, 0, -1):
            pos[i] = min(pos[i], pos[i + 1] - 1.0)
        self._pos = np.tile(pos[:, None], (1, self.width))
        self._desired = (1.0 + (n - 1) * self._dn).astype(np.float64)


class P2Quantile:
    """One quantile of one scalar stream, O(1) memory and update.

    The scalar face of :class:`P2ColumnSketch` (width 1): ``add`` a value
    per observation, read ``value()`` any time.  Exact below
    :data:`MIN_SKETCH_SAMPLES` samples, P² estimate after.

    >>> sk = P2Quantile(0.9)
    >>> for x in range(1000): sk.add(float(x))
    >>> abs(sk.value() - 899.1) < 20
    True
    """

    __slots__ = ("_sketch",)

    def __init__(self, q: float) -> None:
        self._sketch = P2ColumnSketch(q, 1)

    @property
    def q(self) -> float:
        return self._sketch.q

    @property
    def n(self) -> int:
        return self._sketch.n

    def add(self, x: float) -> None:
        self._sketch.add(np.array([x], dtype=np.float64))

    def value(self) -> float:
        return float(self._sketch.values()[0])

    def reset_from(self, values) -> None:
        arr = np.asarray(values, dtype=np.float64).reshape(-1, 1)
        self._sketch.reset_from(arr)
