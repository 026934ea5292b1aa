"""Predictive straggler forecasting inside the per-step diagnosis tick.

BigRoots (Eq. 5–7) confirms a straggler only after its duration is
already long — time the mitigation loop has lost.  The detection
literature (START's encoder-LSTM, arXiv 2111.10241; the NN MapReduce
detector, arXiv 2004.05868) shows straggle risk is *predictable* from
the same telemetry a few steps early.  This module is the inference
side of that hop:

- **Model**: :mod:`repro_torch.models.forecast_ssd` — the ssd/mamba
  recurrence right-sized to per-node telemetry sequences, in a written,
  fixed op order (torch functions over a ``ForecastCell``; numpy twins
  as the host oracle).
- **Inference**: one extra batched launch per diagnosis tick over the
  gate sweep's own windows (:func:`repro_torch.core.fleet.pack_sequences`
  mirrors ``pack_windows``), emitting ``predicted_straggler`` candidate
  causes via :func:`~repro_torch.core.analyzer.synthesize_cause`.  The
  tick launch runs the cell in its *recurrent* form — per-(stage, node)
  state carried **on the device** across ticks, one
  :func:`forecast_step` over ``[S, F]`` — so the cost per tick is
  ``O(nodes)`` instead of ``O(nodes × length)``.

Training and the ROC/lead-time evaluation of the forecaster are not part
of this package yet; parameters come from ``forecast_init`` or from a
forecaster trained elsewhere, through
:func:`repro_torch.convert.forecast_params_from_numpy`.

Contract: forecast causes are *candidates*, tagged with feature
``predicted_straggler`` and peer group ``("forecast",)``, appended after
the confirmed stream — they never enter :class:`RootCauseStream` dedup
state, so a forecast-off run's confirmed-cause bytes are untouched.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.forecast_ssd import (
    ForecastCell,
    ForecastConfig,
    forecast_score,
    forecast_score_np,
    forecast_step,
    forecast_step_np,
)
from .analyzer import RootCause, synthesize_cause
from .features import FeatureSchema
from .fleet import ForecastBatch, pack_sequences

__all__ = ["PREDICTED_STRAGGLER", "Forecaster"]

PREDICTED_STRAGGLER = "predicted_straggler"


# -- the per-tick hop ---------------------------------------------------------

class Forecaster:
    """Batched straggle-risk inference wired into the diagnosis tick.

    ``step(windows)`` packs every live window's newest per-node row
    (:func:`~repro_torch.core.fleet.pack_sequences` with ``length=1`` — same
    sweep geometry as the gate kernel's ``pack_windows``), advances a
    carried per-(stage, node) recurrence state through one
    :func:`~repro_torch.models.forecast_ssd.forecast_step` launch, and returns
    a ``predicted_straggler`` candidate cause per node whose risk clears
    ``risk_threshold``.  Rows whose newest task anchor did not move
    since the last tick are *frozen* — their state and score bits are
    re-emitted unchanged.  A per-node hold-down (``hold_steps`` ticks)
    keeps a persistently risky node from paging every tick, and
    ``min_history`` suppresses alarms until a sequence has advanced
    enough real steps to mean anything.

    ``scores(batch)`` is the parallel *windowed* form of the same cell —
    the training/evaluation view, used by the equivalence tests; the
    tick path never pays its ``O(S·L·F)`` cost.

    ``backend="torch"`` (default) keeps the parameters and the carried
    state ``[S, H, N]`` on ``device`` (``None`` = the GPU; raises when
    there is none): each tick the newest rows and the update mask go up,
    the state is gathered with ``index_select``, advanced, scattered back
    with ``index_copy_``, and the risks come back.  ``backend="numpy"``
    is the host oracle: same formulas on numpy arrays, no GPU needed
    (``device`` is ignored).  ``params`` is the
    numpy dict of ``forecast_init`` (or a :class:`ForecastCell`).
    """

    def __init__(
        self,
        params: dict,
        config: ForecastConfig,
        schema: FeatureSchema,
        *,
        risk_threshold: float = 0.7,
        backend: str = "torch",
        hold_steps: int = 8,
        min_history: int = 2,
        seq_bucket: int = 256,
        device=None,
    ) -> None:
        if backend not in ("torch", "numpy"):
            raise ValueError(f"unknown forecast backend {backend!r}")
        # The numpy oracle is host only and needs no GPU.
        self.device = (resolve_device(device) if backend == "torch"
                       else torch.device("cpu"))
        if isinstance(params, ForecastCell):
            self.cell = params.to(self.device)
        else:
            self.cell = ForecastCell(params, self.device)
        self.params = self.cell.to_numpy()
        self.config = config
        self.schema = schema
        self.risk_threshold = float(risk_threshold)
        self.backend = backend
        self.hold_steps = int(hold_steps)
        self.min_history = int(min_history)
        self.seq_bucket = int(seq_bucket)
        self._tick = 0
        self._held: dict[str, int] = {}   # node -> tick the hold expires
        # Carried recurrence state, keyed by (stage_id, node); ``_h`` lives
        # on the device (a numpy array on the numpy backend), the
        # bookkeeping beside it on the host.
        self._index: dict[tuple[str, str], int] = {}
        self._h = self._zeros_state(0)
        self._seen = np.zeros(0, dtype=np.int64)      # real steps advanced
        self._last_tick = np.zeros(0, dtype=np.int64)
        self._anchors: list[str] = []                 # newest task id fed

    def _zeros_state(self, rows: int):
        H, N = self.config.hidden, self.config.state
        if self.backend == "numpy":
            return np.zeros((rows, H, N), dtype=np.float64)
        return torch.zeros((rows, H, N), dtype=torch.float64,
                           device=self.device)

    def load_state(self, state: dict) -> None:
        """Install carried recurrence state (the dict of
        :func:`repro_torch.convert.forecaster_state_from_numpy`): a
        forecaster resumed from another process's state scores the next
        tick exactly as that process would have."""
        h = state["h"]
        if self.backend == "numpy":
            self._h = h.cpu().numpy().copy()
        else:
            self._h = h.to(self.device).clone()
        self._index = dict(state["index"])
        self._seen = state["seen"].copy()
        self._last_tick = state["last_tick"].copy()
        self._anchors = list(state["anchors"])

    def _up(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- scoring -----------------------------------------------------------
    def scores(self, batch: ForecastBatch) -> np.ndarray:
        """Risk scores for a packed batch (real sequences only)."""
        n = batch.count
        if n == 0:
            return np.zeros(0, dtype=np.float64)
        if self.backend == "numpy":
            out = forecast_score_np(self.params, batch.x[:n],
                                    mask=batch.mask[:n])
            return np.asarray(out, dtype=np.float64)
        with torch.no_grad():
            out = forecast_score(self.cell, self._up(batch.x[:n]),
                                 mask=self._up(batch.mask[:n]))
        return out.cpu().numpy()

    def step_scores(
        self, rows: np.ndarray, h: np.ndarray, update: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """One recurrence step over newest rows, host arrays in and out:
        ``(h_new, risks)``."""
        if self.backend == "numpy":
            h_new, sc = forecast_step_np(self.params, rows, h, update=update)
            return np.asarray(h_new), np.asarray(sc, dtype=np.float64)
        with torch.no_grad():
            h_new, sc = forecast_step(self.cell, self._up(rows), self._up(h),
                                      update=self._up(update))
        return h_new.cpu().numpy(), sc.cpu().numpy()

    # -- the tick hop ------------------------------------------------------
    def _align_state(self, batch: ForecastBatch):
        """Map packed rows onto carried state; allocate rows for new
        (stage, node) keys.  Returns ``(slots, update)`` where
        ``slots[i]`` is the state row of packed row ``i`` and
        ``update[i]`` is 1.0 iff the row's newest task anchor moved."""
        n = batch.count
        slots = np.empty(n, dtype=np.int64)
        update = np.zeros(n, dtype=np.float64)
        fresh: list[tuple[str, str]] = []
        for i in range(n):
            key = (batch.stage_ids[i], batch.nodes[i])
            idx = self._index.get(key, -1)
            if idx < 0:
                idx = len(self._index)
                self._index[key] = idx
                fresh.append(key)
            slots[i] = idx
        if fresh:
            grow = len(self._index) - self._h.shape[0]
            cat = np.concatenate if self.backend == "numpy" else torch.cat
            self._h = cat([self._h, self._zeros_state(grow)])
            self._seen = np.concatenate(
                [self._seen, np.zeros(grow, dtype=np.int64)])
            self._last_tick = np.concatenate(
                [self._last_tick, np.zeros(grow, dtype=np.int64)])
            self._anchors.extend("" for _ in range(grow))
        for i in range(n):
            if self._anchors[slots[i]] != batch.task_ids[i]:
                update[i] = 1.0
                self._anchors[slots[i]] = batch.task_ids[i]
        self._last_tick[slots] = self._tick
        return slots, update

    def _evict_stale(self, live: int) -> None:
        """Drop state for (stage, node) keys gone for 64+ ticks once the
        table is well past the live set — bounds memory under stage
        churn without ever evicting an active sequence."""
        if len(self._index) <= 2 * live + 1024:
            return
        keep = [
            (key, idx) for key, idx in self._index.items()
            if self._last_tick[idx] > self._tick - 64
        ]
        old = np.array([idx for _, idx in keep], dtype=np.int64)
        self._index = {key: i for i, (key, _) in enumerate(keep)}
        if self.backend == "numpy":
            self._h = self._h[old].copy()
        else:
            self._h = self._h.index_select(0, self._up(old))
        self._seen = self._seen[old].copy()
        self._last_tick = self._last_tick[old].copy()
        self._anchors = [self._anchors[i] for i in old]

    def step(self, windows) -> list[RootCause]:
        """Advance per-node risk state one tick; emit candidate causes."""
        self._tick += 1
        windows = [w for w in windows if w is not None]
        if not windows:
            return []
        batch = pack_sequences(windows, self.schema, 1,
                               seq_bucket=self.seq_bucket)
        n = batch.count
        if n == 0:
            return []
        slots, update = self._align_state(batch)
        rows = batch.x[:n, 0, :]
        if self.backend == "numpy":
            h_new, risks = forecast_step_np(self.params, rows,
                                            self._h[slots], update=update)
            self._h[slots] = h_new
            risks = np.asarray(risks, dtype=np.float64)
        else:
            slots_t = self._up(slots)
            with torch.no_grad():
                h_new, risks_t = forecast_step(
                    self.cell, self._up(rows),
                    self._h.index_select(0, slots_t),
                    update=self._up(update),
                )
                self._h.index_copy_(0, slots_t, h_new)
            risks = risks_t.cpu().numpy()
        self._seen[slots] += update.astype(np.int64)
        seen = self._seen[slots]
        out: list[RootCause] = []
        for i in np.nonzero(risks >= self.risk_threshold)[0]:
            if seen[i] < self.min_history:
                continue
            node = batch.nodes[i]
            if self._held.get(node, 0) > self._tick:
                continue
            self._held[node] = self._tick + self.hold_steps
            out.append(synthesize_cause(
                task_id=batch.task_ids[i],
                stage_id=batch.stage_ids[i],
                node=node,
                feature=PREDICTED_STRAGGLER,
                value=float(risks[i]),
                guidance=(
                    f"forecast: straggle risk {float(risks[i]):.2f} within "
                    f"{self.config.horizon} steps — pre-emptive mitigation "
                    "window is open (speculate/rebalance before Eq. 5 "
                    "confirms)"
                ),
                peer_groups=("forecast",),
            ))
        if len(self._held) > 4096:
            self._held = {n2: t for n2, t in self._held.items()
                          if t > self._tick}
        self._evict_stale(n)
        return out
