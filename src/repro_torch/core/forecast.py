"""Predictive straggler forecasting inside the per-step diagnosis tick.

BigRoots (Eq. 5–7) confirms a straggler only after its duration is
already long — time the mitigation loop has lost.  The detection
literature (START's encoder-LSTM, arXiv 2111.10241; the NN MapReduce
detector, arXiv 2004.05868) shows straggle risk is *predictable* from
the same telemetry a few steps early.  This module holds that hop:

- **Model**: :mod:`repro_torch.models.forecast_ssd` — the ssd/mamba
  recurrence right-sized to per-node telemetry sequences, in a written,
  fixed op order (torch functions over a ``ForecastCell``; numpy twins
  as the host oracle).
- **Training data**: :func:`repro_torch.anomaly.scenario.export_episodes`
  — deterministic scenario runs labeled with the future Eq. 5 verdicts.
- **Training**: :func:`train_forecaster`, full-batch Adam on the
  windowed form of the cell; the gradient is ``torch.autograd`` on
  float64 leaves on ``device``, the Adam update numpy on the host.
- **Inference**: one extra batched launch per diagnosis tick over the
  gate sweep's own windows (:func:`repro_torch.core.fleet.pack_sequences`
  mirrors ``pack_windows``), emitting ``predicted_straggler`` candidate
  causes via :func:`~repro_torch.core.analyzer.synthesize_cause`.  The
  tick launch runs the cell in its *recurrent* form — per-(stage, node)
  state carried **on the device** across ticks, one
  :func:`forecast_step` over ``[S, F]`` — so the cost per tick is
  ``O(nodes)`` instead of ``O(nodes × length)``.

Contract: forecast causes are *candidates*, tagged with feature
``predicted_straggler`` and peer group ``("forecast",)``, appended after
the confirmed stream — they never enter :class:`RootCauseStream` dedup
state, so a forecast-off run's confirmed-cause bytes are untouched.
Value is gated honestly through :mod:`repro_torch.core.roc`:
:func:`evaluate_forecaster` reports model AUC against the best
per-feature threshold detector, and :func:`lead_time_curve` reports how
many steps of warning each alarm threshold buys at what precision.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.forecast_ssd import (
    PARAM_NAMES,
    ForecastCell,
    ForecastConfig,
    forecast_init,
    forecast_logits,
    forecast_score,
    forecast_score_np,
    forecast_step,
    forecast_step_np,
)
from .analyzer import RootCause, synthesize_cause
from .features import FeatureSchema
from .fleet import ForecastBatch, pack_sequences
from .roc import score_auc

__all__ = [
    "PREDICTED_STRAGGLER",
    "Forecaster",
    "baseline_auc",
    "evaluate_forecaster",
    "lead_time_curve",
    "train_forecaster",
]

PREDICTED_STRAGGLER = "predicted_straggler"


# -- training -----------------------------------------------------------------

def _bce_loss(cell: ForecastCell, x, y, w):
    z = forecast_logits(cell, x)
    # Stable weighted BCE on logits: softplus(z) - y*z, positives
    # up-weighted so ~1% incident rows aren't drowned by the fleet.
    # logaddexp(0, z), not F.softplus: its threshold switches to the
    # identity for large z.
    per = torch.logaddexp(torch.zeros_like(z), z) - y * z
    return (per * w).sum() / w.sum()


def train_forecaster(
    episodes,
    cfg: ForecastConfig | None = None,
    seed: int = 0,
    steps: int = 300,
    lr: float = 0.05,
    device=None,
) -> dict:
    """Fit the forecast cell on labeled episode sets (full-batch Adam).

    ``episodes`` is one :class:`~repro_torch.anomaly.scenario.EpisodeSet`
    or a sequence of them (concatenated).  Deterministic for fixed inputs
    and ``seed``.  Each step takes the loss's gradient with
    ``torch.autograd`` on float64 leaves on ``device`` (``None`` = the GPU,
    raising when there is none) and applies the Adam update to numpy
    copies of the parameters on the host.  Returns numpy parameters ready
    for :class:`Forecaster`.
    """
    device = resolve_device(device)
    sets = [episodes] if hasattr(episodes, "x") else list(episodes)
    x = np.concatenate([e.x for e in sets])
    y = np.concatenate([e.y for e in sets]).astype(np.float64)
    if x.shape[0] == 0:
        raise ValueError("no episodes to train on")
    if cfg is None:
        cfg = ForecastConfig(
            features=x.shape[2], length=x.shape[1],
            horizon=sets[0].horizon,
        )
    pos = float(y.sum())
    neg = float(len(y) - pos)
    pos_weight = (neg / pos) if pos else 1.0
    w = np.where(y > 0, pos_weight, 1.0)

    params = forecast_init(cfg, seed=seed)
    cell = ForecastCell(params, device, requires_grad=True)
    leaves = [getattr(cell, k) for k in PARAM_NAMES]
    xt, yt, wt = (torch.from_numpy(a).to(device) for a in (x, y, w))
    m = {k: np.zeros_like(v) for k, v in params.items()}
    v2 = {k: np.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    for t in range(1, steps + 1):
        grads = torch.autograd.grad(_bce_loss(cell, xt, yt, wt), leaves)
        g = {k: gv.cpu().numpy() for k, gv in zip(PARAM_NAMES, grads)}
        for k in params:
            m[k] = b1 * m[k] + (1 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1 - b2) * g[k] ** 2
            mh = m[k] / (1 - b1**t)
            vh = v2[k] / (1 - b2**t)
            params[k] = params[k] - lr * mh / (np.sqrt(vh) + eps)
        with torch.no_grad():
            for k, leaf in zip(PARAM_NAMES, leaves):
                leaf.copy_(torch.from_numpy(np.asarray(params[k])))
    return params


# -- honest evaluation --------------------------------------------------------

def baseline_auc(episodes) -> float:
    """The paper-style per-feature threshold detector's best AUC.

    For every feature column, score each sequence by its newest step's
    gate-space value and take the strongest column — the ceiling any
    single-feature threshold rule (the BigRoots detection idiom) can
    reach on these labels.  The forecaster must beat this to earn its
    launch in the tick.
    """
    sets = [episodes] if hasattr(episodes, "x") else list(episodes)
    x = np.concatenate([e.x for e in sets])
    y = np.concatenate([e.y for e in sets])
    labels = [int(v) for v in y]
    best = 0.5
    for f in range(x.shape[2]):
        best = max(best, score_auc([float(s) for s in x[:, -1, f]], labels))
    return best


def evaluate_forecaster(params: dict, episodes) -> dict:
    """Held-out value report: model AUC vs the per-feature baseline."""
    sets = [episodes] if hasattr(episodes, "x") else list(episodes)
    x = np.concatenate([e.x for e in sets])
    y = np.concatenate([e.y for e in sets])
    scores = forecast_score_np(params, x)
    model = score_auc([float(s) for s in scores], [int(v) for v in y])
    base = baseline_auc(sets)
    return {
        "auc": model,
        "baseline_auc": base,
        "auc_gain": model - base,
        "sequences": int(len(y)),
        "positives": int(np.asarray(y).sum()),
    }


def lead_time_curve(
    params: dict,
    episodes,
    thresholds: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
) -> list[dict]:
    """Lead-time-vs-precision per alarm threshold.

    For each gate-confirmed straggler ``(host, step_c)`` the lead time is
    ``step_c - a`` for the *earliest* alarming anchor ``a`` in its
    horizon window — the steps of warning the mitigation loop gains.
    Precision is over all alarms (an alarm on a sequence labeled 0 is a
    false page).  Confirmed stragglers with no alarm count as misses in
    ``recall``, not in the median.
    """
    sets = [episodes] if hasattr(episodes, "x") else list(episodes)
    out = []
    for thr in thresholds:
        leads: list[int] = []
        alarms = 0
        true_alarms = 0
        events = 0
        for e in sets:
            scores = forecast_score_np(params, e.x)
            fired = scores >= thr
            alarms += int(fired.sum())
            true_alarms += int((fired & (e.y > 0)).sum())
            by_host: dict[str, list[int]] = {}
            for i in range(len(e.y)):
                if fired[i]:
                    by_host.setdefault(e.hosts[i], []).append(e.anchors[i])
            for host, step_c in e.confirmed:
                events += 1
                hits = [
                    step_c - a for a in by_host.get(host, [])
                    if step_c - e.horizon <= a < step_c
                ]
                if hits:
                    leads.append(max(hits))
        out.append({
            "threshold": float(thr),
            "alarms": alarms,
            "precision": (true_alarms / alarms) if alarms else 0.0,
            "recall": (len(leads) / events) if events else 0.0,
            "median_lead_steps": float(np.median(leads)) if leads else 0.0,
        })
    return out


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

    @classmethod
    def train(
        cls,
        episodes,
        schema: FeatureSchema,
        *,
        seed: int = 0,
        steps: int = 300,
        lr: float = 0.05,
        **kwargs,
    ) -> "Forecaster":
        """Fit on episode sets and wrap the result (see
        :func:`train_forecaster`, which runs on the ``device`` given
        here, the forecaster's own).

        Unless overridden, ``min_history`` defaults to the training
        window length: the cell only ever saw full ``length``-step
        sequences, so scores from a colder state are extrapolation and
        should not page anyone."""
        sets = [episodes] if hasattr(episodes, "x") else list(episodes)
        cfg = ForecastConfig(
            features=sets[0].x.shape[2], length=sets[0].length,
            horizon=sets[0].horizon,
        )
        kwargs.setdefault("min_history", cfg.length)
        params = train_forecaster(sets, cfg=cfg, seed=seed, steps=steps,
                                  lr=lr, device=kwargs.get("device"))
        return cls(params, cfg, schema, **kwargs)

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
