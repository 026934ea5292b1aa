"""Right-sized SSD cell for straggle-risk forecasting (repro_torch.core.forecast).

This is the Mamba2 SSD recurrence — selective
``h ← h·decay(dt) + dt·x·B``, readout ``y = C·h`` (specialized to
``G=1, P=1``) — cut down to telemetry scale: a ~14-feature input row per
step, a handful of hidden heads, a 4-wide state.  At that size the
chunked dual form buys nothing, so the cell is optimized for a different
axis entirely: **determinism and launch cost**.

Every operation is an exact-rounding IEEE-754 primitive — add, multiply,
divide, sqrt, abs, min/max — with the usual transcendentals swapped for
rational/piecewise surrogates of the same shape:

- input compression ``v/(1+|v|)`` instead of ``log1p`` (byte counters
  and utilization fractions land on one scale),
- a hard sigmoid ``clip(0.25z+0.5, 0, 1)`` gating the silu,
- ``0.5(z+sqrt(z²+ε))`` instead of softplus for the positive step size,
- rational decay ``1/(1+dt·A²)`` instead of ``exp(-dt·exp(A_log))``
  (same (0,1] forgetting curve, selectivity preserved),
- rational sigmoid ``0.5(z/(1+|z|)+1)`` for the final risk score.

Every value is pure elementwise math in a written, fixed op order (the
projections are explicitly unrolled multiply-add chains — neither numpy
nor eager PyTorch reassociates a written chain, and in eager PyTorch
every op is its own kernel, so no multiply-add is contracted into an
FMA), which buys three exact contracts:

1. batched inference over a padded ``[S, L, F]`` pack is byte-identical
   to scoring each sequence alone (padding is *left*-sided and
   ``where``-masked, so carried state bits never move);
2. :func:`forecast_step` — the serve-side O(1) recurrence — replayed
   over a window's rows from zero state lands on **byte-identical**
   scores to the one-shot :func:`forecast_score` of that window (same
   formulas, same order; only the iteration structure differs);
3. runs are reproducible bit-for-bit across processes and batch sizes.

Two implementations of the same formulas live here: the torch functions
(:func:`forecast_logits`, :func:`forecast_score`, :func:`forecast_step`)
over a :class:`ForecastCell`, which run on whatever device the cell's
tensors are on, and their numpy twins (``*_np``) over the parameter
dict of :func:`forecast_init` — the host oracle.  The promise between
the two is ``allclose`` at ``atol = rtol = 1e-12``, not bytes: op order
and rounding are the same everywhere except ``sqrt``, where PyTorch's
vectorised CPU kernel is one ulp off the correctly rounded value on a
small fraction of inputs (``tests/test_torch_forecast.py`` pins that
down).

The per-tick fleet launch is the *recurrent* form (one
:func:`forecast_step` over ``[S, F]``, not an ``[S, L, F]`` re-score).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

#: Smoothing of the soft-relu step size: dt = 0.5(z + sqrt(z² + EPS)),
#: so dt(0) = 0.5·sqrt(EPS) = 0.01 — the floor of the init's dt range.
_DT_EPS = 4e-4


@dataclass(frozen=True)
class ForecastConfig:
    """Shape of the forecast cell (defaults are the right-sized ones the
    ROADMAP asked for: small enough that one 16k-host batched launch
    stays inside the per-step diagnosis budget)."""

    features: int          # input feature columns (len(schema))
    hidden: int = 6        # SSD heads H
    state: int = 4         # state width N per head
    length: int = 8        # telemetry steps per scored sequence
    horizon: int = 3       # label lookahead: straggle within `horizon` steps


def forecast_init(cfg: ForecastConfig, seed: int = 0) -> dict:
    """Seeded float64 parameters (numpy — canonical storage form).

    Init follows the Mamba2 SSM conventions: decay
    rates spread over ``1..H`` (``A`` stores the sqrt; the cell squares
    it) and ``dt`` biased so the soft-relu lands in ``[1e-2, 0.5]`` — a
    spread of forgetting timescales over the sequence."""
    rng = np.random.default_rng(seed)
    F, H, N = cfg.features, cfg.hidden, cfg.state
    s = 1.0 / np.sqrt(F)
    dt = np.exp(rng.uniform(np.log(1e-2), np.log(0.5), H))
    return {
        "win": rng.normal(0.0, s, (F, H)),
        "bin": np.zeros(H),
        "wdt": rng.normal(0.0, s, (F, H)),
        "bdt": dt - (_DT_EPS / 4.0) / dt,       # inverse soft-relu
        "wb": rng.normal(0.0, s, (F, N)),
        "bb": np.full(N, 0.5),
        "wc": rng.normal(0.0, s, (F, N)),
        "bc": np.full(N, 0.5),
        "A": np.sqrt(np.arange(1, H + 1, dtype=np.float64)),
        "D": np.ones(H),
        "wo": rng.normal(0.0, 1.0 / np.sqrt(H), (H,)),
        "bo": np.zeros(()),
    }


# -- the cell: parameters on a device -----------------------------------------

#: Parameter names of the cell, in :func:`forecast_init` order.
PARAM_NAMES = ("win", "bin", "wdt", "bdt", "wb", "bb", "wc", "bc", "A", "D",
               "wo", "bo")


class ForecastCell(nn.Module):
    """The twelve float64 parameter tensors of the cell on one device.

    Built from the numpy dict of :func:`forecast_init` (or a trained one
    of the same layout).  The parameters require gradients only when
    built with ``requires_grad=True``, as the trainer
    (:func:`repro_torch.core.forecast.train_forecaster`) builds them.
    ``forward`` is :func:`forecast_score`."""

    def __init__(self, params, device, *, requires_grad: bool = False) -> None:
        super().__init__()
        missing = [k for k in PARAM_NAMES if k not in params]
        if missing:
            raise KeyError(f"forecast parameters missing {missing}")
        device = torch.device(device)
        for name in PARAM_NAMES:
            value = params[name]
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(
                    np.array(value, dtype=np.float64, copy=True)
                )
            self.register_parameter(name, nn.Parameter(
                value.detach().to(device=device, dtype=torch.float64),
                requires_grad=requires_grad,
            ))

    @property
    def device(self) -> torch.device:
        return self.A.device

    def to_numpy(self) -> dict:
        """The parameters back in canonical numpy storage form."""
        return {k: getattr(self, k).detach().cpu().numpy()
                for k in PARAM_NAMES}

    def forward(self, x, mask=None):
        return forecast_score(self, x, mask=mask)


# -- fixed-order exact-rounding primitives (torch) ----------------------------

def _proj(u, W, b):
    """``u[..., F] @ W[F, D] + b[D]`` as F fixed-order multiply-adds."""
    out = b + u[..., 0:1] * W[0]
    for k in range(1, W.shape[0]):
        out = out + u[..., k : k + 1] * W[k]
    return out


def _compress(x):
    return x / (1.0 + torch.abs(x))


def _hard_sigmoid(z):
    # minimum/maximum, not clamp: the same values, and at the kinks
    # (0.25z + 0.5 exactly 0 or 1) the gradient is split in half as JAX's
    # min/max split it, where clamp passes all of it.
    return torch.minimum(torch.maximum(0.25 * z + 0.5, z.new_zeros(())),
                         z.new_ones(()))


def _rational_sigmoid(z):
    return 0.5 * (z / (1.0 + torch.abs(z)) + 1.0)


def _soft_relu(z):
    return 0.5 * (z + torch.sqrt(z * z + _DT_EPS))


def forecast_logits(cell: ForecastCell, x, mask=None):
    """Straggle-risk logits for telemetry sequences, on ``x``'s device.

    Same contract as :func:`forecast_logits_np`: ``x [..., L, F]`` float64
    gate-space rows, newest step last; ``mask [..., L]`` marks real steps
    (1.0) vs *left* padding (0.0).  Returns logits ``[...]``."""
    p = cell
    L = x.shape[-2]
    H = p.A.shape[0]
    N = p.wb.shape[1]
    u = _compress(x)                                   # [..., L, F]
    pre = _proj(u, p.win, p.bin)                       # [..., L, H]
    xt = pre * _hard_sigmoid(pre)                      # hard silu
    dt = _soft_relu(_proj(u, p.wdt, p.bdt))            # [..., L, H]
    B = _proj(u, p.wb, p.bb)                           # [..., L, N]
    decay = 1.0 / (1.0 + dt * (p.A * p.A))             # (0, 1]
    dx = dt * xt
    h = torch.zeros(x.shape[:-2] + (H, N), dtype=torch.float64,
                    device=x.device)
    for t in range(L):
        h_new = (h * decay[..., t, :, None]
                 + dx[..., t, :, None] * B[..., t, None, :])
        if mask is not None:
            keep = (mask[..., t] > 0.0)[..., None, None]
            h_new = torch.where(keep, h_new, h)
        h = h_new
    Ct = _proj(u[..., L - 1, :], p.wc, p.bc)           # [..., N]
    y = Ct[..., 0:1] * h[..., :, 0]
    for k in range(1, N):
        y = y + Ct[..., k : k + 1] * h[..., :, k]
    out = y + p.D * xt[..., L - 1, :]
    logit = p.bo + out[..., 0] * p.wo[0]
    for j in range(1, H):
        logit = logit + out[..., j] * p.wo[j]
    return logit


def forecast_score(cell: ForecastCell, x, mask=None):
    """Per-sequence straggle risk in (0, 1) — the rational sigmoid of
    the logits (monotone, so thresholding is order-identical)."""
    return _rational_sigmoid(forecast_logits(cell, x, mask=mask))


def forecast_step(cell: ForecastCell, x, h, update=None):
    """One recurrence step on ``x``'s device — see
    :func:`forecast_step_np` for the contract.  ``x [..., F]``,
    ``h [..., H, N]``, ``update [...]`` (1.0 = advance), all float64;
    returns ``(h_new, score)``."""
    p = cell
    H = p.A.shape[0]
    N = p.wb.shape[1]
    u = _compress(x)                                   # [..., F]
    pre = _proj(u, p.win, p.bin)                       # [..., H]
    xt = pre * _hard_sigmoid(pre)                      # hard silu
    dt = _soft_relu(_proj(u, p.wdt, p.bdt))            # [..., H]
    B = _proj(u, p.wb, p.bb)                           # [..., N]
    decay = 1.0 / (1.0 + dt * (p.A * p.A))             # (0, 1]
    dx = dt * xt
    h_new = h * decay[..., :, None] + dx[..., :, None] * B[..., None, :]
    if update is not None:
        h_new = torch.where((update > 0.0)[..., None, None], h_new, h)
    Ct = _proj(u, p.wc, p.bc)                          # [..., N]
    y = Ct[..., 0:1] * h_new[..., :, 0]
    for k in range(1, N):
        y = y + Ct[..., k : k + 1] * h_new[..., :, k]
    out = y + p.D * xt
    logit = p.bo + out[..., 0] * p.wo[0]
    for j in range(1, H):
        logit = logit + out[..., j] * p.wo[j]
    return h_new, _rational_sigmoid(logit)


# -- the numpy twins (host oracle) --------------------------------------------

def _proj_np(u, W, b):
    """``u[..., F] @ W[F, D] + b[D]`` as F fixed-order multiply-adds."""
    out = b + u[..., 0:1] * W[0]
    for k in range(1, W.shape[0]):
        out = out + u[..., k : k + 1] * W[k]
    return out


def _compress_np(x):
    """Sign-preserving range compression ``v/(1+|v|)`` → (−1, 1)."""
    return x / (1.0 + np.abs(x))


def _hard_sigmoid_np(z):
    """Piecewise-linear sigmoid surrogate ``clip(0.25z+0.5, 0, 1)``."""
    return np.minimum(np.maximum(0.25 * z + 0.5, 0.0), 1.0)


def _rational_sigmoid_np(z):
    """Smooth strictly-monotone squash onto (0, 1) — the risk score."""
    return 0.5 * (z / (1.0 + np.abs(z)) + 1.0)


def _soft_relu_np(z):
    """Smooth positive step size ``0.5(z+sqrt(z²+ε))`` (softplus shape,
    sqrt instead of log/exp; minimum value 0.5·sqrt(ε) = 0.01)."""
    return 0.5 * (z + np.sqrt(z * z + _DT_EPS))


def forecast_logits_np(params: dict, x, mask=None):
    """Straggle-risk logits for telemetry sequences (numpy oracle).

    ``x [..., L, F]`` — gate-space rows (the window's ``v`` space),
    newest step last.  ``mask [..., L]`` marks real steps (1.0) vs
    *left* padding (0.0): masked steps leave the carried state
    bit-identical (``where``), so a short history scores exactly like
    its unpadded self.  Returns logits ``[...]`` read out at the final
    (always-real) step.

    Input-dependent quantities (projections, gates, step sizes, decays)
    are computed for all ``L`` steps in one vectorized block — only the
    state update itself is sequential.
    """
    p = params
    L = x.shape[-2]
    H = p["A"].shape[0]
    N = p["wb"].shape[1]
    u = _compress_np(x)                                   # [..., L, F]
    pre = _proj_np(u, p["win"], p["bin"])                 # [..., L, H]
    xt = pre * _hard_sigmoid_np(pre)                      # hard silu
    dt = _soft_relu_np(_proj_np(u, p["wdt"], p["bdt"]))   # [..., L, H]
    B = _proj_np(u, p["wb"], p["bb"])                     # [..., L, N]
    decay = 1.0 / (1.0 + dt * (p["A"] * p["A"]))           # (0, 1]
    dx = dt * xt
    h = np.zeros(x.shape[:-2] + (H, N), dtype=x.dtype)
    for t in range(L):
        h_new = (h * decay[..., t, :, None]
                 + dx[..., t, :, None] * B[..., t, None, :])
        if mask is not None:
            keep = (mask[..., t] > 0.0)[..., None, None]
            h_new = np.where(keep, h_new, h)
        h = h_new
    Ct = _proj_np(u[..., L - 1, :], p["wc"], p["bc"])     # [..., N]
    y = Ct[..., 0:1] * h[..., :, 0]
    for k in range(1, N):
        y = y + Ct[..., k : k + 1] * h[..., :, k]
    out = y + p["D"] * xt[..., L - 1, :]
    logit = p["bo"] + out[..., 0] * p["wo"][0]
    for j in range(1, H):
        logit = logit + out[..., j] * p["wo"][j]
    return logit


def forecast_score_np(params: dict, x, mask=None):
    """Per-sequence straggle risk in (0, 1) — the rational sigmoid of
    the logits (monotone, so thresholding is order-identical)."""
    return _rational_sigmoid_np(forecast_logits_np(params, x, mask=mask))


def forecast_step_np(params: dict, x, h, update=None):
    """One recurrence step — the serve-side O(1) form of the cell.

    ``x [..., F]`` is the newest gate-space telemetry row per sequence,
    ``h [..., H, N]`` the carried state (zeros at node birth).  Returns
    ``(h_new, score)``: the advanced state and the straggle risk read
    out *at this step*.  ``update [...]`` (1.0 = advance) freezes both
    the state and, because the readout depends only on ``(u, h)``, the
    score of held rows — a node whose telemetry did not move between
    diagnosis ticks re-emits its previous score bit-for-bit.

    Exactness contract: in the numpy path, replaying a window's rows
    through this function from ``h = 0`` yields byte-identical scores
    to the one-shot :func:`forecast_score_np` of the packed window (same
    formulas in the same written order — only the loop structure
    differs).  The per-tick fleet launch uses this form: ``[S, F]`` work
    instead of ``[S, L, F]``.
    """
    p = params
    H = p["A"].shape[0]
    N = p["wb"].shape[1]
    u = _compress_np(x)                                   # [..., F]
    pre = _proj_np(u, p["win"], p["bin"])                 # [..., H]
    xt = pre * _hard_sigmoid_np(pre)                      # hard silu
    dt = _soft_relu_np(_proj_np(u, p["wdt"], p["bdt"]))   # [..., H]
    B = _proj_np(u, p["wb"], p["bb"])                     # [..., N]
    decay = 1.0 / (1.0 + dt * (p["A"] * p["A"]))           # (0, 1]
    dx = dt * xt
    h_new = h * decay[..., :, None] + dx[..., :, None] * B[..., None, :]
    if update is not None:
        h_new = np.where((update > 0.0)[..., None, None], h_new, h)
    Ct = _proj_np(u, p["wc"], p["bc"])                    # [..., N]
    y = Ct[..., 0:1] * h_new[..., :, 0]
    for k in range(1, N):
        y = y + Ct[..., k : k + 1] * h_new[..., :, k]
    out = y + p["D"] * xt
    logit = p["bo"] + out[..., 0] * p["wo"][0]
    for j in range(1, H):
        logit = logit + out[..., j] * p["wo"][j]
    return h_new, _rational_sigmoid_np(logit)
