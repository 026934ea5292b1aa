"""Forecaster training: ``repro_torch.core.forecast.train_forecaster``
against JAX's gradient of the reference loss.

The reference trains with ``jax.grad`` of ``repro.core.forecast._bce_loss``
in 64-bit mode and a numpy Adam loop.  Its ``train_forecaster`` cannot run
on every jax build (it imports ``jax.experimental.enable_x64``), so these
tests take JAX's gradient of the reference loss themselves, under
``jax.enable_x64(True)``, and hold the port to it:

- the port's autograd gradient equals JAX's to ``1e-12`` relative to the
  largest component of each parameter, also where the hard sigmoid sits
  exactly on a kink and where the logits pass softplus's threshold;
- 20 steps of the port's trainer equal 20 steps of the reference's Adam
  lines fed JAX's gradient, to ``1e-9``;
- port-trained parameters pass the reference's value gate
  (``tests/test_forecast.py::TestForecastValue``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.forecast as ref_forecast
from repro.models import forecast_ssd as ref_ssd
from repro_torch.anomaly import export_episodes
from repro_torch.core import JAX_FEATURES
from repro_torch.core import forecast as port_forecast
from repro_torch.models.forecast_ssd import PARAM_NAMES, ForecastCell

F = len(JAX_FEATURES)
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def episodes():
    return export_episodes("hot_host_cpu", **CPU)


def weighted(y):
    y = np.asarray(y, dtype=np.float64)
    pos = float(y.sum())
    return y, np.where(y > 0, (len(y) - pos) / pos if pos else 1.0, 1.0)


def jax_grad(params, x, y, w) -> dict:
    """JAX's gradient of the reference loss, float64."""
    with jax.enable_x64(True):
        xj, yj, wj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)
        g = jax.jit(jax.grad(lambda p: ref_forecast._bce_loss(
            p, xj, yj, wj, jnp)))(params)
        return {k: np.asarray(v) for k, v in g.items()}


def torch_grad(params, x, y, w) -> dict:
    cell = ForecastCell(params, "cpu", requires_grad=True)
    leaves = [getattr(cell, k) for k in PARAM_NAMES]
    loss = port_forecast._bce_loss(
        cell, *(torch.from_numpy(np.asarray(a)) for a in (x, y, w)))
    return {k: g.numpy() for k, g in
            zip(PARAM_NAMES, torch.autograd.grad(loss, leaves))}


def point(seed, episodes):
    """Seeded (params, x, y, w): the exported episodes, or telemetry rows
    spanning utilisation fractions to byte counters."""
    cfg = ref_ssd.ForecastConfig(features=F)
    params = ref_ssd.forecast_init(cfg, seed=seed)
    if seed == 0:
        x, y = episodes.x, episodes.y
    else:
        rng = np.random.default_rng(seed)
        x = rng.normal(0, 1, (300, 8, F)) * rng.choice([1.0, 1e3, 1e7],
                                                      (300, 8, F))
        y = rng.random(300) < 0.1
    if seed == 2:
        # logits past softplus's threshold of 20, in both signs
        params["wo"] = params["wo"] * 200.0
        params["bo"] = np.asarray(25.0)
    return (params, x, *weighted(y))


def assert_close(got: dict, want: dict, rtol: float) -> None:
    for k in PARAM_NAMES:
        scale = float(np.max(np.abs(want[k])))
        assert np.asarray(got[k]).shape == np.asarray(want[k]).shape, k
        assert np.max(np.abs(got[k] - want[k])) <= rtol * scale, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gradient_equals_jax_grad_of_the_reference_loss(seed, episodes):
    params, x, y, w = point(seed, episodes)
    want = jax_grad(params, x, y, w)
    assert all(np.max(np.abs(v)) > 0 for v in want.values())
    assert_close(torch_grad(params, x, y, w), want, 1e-12)


def test_large_logits_reach_past_the_softplus_threshold(episodes):
    params, x, y, w = point(2, episodes)
    z = ref_ssd.forecast_logits(params, x, xp=np)
    assert np.max(z) > 20.0 and np.min(z) < -20.0


def test_kink_gradient_follows_jax():
    """Rows of zeros put the hard sigmoid of head 0 exactly on its upper
    kink and of head 1 on its lower one: JAX splits the gradient of
    min/max there, and so does the port (``torch.clamp`` would not)."""
    cfg = ref_ssd.ForecastConfig(features=F)
    params = ref_ssd.forecast_init(cfg, seed=5)
    params["bin"] = np.array([2.0, -2.0, 0.3, -0.7, 1.1, 0.0])
    rng = np.random.default_rng(5)
    x = np.zeros((40, 8, F))
    x[20:] = rng.normal(0, 1, (20, 8, F))
    y, w = weighted(rng.random(40) < 0.3)
    pre = params["bin"][:2]
    assert list(0.25 * pre + 0.5) == [1.0, 0.0]
    want = jax_grad(params, x, y, w)
    assert_close(torch_grad(params, x, y, w), want, 1e-12)


def reference_training(episodes, seed, steps, lr):
    """The reference's ``train_forecaster`` loop, its gradient taken by
    ``jax.grad`` under ``jax.enable_x64(True)``."""
    x, y = episodes.x, np.asarray(episodes.y, dtype=np.float64)
    _, w = weighted(y)
    cfg = ref_ssd.ForecastConfig(features=x.shape[2], length=x.shape[1],
                                 horizon=episodes.horizon)
    params = ref_ssd.forecast_init(cfg, seed=seed)
    with jax.enable_x64(True):
        xj, yj, wj = jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)
        grad = jax.jit(jax.grad(
            lambda p: ref_forecast._bce_loss(p, xj, yj, wj, jnp)))
        m = {k: np.zeros_like(v) for k, v in params.items()}
        v2 = {k: np.zeros_like(v) for k, v in params.items()}
        b1, b2, eps = 0.9, 0.999, 1e-8
        for t in range(1, steps + 1):
            g = {k: np.asarray(gv) for k, gv in grad(params).items()}
            for k in params:
                m[k] = b1 * m[k] + (1 - b1) * g[k]
                v2[k] = b2 * v2[k] + (1 - b2) * g[k] ** 2
                mh = m[k] / (1 - b1**t)
                vh = v2[k] / (1 - b2**t)
                params[k] = params[k] - lr * mh / (np.sqrt(vh) + eps)
    return params


def test_twenty_steps_equal_the_reference_loop(episodes):
    got = port_forecast.train_forecaster(episodes, seed=3, steps=20, lr=0.05,
                                         **CPU)
    want = reference_training(episodes, seed=3, steps=20, lr=0.05)
    assert list(got) == list(want)
    for k in PARAM_NAMES:
        assert np.shape(got[k]) == np.shape(want[k]), k
        assert np.max(np.abs(got[k] - want[k])) <= 1e-9, k
    init = ref_ssd.forecast_init(ref_ssd.ForecastConfig(features=F), seed=3)
    assert all(np.max(np.abs(got[k] - init[k])) > 1e-3 for k in PARAM_NAMES)


def test_forecaster_train_wraps_the_trainer(episodes):
    fc = port_forecast.Forecaster.train(episodes, JAX_FEATURES, seed=1,
                                        steps=3, risk_threshold=0.5, **CPU)
    want = port_forecast.train_forecaster(episodes, seed=1, steps=3, **CPU)
    for k in PARAM_NAMES:
        assert np.asarray(fc.params[k]).tobytes() == \
            np.asarray(want[k]).tobytes(), k
    assert fc.min_history == episodes.length
    assert fc.device == torch.device("cpu")


def test_empty_episodes_raise(episodes):
    empty = type(episodes)(**{**episodes.__dict__, "x": episodes.x[:0],
                              "y": episodes.y[:0]})
    with pytest.raises(ValueError):
        port_forecast.train_forecaster(empty, steps=1, **CPU)


def test_beats_threshold_baseline_with_lead_time():
    """The reference's value gate with port-trained parameters: the same
    exports, seeds, steps and rate."""
    train = [export_episodes("hot_host_cpu", seed=11, **CPU),
             export_episodes("hot_host_cpu", seed=211, **CPU),
             export_episodes("clock_skew", seed=53, **CPU),
             export_episodes("clock_skew", seed=253, **CPU)]
    held = [export_episodes("hot_host_cpu", seed=411, **CPU),
            export_episodes("clock_skew", seed=453, **CPU)]
    params = port_forecast.train_forecaster(train, seed=0, steps=400,
                                            lr=0.05, **CPU)
    rep = port_forecast.evaluate_forecaster(params, held)
    assert rep["positives"] > 0
    assert rep["baseline_auc"] >= 0.5
    assert rep["auc"] > rep["baseline_auc"]
    lead = port_forecast.lead_time_curve(params, held, thresholds=(0.5,))[0]
    assert lead["median_lead_steps"] > 0.0
    assert lead["precision"] >= 0.5
    assert lead["recall"] > 0.0


@pytest.mark.parametrize("seed", [0, 7])
def test_evaluation_matches_the_reference(seed, episodes):
    """``baseline_auc``, ``evaluate_forecaster`` and ``lead_time_curve`` are
    numpy on both sides: equal, not close."""
    params = ref_ssd.forecast_init(ref_ssd.ForecastConfig(features=F),
                                   seed=seed)
    assert port_forecast.baseline_auc(episodes) == \
        ref_forecast.baseline_auc(episodes)
    assert port_forecast.evaluate_forecaster(params, episodes) == \
        ref_forecast.evaluate_forecaster(params, episodes)
    assert port_forecast.lead_time_curve(params, [episodes]) == \
        ref_forecast.lead_time_curve(params, [episodes])
