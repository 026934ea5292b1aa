"""The forecast cell and the per-tick forecast hop: ``repro_torch`` against
``repro``.

Parameters come from the reference's ``forecast_init(cfg, seed)`` and are
carried with ``forecast_params_from_numpy``.  The promised tolerance is
the reference's own for different graphs of the same math
(``atol = rtol = 1e-12``).  Byte-equality with numpy does **not** hold on
a CPU: every op rounds once in both, but PyTorch's vectorised CPU
``sqrt`` (the soft-relu step size) is off by one ulp from the correctly
rounded ``np.sqrt`` on a fraction of a percent of inputs, which
``test_cpu_sqrt_is_the_only_source_of_byte_differences`` pins down.  What
is byte-exact is asserted as such: the port against itself (batched vs
per row, step replay vs windowed score, frozen rows) and the port's numpy
twins against the reference.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.models import forecast_ssd as ref_ssd
from repro_torch.convert import (
    forecast_params_from_numpy,
    forecaster_state_from_numpy,
)
from repro_torch.models import forecast_ssd as port_ssd

from _torch_port_util import wire

TOL = dict(atol=1e-12, rtol=1e-12)
F = len(ref_core.JAX_FEATURES)


def setup(seed=0, hidden=6, state=4):
    cfg = ref_ssd.ForecastConfig(features=F, hidden=hidden, state=state)
    params = ref_ssd.forecast_init(cfg, seed=seed)
    cell = forecast_params_from_numpy(params, device="cpu")
    return cfg, params, cell


def rows(rng, *shape):
    # gate-space rows span utilization fractions to byte counters
    return rng.normal(0.0, 1.0, shape) * rng.choice([1.0, 1e3, 1e7], shape)


def test_init_and_carry_are_the_same_arrays():
    cfg, params, cell = setup(3)
    port_params = port_ssd.forecast_init(
        port_ssd.ForecastConfig(features=F), seed=3)
    assert list(params) == list(port_ssd.PARAM_NAMES) == list(port_params)
    back = cell.to_numpy()
    for k in params:
        assert params[k].tobytes() == port_params[k].tobytes(), k
        assert back[k].dtype == np.float64 and back[k].shape == params[k].shape
        assert back[k].tobytes() == np.asarray(params[k]).tobytes(), k
    assert cell.bo.dim() == 0
    assert not any(p.requires_grad for p in cell.parameters())
    assert len(list(cell.parameters())) == 12


@pytest.mark.parametrize("seed", range(5))
def test_forecast_step_against_numpy_reference(seed):
    rng = np.random.default_rng(seed)
    cfg, params, cell = setup(seed)
    S = int(rng.integers(1, 300))
    x = rows(rng, S, F)
    h = rng.normal(0.0, 0.5, (S, cfg.hidden, cfg.state))
    update = (rng.random(S) < 0.7).astype(np.float64)
    want_h, want_s = ref_ssd.forecast_step(params, x, h, update=update, xp=np)
    got_h, got_s = port_ssd.forecast_step(
        cell, torch.from_numpy(x), torch.from_numpy(h),
        update=torch.from_numpy(update))
    assert got_h.dtype == torch.float64 and got_s.dtype == torch.float64
    np.testing.assert_allclose(got_h.numpy(), want_h, **TOL)
    np.testing.assert_allclose(got_s.numpy(), want_s, **TOL)
    # the port's own numpy twin is the same oracle
    twin_h, twin_s = port_ssd.forecast_step_np(params, x, h, update=update)
    assert twin_h.tobytes() == want_h.tobytes()
    assert twin_s.tobytes() == want_s.tobytes()


@pytest.mark.parametrize("seed", range(5))
def test_forecast_score_against_numpy_reference(seed):
    rng = np.random.default_rng(10 + seed)
    cfg, params, cell = setup(seed)
    S, L = int(rng.integers(1, 40)), int(rng.integers(1, 9))
    x = rows(rng, S, L, F)
    mask = np.ones((S, L))
    for i in range(S):                      # left padding
        mask[i, : int(rng.integers(0, L))] = 0.0
    want = ref_ssd.forecast_score(params, x, mask=mask, xp=np)
    got = port_ssd.forecast_score(cell, torch.from_numpy(x),
                                  mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert cell(torch.from_numpy(x), torch.from_numpy(mask)).numpy().tobytes() \
        == got.tobytes()
    assert port_ssd.forecast_score_np(params, x, mask=mask).tobytes() \
        == want.tobytes()
    want_l = ref_ssd.forecast_logits(params, x, xp=np)
    got_l = port_ssd.forecast_logits(cell, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_l, want_l, **TOL)


def test_cpu_sqrt_is_the_only_source_of_byte_differences(monkeypatch):
    """With the step size's ``sqrt`` taken by numpy, the torch functions
    give the reference's bytes: op order and every other rounding agree."""
    monkeypatch.setattr(
        port_ssd, "_soft_relu",
        lambda z: 0.5 * (z + torch.from_numpy(
            np.sqrt((z * z + port_ssd._DT_EPS).numpy()))),
    )
    rng = np.random.default_rng(77)
    cfg, params, cell = setup(8)
    x = rows(rng, 200, F)
    h = rng.normal(0.0, 0.5, (200, cfg.hidden, cfg.state))
    up = (rng.random(200) < 0.7).astype(np.float64)
    want_h, want_s = ref_ssd.forecast_step(params, x, h, update=up, xp=np)
    got_h, got_s = port_ssd.forecast_step(
        cell, torch.from_numpy(x), torch.from_numpy(h),
        update=torch.from_numpy(up))
    assert got_h.numpy().tobytes() == want_h.tobytes()
    assert got_s.numpy().tobytes() == want_s.tobytes()
    xs = rows(rng, 30, 6, F)
    assert port_ssd.forecast_score(cell, torch.from_numpy(xs)).numpy() \
        .tobytes() == ref_ssd.forecast_score(params, xs, xp=np).tobytes()


def test_batched_equals_per_row_bytes():
    rng = np.random.default_rng(21)
    cfg, params, cell = setup(1)
    S = 37
    x = torch.from_numpy(rows(rng, S, F))
    h = torch.from_numpy(rng.normal(0.0, 0.5, (S, cfg.hidden, cfg.state)))
    up = torch.ones(S, dtype=torch.float64)
    bh, bs = port_ssd.forecast_step(cell, x, h, update=up)
    for i in range(S):
        ih, isc = port_ssd.forecast_step(cell, x[i:i + 1], h[i:i + 1],
                                         update=up[i:i + 1])
        assert ih.numpy().tobytes() == bh[i:i + 1].numpy().tobytes()
        assert isc.numpy().tobytes() == bs[i:i + 1].numpy().tobytes()


def test_step_replay_equals_windowed_score_bytes():
    rng = np.random.default_rng(22)
    cfg, params, cell = setup(2)
    S, L = 9, 8
    x = torch.from_numpy(rows(rng, S, L, F))
    h = torch.zeros((S, cfg.hidden, cfg.state), dtype=torch.float64)
    for t in range(L):
        h, score = port_ssd.forecast_step(cell, x[:, t], h)
    want = port_ssd.forecast_score(cell, x)
    assert score.numpy().tobytes() == want.numpy().tobytes()


def test_frozen_rows_reemit_their_bits():
    rng = np.random.default_rng(23)
    cfg, params, cell = setup(4)
    S = 16
    x = torch.from_numpy(rows(rng, S, F))
    h0 = torch.from_numpy(rng.normal(0.0, 0.5, (S, cfg.hidden, cfg.state)))
    h1, s1 = port_ssd.forecast_step(cell, x, h0,
                                    update=torch.ones(S, dtype=torch.float64))
    frozen = torch.zeros(S, dtype=torch.float64)
    h2, s2 = port_ssd.forecast_step(cell, x, h1, update=frozen)
    assert h2.numpy().tobytes() == h1.numpy().tobytes()
    assert s2.numpy().tobytes() == s1.numpy().tobytes()


def feed(store, tick, rng_seed, hot):
    """One tick of rows (4 stages x 12 nodes) into a streaming store."""
    rng = np.random.default_rng(rng_seed)
    for s in range(4):
        for n in range(12):
            if (s + n + tick) % 5 == 0 and tick > 1:
                continue                     # some nodes stay silent: frozen
            dur = float(rng.uniform(0.9, 1.1)) * (4.0 if n == hot else 1.0)
            feats = {
                "cpu": float(rng.uniform(0.1, 0.3)) + (0.6 if n == hot else 0),
                "disk": float(rng.uniform(0.1, 0.2)),
                "network": float(rng.uniform(5e5, 6e5)),
                "read_bytes": float(rng.uniform(0.9, 1.1) * 64e6),
                "gc_time": float(rng.uniform(0, 0.05)),
                "data_load_time": float(rng.uniform(0, 0.4) * dur),
                "h2d_time": float(rng.uniform(0, 0.1)),
            }
            store.add_row(f"n{n}/t{tick}", f"stage{s}", f"n{n}",
                          10.0 * tick, 10.0 * tick + dur, 0, feats)


@pytest.mark.parametrize("port_backend", ["torch", "numpy"])
def test_forecaster_step_equal_candidates_over_ticks(port_backend):
    cfg, params, _ = setup(5)
    kw = dict(risk_threshold=0.45, hold_steps=2, min_history=2, seq_bucket=16)
    ref_fc = ref_core.Forecaster(params, cfg, ref_core.JAX_FEATURES,
                                 backend="numpy", **kw)
    port_fc = port_core.Forecaster(
        params, port_ssd.ForecastConfig(features=F), port_core.JAX_FEATURES,
        backend=port_backend, device="cpu", **kw)
    ref_store = ref_core.StreamingTraceStore(ref_core.JAX_FEATURES)
    port_store = port_core.StreamingTraceStore(port_core.JAX_FEATURES)
    emitted = 0
    for tick in range(1, 9):
        feed(ref_store, tick, 1000 + tick, hot=3)
        feed(port_store, tick, 1000 + tick, hot=3)
        want = wire(ref_fc.step(list(ref_store.stages())), ref_core)
        got = wire(port_fc.step(list(port_store.stages())), port_core)
        assert [{k: v for k, v in d.items() if k not in ("value", "guidance")}
                for d in got] == \
               [{k: v for k, v in d.items() if k not in ("value", "guidance")}
                for d in want]
        for g, w in zip(got, want):
            assert g["feature"] == "predicted_straggler"
            np.testing.assert_allclose(g["value"], w["value"], **TOL)
            assert g["guidance"] == w["guidance"]
            if port_backend == "numpy":
                assert g["value"] == w["value"]
        emitted += len(got)
    assert emitted > 0
    # the carried state itself: device tensor in the port, same values
    h = port_fc._h if port_backend == "numpy" else port_fc._h.numpy()
    assert port_fc._index == ref_fc._index
    np.testing.assert_allclose(h, ref_fc._h, **TOL)
    if port_backend == "numpy":
        assert h.tobytes() == ref_fc._h.tobytes()
    np.testing.assert_array_equal(port_fc._seen, ref_fc._seen)


def test_state_carried_from_the_reference_resumes_identically():
    cfg, params, _ = setup(6)
    kw = dict(risk_threshold=0.45, hold_steps=1, min_history=1, seq_bucket=16)
    ref_fc = ref_core.Forecaster(params, cfg, ref_core.JAX_FEATURES,
                                 backend="numpy", **kw)
    ref_store = ref_core.StreamingTraceStore(ref_core.JAX_FEATURES)
    port_store = port_core.StreamingTraceStore(port_core.JAX_FEATURES)
    for tick in range(1, 4):
        feed(ref_store, tick, 2000 + tick, hot=5)
        feed(port_store, tick, 2000 + tick, hot=5)
        ref_fc.step(list(ref_store.stages()))
    port_fc = port_core.Forecaster(
        params, port_ssd.ForecastConfig(features=F), port_core.JAX_FEATURES,
        device="cpu", **kw)
    port_fc.load_state(forecaster_state_from_numpy(
        ref_fc._index, ref_fc._h, ref_fc._seen, ref_fc._last_tick,
        ref_fc._anchors, device="cpu"))
    port_fc._tick = ref_fc._tick
    port_fc._held = dict(ref_fc._held)
    feed(ref_store, 4, 2004, hot=5)
    feed(port_store, 4, 2004, hot=5)
    want = wire(ref_fc.step(list(ref_store.stages())), ref_core)
    got = wire(port_fc.step(list(port_store.stages())), port_core)
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.pop("value"), w.pop("value"), **TOL)
        assert g == w
    np.testing.assert_allclose(port_fc._h.numpy(), ref_fc._h, **TOL)


def test_scores_windowed_form_and_step_scores():
    rng = np.random.default_rng(31)
    cfg, params, _ = setup(7)
    ref_fc = ref_core.Forecaster(params, cfg, ref_core.JAX_FEATURES,
                                 backend="numpy")
    port_fc = port_core.Forecaster(
        params, port_ssd.ForecastConfig(features=F), port_core.JAX_FEATURES,
        device="cpu")
    ref_store = ref_core.StreamingTraceStore(ref_core.JAX_FEATURES)
    port_store = port_core.StreamingTraceStore(port_core.JAX_FEATURES)
    for tick in range(1, 6):
        feed(ref_store, tick, 3000 + tick, hot=2)
        feed(port_store, tick, 3000 + tick, hot=2)
    rb = ref_core.pack_sequences(list(ref_store.stages()),
                                 ref_core.JAX_FEATURES, 4, seq_bucket=8)
    pb = port_core.pack_sequences(list(port_store.stages()),
                                  port_core.JAX_FEATURES, 4, seq_bucket=8)
    assert pb.x.tobytes() == rb.x.tobytes()
    assert pb.mask.tobytes() == rb.mask.tobytes()
    assert (pb.nodes, pb.stage_ids, pb.task_ids, pb.count) == \
        (rb.nodes, rb.stage_ids, rb.task_ids, rb.count)
    np.testing.assert_allclose(port_fc.scores(pb), ref_fc.scores(rb), **TOL)
    x = rows(rng, 20, F)
    h = rng.normal(0.0, 0.5, (20, cfg.hidden, cfg.state))
    up = np.ones(20)
    for got, want in zip(port_fc.step_scores(x, h, up),
                         ref_fc.step_scores(x, h, up)):
        np.testing.assert_allclose(got, want, **TOL)


def test_backend_names_and_default_device():
    cfg, params, _ = setup(0)
    pcfg = port_ssd.ForecastConfig(features=F)
    with pytest.raises(ValueError, match="unknown forecast backend"):
        port_core.Forecaster(params, pcfg, port_core.JAX_FEATURES,
                             backend="jax", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_core.Forecaster(params, pcfg, port_core.JAX_FEATURES)
