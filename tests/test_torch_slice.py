"""The slice as a whole: the same seeded stream of ``StepDelta`` payloads
(4 hosts x 3 stages x 10 ticks, one injected hot host) goes into the
reference's ``FleetAggregator(attribution=True)`` with ``backend="numpy"``
and into the port's with ``device="cpu"``, each with a ``Forecaster`` and
driven through ``Diagnosis.fleet(...).tick``.  The tick-by-tick lists of
cause wire dicts must be equal: floats compared exactly, except ``value``
(and the risk quoted in ``guidance``) of ``predicted_straggler``
candidates at ``atol = rtol = 1e-12`` (the forecast cell's stated
tolerance between numpy and torch)."""
from __future__ import annotations

import numpy as np
import pytest

import repro.core as ref_core
import repro.serve as ref_serve
import repro.telemetry as ref_tel
import repro_torch.core as port_core
import repro_torch.serve as port_serve
import repro_torch.telemetry as port_tel
from repro.models.forecast_ssd import ForecastConfig as RefCfg, forecast_init
from repro_torch.models.forecast_ssd import ForecastConfig as PortCfg

HOSTS, STAGES, TICKS, ROWS = 4, 3, 10, 16
HOT = "h2/n3"


def payloads(tel, tick, seed):
    """One tick of the stream: a wire payload per remote host (hosts 1..3)
    and the driving host's own rows through its ``StepTelemetry``."""
    out = []
    for h in range(1, HOSTS):
        rng = np.random.default_rng([seed, tick, h])
        stages = []
        for s in range(STAGES):
            nodes = [f"h{h}/n{i % 4}" for i in range(ROWS)]
            hot = np.array([n == HOT for n in nodes]) & (tick >= 3)
            dur = rng.lognormal(0.0, 0.1, ROWS) * 10.0 * np.where(hot, 2.5, 1.0)
            start = np.full(ROWS, 100.0 * tick)
            cols = {
                "cpu": np.where(hot, 0.95, rng.uniform(0.1, 0.3, ROWS)),
                "disk": rng.uniform(0.15, 0.2, ROWS),
                "network": rng.uniform(5e5, 6e5, ROWS),
                "read_bytes": rng.uniform(0.95, 1.05, ROWS) * 64e6,
                "gc_time": rng.uniform(0, 0.05, ROWS),
                "data_load_time": rng.uniform(0, 0.4, ROWS)
                * np.where(hot, 8.0, 1.0),
            }
            stages.append(tel.StageDelta(
                f"steps_{s:06d}",
                [f"{n}/t{tick}r{i}" for i, n in enumerate(nodes)], nodes,
                start, start + dur, np.zeros(ROWS, dtype=np.int16), cols,
                {k: np.ones(ROWS, dtype=bool) for k in cols}))
        out.append(tel.StepDelta(f"h{h}", tick, stages, boot=1).to_bytes())
    return out


def drive(core, serve, tel, cfg_cls, seed, **device_kw):
    schema = core.JAX_FEATURES
    backend = "numpy" if not device_kw else "torch"
    analyzer = core.BigRootsAnalyzer(schema, backend=backend, **device_kw)
    agg = serve.FleetAggregator(schema, analyzer, attribution=True)
    cfg = cfg_cls(features=len(schema))
    forecaster = core.Forecaster(
        forecast_init(RefCfg(features=len(schema)), seed=seed), cfg, schema,
        backend=backend, risk_threshold=0.45, hold_steps=3, min_history=2,
        seq_bucket=16, **device_kw)
    diag = serve.Diagnosis.fleet(agg, forecaster=forecaster)
    clock = iter(np.arange(0.0, 1e4, 0.25).tolist())
    telem = tel.StepTelemetry("h0/n0", wire=True, window=1, boot=1,
                              clock=lambda: next(clock))
    ticks, raw = [], []
    for tick in range(1, TICKS + 1):
        wire_payloads = payloads(tel, tick, seed)
        raw.append(wire_payloads)
        for p in wire_payloads:
            agg.ingest(p)
        with telem.step(tick % STAGES) as s:
            s.add("read_bytes", 64e6)
        fresh = diag.tick(telem, step_time=1.0)
        ticks.append([core.cause_to_wire(c) for c in fresh])
    return ticks, raw, agg


@pytest.mark.parametrize("seed", [0, 1])
def test_slice_tick_by_tick_causes_equal(seed):
    want, ref_raw, ref_agg = drive(ref_core, ref_serve, ref_tel, RefCfg, seed)
    got, port_raw, port_agg = drive(port_core, port_serve, port_tel, PortCfg,
                                    seed, device="cpu")
    assert port_raw == ref_raw                     # same bytes went in
    assert port_agg.rows_ingested == ref_agg.rows_ingested > 0
    confirmed = attributed = predicted = 0
    for tick, (g_tick, w_tick) in enumerate(zip(got, want), 1):
        assert len(g_tick) == len(w_tick), f"tick {tick}"
        for g, w in zip(g_tick, w_tick):
            if w["feature"] == "predicted_straggler":
                predicted += 1
                g, w = dict(g), dict(w)
                np.testing.assert_allclose(g.pop("value"), w.pop("value"),
                                           atol=1e-12, rtol=1e-12)
                assert g.pop("guidance")[:30] == w.pop("guidance")[:30]
            else:
                confirmed += 1
                attributed += w["attribution"] is not None
            assert g == w, f"tick {tick}"
    assert confirmed > 0 and attributed > 0 and predicted > 0
    assert any(w["node"] == HOT and w["feature"] == "cpu"
               for t in want for w in t)


def test_port_numpy_backend_equals_port_torch_backend():
    """The oracle the GPU smoke run uses: the port with ``backend="numpy"``
    against the port with ``backend="torch"`` on the same payloads."""
    a, _, _ = drive(port_core, port_serve, port_tel, PortCfg, 3, device="cpu")
    schema = port_core.JAX_FEATURES
    # same drive, gates through the numpy oracle
    orig = port_core.BigRootsAnalyzer.__init__

    def numpy_gates(self, *args, **kw):
        kw["backend"] = "numpy"
        orig(self, *args, **kw)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(port_core.BigRootsAnalyzer, "__init__", numpy_gates)
        b, _, _ = drive(port_core, port_serve, port_tel, PortCfg, 3,
                        device="cpu")
    finally:
        mp.undo()
    assert a == b and any(a)
    assert len(schema) == 14
