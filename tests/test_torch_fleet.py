"""Packing and the fleet sweep: ``repro_torch`` against ``repro``.

The same rows go into a sliding window of each package.  ``pack_windows``
must give byte-identical batches (all ten fields, tolerance 0), and the
port's ``analyze_fleet`` (``backend="torch"``, ``device="cpu"``: the plain
version of the gate kernel) must emit causes whose wire dicts equal those
of the reference's ``backend="numpy"`` — floats compared exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core.fleet import pack_windows as ref_pack
from repro_torch.core.fleet import GateStaging, pack_windows as port_pack

from _torch_port_util import (
    random_tasks,
    random_thresholds,
    timeline_pair,
    window_pair,
    wire,
)

FIELDS = ("v", "peer_vsum", "inter_cnt", "intra_cnt", "rowmask", "vsum", "q",
          "numok", "floor", "counts")


def analyzer_pair(th=None, timelines=(None, None), exact=True):
    rth, pth = th if th is not None else (ref_core.BigRootsThresholds(),
                                          port_core.BigRootsThresholds())
    ref = ref_core.BigRootsAnalyzer(
        ref_core.SPARK_FEATURES, rth, timelines=timelines[0],
        window_exact_quantiles=exact, backend="numpy")
    port = port_core.BigRootsAnalyzer(
        port_core.SPARK_FEATURES, pth, timelines=timelines[1],
        window_exact_quantiles=exact, backend="torch", backend_min_rows=0,
        device="cpu")
    return ref, port


def slow_tasks(n, n_slow, seed):
    r = np.random.default_rng(seed)
    return [
        (f"t{i}", f"n{i % 3}", 0.0,
         30.0 if i < n_slow else float(r.uniform(8.0, 12.0)), 0,
         {"cpu": float(r.random()),
          "read_bytes": float(r.uniform(0, 1e9)),
          "jvm_gc_time": float(r.uniform(0, 8.0))})
        for i in range(n)
    ]


def entries_for(an, windows, exact=True):
    out = []
    for w in windows:
        pre = an._window_prelude(w)
        assert isinstance(pre, tuple)
        n, _, s_rows, _, _ = pre
        out.append((w, s_rows, n, w.v[s_rows], w.quantiles(0.9, exact=exact)))
    return out


def assert_batches_equal(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("row_bucket", [8, 256])
def test_pack_windows_byte_identical(row_bucket, exact):
    ref_an, port_an = analyzer_pair()
    pairs = [window_pair(slow_tasks(n, k, seed), stage_id=f"s{seed}")
             for seed, (n, k) in enumerate([(50, 8), (40, 3), (300, 40)])]
    ref_b = ref_pack(entries_for(ref_an, [p[0] for p in pairs], exact),
                     ref_core.SPARK_FEATURES, 0.2, row_bucket=row_bucket)
    port_b = port_pack(entries_for(port_an, [p[1] for p in pairs], exact),
                       port_core.SPARK_FEATURES, 0.2, row_bucket=row_bucket)
    assert_batches_equal(ref_b, port_b)
    assert port_b.pinned is None  # CPU packing never pins


def test_pack_windows_scratch_reuse_no_stale_state():
    ref_an, port_an = analyzer_pair()
    t1 = [window_pair(slow_tasks(50, 8, 1), stage_id="a"),
          window_pair(slow_tasks(40, 3, 2), stage_id="b")]
    t2 = [window_pair(slow_tasks(60, 5, 3), stage_id="c"),
          window_pair(slow_tasks(30, 2, 4), stage_id="d")]
    tick1 = entries_for(port_an, [p[1] for p in t1])
    tick2 = entries_for(port_an, [p[1] for p in t2])
    scratch = port_pack(tick1, port_core.SPARK_FEATURES, 0.2, row_bucket=8)
    reused = port_pack(tick2, port_core.SPARK_FEATURES, 0.5, scratch=scratch,
                       row_bucket=8)
    fresh = port_pack(tick2, port_core.SPARK_FEATURES, 0.5, row_bucket=8)
    assert reused.v is scratch.v  # the reuse actually happened
    assert_batches_equal(reused, fresh)
    want = ref_pack(entries_for(ref_an, [p[0] for p in t2]),
                    ref_core.SPARK_FEATURES, 0.5, row_bucket=8)
    assert_batches_equal(reused, want)
    staging = GateStaging(port_an.device)
    np.testing.assert_array_equal(
        staging.run(reused, 1.5), ref_core.eval_gates_np(want, 1.5))


@pytest.mark.parametrize("seed", range(12))
def test_analyze_fleet_with_timelines(seed):
    rng = np.random.default_rng(seed)
    th = random_thresholds(rng)
    ref_ws, port_ws, all_tasks = [], [], []
    for k in range(int(rng.integers(2, 5))):
        tasks = random_tasks(rng, n=int(rng.integers(3, 60)))
        order = rng.permutation(len(tasks))
        rw, pw = window_pair(tasks, th[0].quantile, f"s{k}", order)
        ref_ws.append(rw)
        port_ws.append(pw)
        all_tasks += tasks
    ref_an, port_an = analyzer_pair(th, timeline_pair(rng, all_tasks))
    want = ref_an.analyze_fleet(ref_ws)
    got = port_an.analyze_fleet(port_ws)
    assert [sa.stage_id for sa in got] == [sa.stage_id for sa in want]
    for g, w in zip(got, want):
        assert wire(g.root_causes, port_core) == wire(w.root_causes, ref_core)
        assert g.straggler_ids == w.straggler_ids
        assert g.median_duration == w.median_duration


@pytest.mark.parametrize("seed", range(6))
def test_analyze_fleet_without_timelines_sketch_mode(seed):
    """Default sketch-λq mode (no exact quantiles, no Eq. 6 store)."""
    rng = np.random.default_rng(100 + seed)
    pairs = [
        window_pair(random_tasks(rng, n=int(rng.integers(30, 200))),
                    0.9, f"s{k}")
        for k in range(4)
    ]
    ref_an, port_an = analyzer_pair(exact=False)
    want = ref_an.analyze_fleet([p[0] for p in pairs])
    got = port_an.analyze_fleet([p[1] for p in pairs])
    for g, w in zip(got, want):
        assert wire(g.root_causes, port_core) == wire(w.root_causes, ref_core)


@pytest.mark.parametrize("seed", range(4))
def test_analyze_stage_window_matches_fleet(seed):
    """Per-window dispatch (``backend_min_rows=0``) equals the fleet sweep
    and the reference."""
    rng = np.random.default_rng(300 + seed)
    tasks = random_tasks(rng, n=40)
    rw, pw = window_pair(tasks)
    ref_an, port_an = analyzer_pair()
    want = wire(ref_an.analyze_stage(rw).root_causes, ref_core)
    assert wire(port_an.analyze_stage(pw).root_causes, port_core) == want
    assert wire(port_an.analyze_fleet([pw])[0].root_causes, port_core) == want


@pytest.mark.parametrize("seed", range(4))
def test_single_node_empty_inter_peers(seed):
    rng = np.random.default_rng(2000 + seed)
    th = random_thresholds(rng)
    rw, pw = window_pair(random_tasks(rng, n_nodes=1), th[0].quantile)
    ref_an, port_an = analyzer_pair(th)
    assert (wire(port_an.analyze_fleet([pw])[0].root_causes, port_core)
            == wire(ref_an.analyze_fleet([rw])[0].root_causes, ref_core))


def test_lonely_node_straggler_empty_intra_peers():
    tasks = [(f"t{i}", f"n{i % 3}", 0.0, 10.0, 0, {"read_bytes": 100.0})
             for i in range(12)]
    tasks.append(("t99", "lonely", 0.0, 30.0, 0, {"read_bytes": 900.0}))
    rw, pw = window_pair(tasks)
    ref_an, port_an = analyzer_pair()
    got = wire(port_an.analyze_fleet([pw])[0].root_causes, port_core)
    assert got == wire(ref_an.analyze_fleet([rw])[0].root_causes, ref_core)
    hit = [d for d in got if (d["task_id"], d["feature"]) == ("t99", "read_bytes")]
    assert hit and hit[0]["peer_groups"] == ["inter"]


def test_nonpositive_numerical_mean_guard():
    tasks = [(f"t{i}", f"n{i % 2}", 0.0, 30.0 if i == 0 else 10.0, 0,
              {"read_bytes": -100.0, "jvm_gc_time": 8.0 if i == 0 else 0.1})
             for i in range(10)]
    rw, pw = window_pair(tasks)
    ref_an, port_an = analyzer_pair()
    got = wire(port_an.analyze_fleet([pw])[0].root_causes, port_core)
    assert got == wire(ref_an.analyze_fleet([rw])[0].root_causes, ref_core)
    assert not any(d["feature"] == "read_bytes" for d in got)
    assert any(d["feature"] == "jvm_gc_time" for d in got)


def test_backends_and_min_rows():
    assert port_core.BigRootsAnalyzer.BACKENDS == ("numpy", "torch")
    with pytest.raises(ValueError, match="unknown backend"):
        port_core.BigRootsAnalyzer(port_core.SPARK_FEATURES, backend="jax",
                                   device="cpu")
    an = port_core.BigRootsAnalyzer(port_core.SPARK_FEATURES, device="cpu",
                                    backend_min_rows=10_000)
    assert an.backend == "torch"
    calls = []
    orig = an._eval_gates_batch
    an._eval_gates_batch = lambda b: (calls.append(1), orig(b))[1]
    _, pw = window_pair(random_tasks(np.random.default_rng(11), n=20))
    an.analyze_stage(pw)
    assert calls == []           # below the threshold: in-process gates
    an.analyze_fleet([pw])
    assert calls == [1]          # every fleet sweep goes through the wrapper


def test_numpy_backend_of_the_port_is_the_same_oracle():
    rng = np.random.default_rng(7)
    _, pw = window_pair(random_tasks(rng, n=50))
    a = port_core.BigRootsAnalyzer(port_core.SPARK_FEATURES, device="cpu",
                                   backend="numpy")
    b = port_core.BigRootsAnalyzer(port_core.SPARK_FEATURES, device="cpu",
                                   backend="torch")
    assert (wire(a.analyze_fleet([pw])[0].root_causes, port_core)
            == wire(b.analyze_fleet([pw])[0].root_causes, port_core))


def test_gate_staging_exposes_the_last_launch():
    """``last_inputs`` is the batch the gate function read on the last
    sweep (empty before the first), ``last_span`` that sweep's host span."""
    rng = np.random.default_rng(13)
    an = port_core.BigRootsAnalyzer(port_core.SPARK_FEATURES, device="cpu")
    assert an.staging.last_inputs() == () and an.staging.last_span is None
    wins = [window_pair(slow_tasks(60, 7, s), stage_id=f"s{s}")[1]
            for s in range(3)]
    an.analyze_fleet(wins)
    ins = an.staging.last_inputs()
    W, R, F = ins[0].shape
    assert (W, F) == (3, len(port_core.SPARK_FEATURES)) and R % 256 == 0
    assert [tuple(t.shape) for t in ins] == [
        (W, R, F), (W, R, F), (W, R, 1), (W, R, 1), (W, R, 1),
        (W, 1, F), (W, 1, F), (W, 1, F), (1, 1, F)]
    assert all(t.dtype == torch.float64 for t in ins)
    t0, t1 = an.staging.last_span
    assert t0 <= t1
    assert an.staging.last_ms is None    # CUDA events only on a GPU
