"""What-if replay: ``repro_torch`` against ``repro``.

``_replay_torch`` is max / compare / subtract only, so it must equal the
reference's ``_replay_np`` **exactly** (tolerance 0, NaN-free outputs
compared bytewise), and ``WhatIfReplayer.attribute`` of both packages
must attach equal ``Attribution`` records.
"""
from __future__ import annotations

from dataclasses import asdict

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core.whatif import WhatIfReplayer as RefReplayer, _replay_np
from repro_torch.core.whatif import (
    ROW_BUCKET,
    WhatIfReplayer as PortReplayer,
    _replay_torch,
)

from _torch_port_util import random_tasks, window_pair, wire


def run_torch(ends, rebased, mask):
    t0, rec = _replay_torch(torch.from_numpy(ends), torch.from_numpy(rebased),
                            torch.from_numpy(mask))
    return t0.numpy(), rec.numpy()


def assert_same(ends, rebased, mask):
    with np.errstate(invalid="ignore"):  # -inf - -inf on an empty window
        want_t0, want_rec = _replay_np(ends, rebased, mask)
    got_t0, got_rec = run_torch(ends, rebased, mask)
    assert got_t0.dtype == np.float64 and got_rec.dtype == np.float64
    assert got_t0.tobytes() == want_t0.tobytes()
    assert got_rec.tobytes() == want_rec.tobytes()


@pytest.mark.parametrize("seed", range(10))
def test_random_batches_exact(seed):
    rng = np.random.default_rng(seed)
    W, R = int(rng.integers(1, 6)), int(rng.integers(2, 600))
    ends = rng.uniform(1.0, 100.0, (W, R))
    rebased = ends - rng.uniform(0.0, 30.0, (W, R)) * (rng.random((W, R)) < 0.3)
    mask = rng.random((W, R)) < 0.8
    mask[:, 0] = True
    assert_same(ends, rebased, mask)


def test_ties_at_the_top():
    rng = np.random.default_rng(1)
    ends = rng.uniform(1.0, 50.0, (4, 64))
    ends[0, [3, 9]] = 80.0            # two-way tie
    ends[1, [1, 2, 3]] = 90.0         # three-way tie
    ends[2, 5] = 70.0                 # unique max
    ends[3, :] = 5.0                  # everything tied
    rebased = ends * 0.5
    mask = np.ones_like(ends, dtype=bool)
    assert_same(ends, rebased, mask)


def test_all_masked_but_one_and_fully_masked_rows():
    rng = np.random.default_rng(2)
    ends = rng.uniform(1.0, 50.0, (3, ROW_BUCKET))
    rebased = ends - 1.0
    mask = np.zeros_like(ends, dtype=bool)
    mask[0, 17] = True                # one live row
    mask[1, :2] = True                # two live rows
    assert_same(ends, rebased, mask)  # window 2: nothing live at all


def test_rebased_above_end_never_negative():
    ends = np.array([[10.0, 20.0, 30.0, 0.0]])
    rebased = np.array([[15.0, 20.0, 45.0, 0.0]])
    mask = np.array([[True, True, True, False]])
    assert_same(ends, rebased, mask)
    assert (run_torch(ends, rebased, mask)[1] >= 0).all()


@pytest.mark.parametrize("seed", range(6))
def test_attribute_equal_across_packages(seed):
    rng = np.random.default_rng(50 + seed)
    ref_ws, port_ws = [], []
    for k in range(3):
        tasks = random_tasks(rng, n=int(rng.integers(20, 300)), n_nodes=5)
        rw, pw = window_pair(tasks, stage_id=f"s{k}")
        ref_ws.append(rw)
        port_ws.append(pw)
    ref_an = ref_core.BigRootsAnalyzer(ref_core.SPARK_FEATURES,
                                       window_exact_quantiles=True)
    port_an = port_core.BigRootsAnalyzer(port_core.SPARK_FEATURES,
                                         window_exact_quantiles=True,
                                         device="cpu")
    ref_rp = RefReplayer(ref_core.SPARK_FEATURES, backend="numpy")
    port_rp = PortReplayer(port_core.SPARK_FEATURES, device="cpu")
    assert port_rp.backend == "torch"
    n_attr = 0
    for rw, pw in zip(ref_ws, port_ws):
        want = ref_rp.attribute(rw, ref_an.analyze_stage(rw).root_causes)
        got = port_rp.attribute(pw, port_an.analyze_stage(pw).root_causes)
        assert wire(got, port_core) == wire(want, ref_core)
        for g, w in zip(got, want):
            assert asdict(g.attribution) == asdict(w.attribution)
            n_attr += 1
        assert port_rp.last_stage_recovery == ref_rp.last_stage_recovery
    assert n_attr > 0


def test_attribute_over_a_store_and_numpy_backend_of_the_port():
    rng = np.random.default_rng(9)
    ref_store = ref_core.StreamingTraceStore(ref_core.SPARK_FEATURES)
    port_store = port_core.StreamingTraceStore(port_core.SPARK_FEATURES)
    for k in range(3):
        for tid, node, t0, t1, loc, feats in random_tasks(rng, n=60, n_nodes=4):
            for store in (ref_store, port_store):
                store.add_row(tid, f"s{k}", node, t0, t1, loc, feats)
    ref_an = ref_core.BigRootsAnalyzer(ref_core.SPARK_FEATURES)
    port_an = port_core.BigRootsAnalyzer(port_core.SPARK_FEATURES,
                                         device="cpu")
    ref_causes = [c for sa in ref_an.analyze_fleet(list(ref_store.stages()))
                  for c in sa.root_causes]
    port_causes = [c for sa in port_an.analyze_fleet(list(port_store.stages()))
                   for c in sa.root_causes]
    want = wire(RefReplayer(ref_core.SPARK_FEATURES).attribute(
        ref_store, ref_causes), ref_core)
    assert want and any(d["attribution"] for d in want)
    for backend in PortReplayer.BACKENDS:
        rp = PortReplayer(port_core.SPARK_FEATURES, backend=backend,
                          device="cpu")
        assert wire(rp.attribute(port_store, list(port_causes)),
                    port_core) == want


def test_unknown_backend_and_default_device():
    with pytest.raises(ValueError, match="unknown backend"):
        PortReplayer(backend="jax", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PortReplayer()
