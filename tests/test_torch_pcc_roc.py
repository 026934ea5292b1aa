"""The PCC baseline, the ROC harness and the loop-based oracle:
``repro_torch`` against ``repro``.

All three are numpy and stdlib on both sides, so every comparison is
exact: the same seeded tasks give the same PCC (task, feature) sets, the
same confusion counts, the same ROC points and the same areas.  The
port's loop-based oracle (``core/reference.py``) is held to the
reference's oracle and to the port's own analyzer (``device="cpu"``),
and the invariants of the reference's property suite
(``test_property_analyzer.py``) are checked on the port with seeded
inputs in place of ``hypothesis``.
"""
from __future__ import annotations

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core import reference as ref_oracle
from repro.core import roc as ref_roc
from repro_torch.core import reference as port_oracle
from repro_torch.core import roc as port_roc

from _torch_port_util import random_tasks, random_thresholds, timeline_pair

PACKAGES = (ref_core, port_core)


def stage_of(core, tasks, stage_id="s"):
    return core.StageRecord(stage_id, [
        core.TaskRecord(task_id=tid, stage_id=stage_id, node=node, start=t0,
                        end=t1, locality=loc, features=dict(feats))
        for tid, node, t0, t1, loc, feats in tasks
    ])


def mk(core, i, node, dur, start=0.0, locality=0, **features):
    return core.TaskRecord(task_id=f"t{i}", stage_id="s0", node=node,
                           start=start, end=start + dur, locality=locality,
                           features=features)


def analyzer(core, th=None, timelines=None):
    th = th if th is not None else core.BigRootsThresholds()
    if core is port_core:
        return core.BigRootsAnalyzer(core.SPARK_FEATURES, th,
                                     timelines=timelines, device="cpu")
    return core.BigRootsAnalyzer(core.SPARK_FEATURES, th, timelines=timelines)


# -- PCC (Eq. 8), mirroring the reference's TestPCC ---------------------------

def correlated(core):
    rng = np.random.default_rng(0)
    tasks = []
    for i in range(30):
        dur = 10.0 + (i ** 2) * 0.05
        tasks.append(mk(core, i, f"n{i % 4}", dur,
                        read_bytes=dur * 100 + rng.normal(0, 10)))
    return tasks, core.PCCThresholds(pearson=0.5, max_quantile=0.8)


def uncorrelated(core):
    rng = np.random.default_rng(1)
    tasks = [mk(core, i, f"n{i % 4}", 10.0,
                read_bytes=float(rng.uniform(50, 150))) for i in range(30)]
    tasks.append(mk(core, 99, "n9", 30.0, read_bytes=100.0))
    return tasks, core.PCCThresholds()


def zero_variance(core):
    tasks = [mk(core, i, f"n{i % 4}", 10.0, read_bytes=100.0)
             for i in range(10)]
    tasks.append(mk(core, 99, "n9", 30.0, read_bytes=100.0))
    return tasks, core.PCCThresholds()


def pcc_found(core, make):
    tasks, th = make(core)
    pcc = core.PCCAnalyzer(core.SPARK_FEATURES, th)
    return pcc.analyze_stage(core.StageRecord("s0", tasks))


@pytest.mark.parametrize("make,check", [
    (correlated, lambda found: any(f == "read_bytes" for _, f in found)),
    (uncorrelated, lambda found: not {f for _, f in found
                                      if f == "read_bytes"}),
    (zero_variance, lambda found: isinstance(found, set)),
], ids=["correlated_feature_found", "uncorrelated_not_found",
        "zero_variance_guard"])
def test_pcc_cases_match_the_reference(make, check):
    got = pcc_found(port_core, make)
    assert got == pcc_found(ref_core, make)
    assert check(got)


@pytest.mark.parametrize("seed", range(12))
def test_pcc_random_stages_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    tasks = random_tasks(rng)
    kw = dict(pearson=float(rng.choice([0.1, 0.3, 0.5, 0.7])),
              max_quantile=float(rng.choice([0.5, 0.8, 0.9])))
    got, want = (
        core.PCCAnalyzer(core.SPARK_FEATURES, core.PCCThresholds(**kw))
        .root_cause_set(core.Trace([stage_of(core, tasks)]))
        for core in (port_core, ref_core)
    )
    assert got == want


# -- ROC harness ----------------------------------------------------------------

def test_confusion_counts_match_the_reference():
    rng = np.random.default_rng(7)
    universe = {(f"t{i}", f) for i in range(40)
                for f in ("cpu", "disk", "read_bytes")}
    pairs = sorted(universe)
    for _ in range(20):
        found = {p for p in pairs if rng.random() < 0.3}
        truth = {p for p in pairs if rng.random() < 0.2}
        found.add(("outside", "cpu"))  # pairs outside the universe drop
        got = port_roc.evaluate(found, truth, universe)
        want = ref_roc.evaluate(found, truth, universe)
        assert (got.tp, got.tn, got.fp, got.fn) == \
            (want.tp, want.tn, want.fp, want.fn)
        assert (got.tpr, got.fpr, got.acc, got.precision) == \
            (want.tpr, want.fpr, want.acc, want.precision)


def sweep(core, roc, tasks, truth, universe):
    """BigRoots over a (quantile, peer_mean) grid, as the paper's Fig. 8."""
    stage = stage_of(core, tasks)

    def analyze(q, pm):
        th = core.BigRootsThresholds(quantile=q, peer_mean=pm)
        return core.found_set(
            analyzer(core, th).analyze_stage(stage).root_causes)

    grid = [(q, pm) for q in (0.5, 0.7, 0.9) for pm in (1.0, 1.5, 2.0)]
    return roc.roc_sweep(analyze, truth, universe, grid)


@pytest.mark.parametrize("seed", range(6))
def test_roc_sweep_and_auc_match_the_reference(seed):
    rng = np.random.default_rng(100 + seed)
    tasks = random_tasks(rng, n=int(rng.integers(12, 41)))
    # truth: the oracle's verdict at the default thresholds; universe: every
    # (task, feature) pair of the stage
    truth = ref_oracle.reference_root_causes(
        stage_of(ref_core, tasks), ref_core.SPARK_FEATURES)
    universe = {(t[0], f) for t in tasks
                for f in ref_core.SPARK_FEATURES.names}
    got = sweep(port_core, port_roc, tasks, truth, universe)
    want = sweep(ref_core, ref_roc, tasks, truth, universe)
    assert [(p.fpr, p.tpr, p.params) for p in got] == \
        [(p.fpr, p.tpr, p.params) for p in want]
    assert port_roc.auc(got) == ref_roc.auc(want)
    assert 0.0 <= port_roc.auc(got) <= 1.0


@pytest.mark.parametrize("seed", range(6))
def test_score_points_and_auc_match_the_reference(seed):
    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(1, 60))
    # rounded scores so ties occur
    scores = [float(s) for s in np.round(rng.random(n), 1)]
    labels = [int(v) for v in rng.random(n) < 0.3]
    got = port_roc.score_points(scores, labels)
    want = ref_roc.score_points(scores, labels)
    assert [(p.fpr, p.tpr, p.params) for p in got] == \
        [(p.fpr, p.tpr, p.params) for p in want]
    assert port_roc.score_auc(scores, labels) == \
        ref_roc.score_auc(scores, labels)
    assert port_roc.auc(got) == ref_roc.auc(want)


def test_auc_corners():
    RocPoint, auc = port_roc.RocPoint, port_roc.auc
    assert auc([RocPoint(0.0, 1.0, ())]) == 1.0
    assert abs(auc([RocPoint(x, x, ()) for x in (0.25, 0.5, 0.75)])
               - 0.5) < 1e-9
    rng = np.random.default_rng(3)
    for _ in range(50):
        pts = [RocPoint(float(f), float(t), ())
               for f, t in rng.random((int(rng.integers(1, 21)), 2))]
        assert 0.0 <= auc(pts) <= 1.0
    with pytest.raises(ValueError):
        port_roc.score_auc([0.1], [1, 0])
    assert port_roc.score_auc([0.2, 0.4], [1, 1]) == 0.5


# -- the loop-based oracle ------------------------------------------------------

@pytest.mark.parametrize("seed", range(20))
def test_oracle_matches_the_reference_oracle_and_the_port_analyzer(seed):
    rng = np.random.default_rng(300 + seed)
    tasks = random_tasks(rng)
    ref_th, port_th = random_thresholds(rng)
    ref_tl, port_tl = timeline_pair(rng, tasks) if seed % 2 else (None, None)
    want = ref_oracle.reference_root_causes(
        stage_of(ref_core, tasks), ref_core.SPARK_FEATURES, ref_th,
        timelines=ref_tl)
    port_stage = stage_of(port_core, tasks)
    got = port_oracle.reference_root_causes(
        port_stage, port_core.SPARK_FEATURES, port_th, timelines=port_tl)
    assert got == want
    found = port_core.found_set(analyzer(port_core, port_th, port_tl)
                                .analyze_stage(port_stage).root_causes)
    assert found == got


def test_oracle_corners():
    """Empty peer groups and tiny stages, as in the reference's frame
    equivalence suite."""
    cases = [
        # every task on one node: no inter-node peers
        [(f"t{i}", "n0", 0.0, 10.0 + (30.0 if i == 0 else 0.0), 0,
          {"cpu": 0.9 if i == 0 else 0.1}) for i in range(8)],
        # the straggler alone on its node: no intra-node peers
        [(f"t{i}", f"n{1 + i % 3}", 0.0, 10.0, 0, {"read_bytes": 100.0})
         for i in range(9)] + [("t99", "n9", 0.0, 40.0, 0,
                                {"read_bytes": 900.0})],
        [("t0", "n0", 0.0, 1.0, 0, {}), ("t1", "n1", 0.0, 5.0, 1, {})],
        [],
    ]
    for tasks in cases:
        want = ref_oracle.reference_root_causes(
            stage_of(ref_core, tasks), ref_core.SPARK_FEATURES)
        got = port_oracle.reference_root_causes(
            stage_of(port_core, tasks), port_core.SPARK_FEATURES)
        assert got == want
        if tasks:
            assert port_core.found_set(
                analyzer(port_core).analyze_stage(
                    stage_of(port_core, tasks)).root_causes) == got


# -- the invariants of the reference's property suite ---------------------------

@pytest.mark.parametrize("seed", range(8))
def test_analyzer_invariants(seed):
    rng = np.random.default_rng(400 + seed)
    tasks = random_tasks(rng)
    stage = stage_of(port_core, tasks)
    an = analyzer(port_core)
    sa = an.analyze_stage(stage)
    found = port_core.found_set(sa.root_causes)
    # only stragglers are flagged
    assert {c.task_id for c in sa.root_causes} <= set(sa.straggler_ids)
    # task order is irrelevant
    perm = list(stage.tasks)
    rng.shuffle(perm)
    assert port_core.found_set(an.analyze_stage(
        port_core.StageRecord("s", perm)).root_causes) == found
    # numerical features are stage-mean normalised: scaling bytes is a no-op
    scaled = [(tid, node, t0, t1, loc,
               {k: (v * 1000.0 if k.endswith("bytes") else v)
                for k, v in feats.items()})
              for tid, node, t0, t1, loc, feats in tasks]
    assert port_core.found_set(an.analyze_stage(
        stage_of(port_core, scaled)).root_causes) == found
    # a higher straggler threshold only shrinks the straggler set
    durs = np.array([t.duration for t in stage.tasks])
    factor = float(rng.uniform(1.05, 3.0))
    lo = port_core.straggler_mask(durs, 1.5)
    hi = port_core.straggler_mask(durs, 1.5 * factor)
    assert not np.any(hi & ~lo)
    # a stricter quantile only removes findings (locality ignores it)
    q1, q2 = sorted(float(q) for q in rng.random(2))
    lo, hi = (
        {p for p in port_core.found_set(analyzer(
            port_core, port_core.BigRootsThresholds(quantile=q))
            .analyze_stage(stage).root_causes) if p[1] != "locality"}
        for q in (q1, q2)
    )
    assert hi <= lo
