"""Shared helpers for the ``test_torch_*`` suites: the same seeded numpy
inputs are handed to the JAX package (``repro``) and to the PyTorch
package (``repro_torch``), and the results compared."""
from __future__ import annotations

import numpy as np

import repro.core as ref_core
import repro_torch.core as port_core
from repro_torch.kernels import bigroots_gates as port_gates

METRICS = ("cpu", "disk", "network")


def random_tasks(rng, n=None, n_nodes=None):
    """Task tuples ``(task_id, node, start, end, locality, features)`` over
    the Spark schema, in the style of the JAX package's gate-kernel suite."""
    n = n if n is not None else int(rng.integers(2, 41))
    n_nodes = n_nodes if n_nodes is not None else int(rng.integers(1, 7))
    tasks = []
    for i in range(n):
        start = float(rng.uniform(0.0, 30.0))
        dur = float(rng.uniform(0.5, 60.0))
        feats = {
            "cpu": float(rng.uniform(0, 1)),
            "disk": float(rng.uniform(0, 1)),
            "network": float(rng.uniform(0, 1e8)),
            "read_bytes": float(rng.uniform(0, 1e9)),
            "shuffle_read_bytes": float(rng.uniform(0, 1e9)),
            "jvm_gc_time": float(rng.uniform(0, dur)),
        }
        if rng.random() < 0.2:
            del feats[list(feats)[int(rng.integers(len(feats)))]]
        tasks.append((f"t{i}", f"n{int(rng.integers(n_nodes))}", start,
                      start + dur, int(rng.choice([0, 0, 0, 1, 2])), feats))
    return tasks


def window_pair(tasks, quantile=0.9, stage_id="s", order=None):
    """The same rows in a ``repro`` and a ``repro_torch`` sliding window."""
    out = []
    for core in (ref_core, port_core):
        w = core.SlidingStageWindow(stage_id, core.SPARK_FEATURES,
                                    quantile=quantile)
        for i in (order if order is not None else range(len(tasks))):
            tid, node, t0, t1, loc, feats = tasks[i]
            w.add_row(tid, node, t0, t1, loc, feats)
        out.append(w)
    return out


def timeline_pair(rng, tasks):
    """The same resource samples in both packages' ``ResourceTimeline``."""
    from repro.telemetry import ResourceTimeline as RefTL
    from repro_torch.telemetry import ResourceTimeline as PortTL

    ref, port = RefTL(), PortTL()
    t_hi = max(t[3] for t in tasks) + 10.0
    for node in sorted({t[1] for t in tasks}):
        for metric in METRICS:
            if rng.random() < 0.2:
                continue
            ts = np.arange(-10.0, t_hi, float(rng.uniform(0.7, 2.0)))
            keep = rng.random(ts.size) > 0.3
            samples = [(float(t), float(rng.uniform(0, 1))) for t in ts[keep]]
            rng.shuffle(samples)
            ref.record_many(node, metric, samples)
            port.record_many(node, metric, samples)
    return ref, port


def random_thresholds(rng):
    kw = dict(
        quantile=float(rng.choice([0.5, 0.7, 0.8, 0.9, 0.95])),
        peer_mean=float(rng.choice([1.0, 1.25, 1.5, 2.0])),
        edge_filter=float(rng.choice([0.3, 0.5, 0.8])),
        edge_width=float(rng.choice([1.0, 3.0, 5.0])),
    )
    return ref_core.BigRootsThresholds(**kw), port_core.BigRootsThresholds(**kw)


def wire(causes, core):
    """Causes as sorted wire dicts (the comparison unit across packages)."""
    return sorted((core.cause_to_wire(c) for c in causes),
                  key=lambda d: (d["stage_id"], d["task_id"], d["feature"]))


def random_gate_batch(rng, W=None, R=None, F=None, batch_cls=None):
    """A raw packed gate batch (no analyzer), as in the JAX package's
    ``TestRawBatchEquivalence``."""
    batch_cls = batch_cls or ref_core.FleetGateBatch
    W = W or int(rng.integers(1, 5))
    R = R or int(rng.integers(1, 40))
    F = F or int(rng.integers(1, 15))
    counts = rng.integers(0, R + 1, size=W)
    v = rng.normal(1.0, 2.0, (W, R, F))
    peer_vsum = rng.normal(2.0, 4.0, (W, R, F))
    inter_cnt = rng.integers(0, 6, (W, R, 1)).astype(np.float64)
    intra_cnt = rng.integers(0, 6, (W, R, 1)).astype(np.float64)
    rowmask = np.zeros((W, R, 1))
    for i, c in enumerate(counts):
        rowmask[i, :c, 0] = 1.0
    vsum = rng.normal(0.0, 8.0, (W, 1, F))
    q = rng.normal(0.5, 1.0, (W, 1, F))
    numok = rng.choice([0.0, 1.0], (W, 1, F))
    floor = np.where(rng.random((1, 1, F)) < 0.3, 0.2, -np.inf)
    return batch_cls(v, peer_vsum, inter_cnt, intra_cnt, rowmask,
                     vsum, q, numok, floor, counts)


def special_gate_batch(rng, W, R, F, share=0.25):
    """:func:`random_gate_batch` with about ``share`` of every input's
    entries (values, counts, masks, column vectors, floor) replaced by
    the kernel's ``SPECIAL_VALUES``."""
    b = random_gate_batch(rng, W=W, R=R, F=F)
    for a in gate_args(b):
        hit = rng.random(a.shape) < share
        a[hit] = rng.choice(port_gates.SPECIAL_VALUES, int(hit.sum()))
    return b


def gate_args(b):
    return (b.v, b.peer_vsum, b.inter_cnt, b.intra_cnt, b.rowmask, b.vsum,
            b.q, b.numok, b.floor)
