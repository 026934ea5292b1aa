"""The per-layer metrics that read the program's own spans
(``source: "program_span"`` readers of ``repro_torch.tracing``): a
number above zero from a window run inside a profiler session, as the
traced run has it, and None from a window run without one."""
from __future__ import annotations

import math

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench.harness import common
from portbench.harness.metrics import reader
from portbench.harness.program_spans import window
from portbench.harness.serve import ServeCell
from portbench.harness.train import TrainCell
from portbench.tests import smoke

READERS = {"granite_moe.train.solo": ("fwd_host_ms.train",
                                      "bwd_host_ms.train",
                                      "opt_host_ms.train"),
           "jamba.serve.prompt": ("decode_enqueue_ms.serve",
                                  "token_wait_ms.serve",
                                  "engine_self_ms.serve")}
NEW = [n for names in READERS.values() for n in names]


def readings(name: str, traced: bool) -> dict:
    """One host run of ``name``'s window, inside a CPU profiler session
    where ``traced``: each new reader's value on ``ctx`` as ``run.py``
    builds it, and the program's spans of the window (read at once: the
    next session clears them)."""
    c = smoke.cell(name)
    drive = TrainCell if c["workload"]["driver"] == "train" else ServeCell
    run = drive(c, 2_147_483_659, smoke.CPU, model=smoke.widths(c))
    run.setup()
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            w = run.window(0.5)
    else:
        w = run.window(0.5)
    ctx = {"spans": run.spans, "t0": w["t0"], "t1": w["t1"],
           "window_s": w["t1"] - w["t0"], "trace": None,
           **run.layer_context(w)}
    run.close()
    run.free()
    return {"values": {m: reader(m)(ctx) for m in READERS[name]},
            "spans": window(ctx)}


@pytest.fixture(scope="module")
def runs():
    return {(name, traced): readings(name, traced)
            for name in READERS for traced in (True, False)}


@pytest.mark.parametrize("name,metric", [(n, m) for n, ms in READERS.items()
                                         for m in ms])
def test_reader_gives_a_number_inside_a_session(runs, name, metric):
    value = runs[name, True]["values"][metric]
    assert value is not None and math.isfinite(value) and value > 0, value


@pytest.mark.parametrize("name,metric", [(n, m) for n, ms in READERS.items()
                                         for m in ms])
def test_reader_gives_none_without_a_session(runs, name, metric):
    assert runs[name, False]["values"][metric] is None


@pytest.mark.parametrize("name,paired", [
    ("granite_moe.train.solo", ("train.step", "train.forward",
                                "train.backward", "train.optimizer")),
    ("jamba.serve.prompt", ("serve.decode", "serve.token_read"))])
def test_the_window_holds_the_spans_the_readers_pair(runs, name, paired):
    """Each train step has its forward, backward and optimizer, and each
    decode step's enqueue its token read."""
    spans = runs[name, True]["spans"]
    counts = {n: sum(s.name == n for s in spans) for n in paired}
    assert len(set(counts.values())) == 1 and counts[paired[0]] > 0, counts


def test_every_new_metric_has_its_reader_and_its_cells():
    bench = common.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert (common.BENCH / "metrics" / f"{name}.py").is_file()
        assert m["source"] == "program_span" and m["unit"] == "ms"
        cells = [c for c, names in READERS.items() if name in names]
        assert set(cells) <= set(m["workloads"])


def test_readers_need_no_program_tracing(monkeypatch):
    """On a program without ``repro_torch.tracing`` each reader returns
    None: the benchmark's files laid over an older checkout."""
    import sys

    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    ctx = {"t0": 0.0, "t1": 1e12}
    assert all(reader(m)(ctx) is None for m in NEW)
