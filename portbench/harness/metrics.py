"""Per-layer metrics: one reader a metric, ``metrics/<name>.py``, found by
the metric's name.  A reader's ``read(ctx)`` returns the number, or None
where the run holds nothing for it to read; the metric is then left out
of the result line."""
from __future__ import annotations

import importlib.util

from .common import BENCH


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_all(metrics: list[dict], ctx: dict) -> dict:
    out = {}
    for m in metrics:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
