"""Per-layer metrics: one reader a metric, ``metrics/<name>.py``, found by
the metric's name.  A reader's ``read(ctx)`` returns the number, or None
where the run holds nothing for it to read; the metric is then left out
of the result line."""
from __future__ import annotations

from .common import load


def reader(name: str):
    return load("metrics", name).read


def read_all(metrics: list[dict], ctx: dict) -> dict:
    out = {}
    for m in metrics:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
