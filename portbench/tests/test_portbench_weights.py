"""The weights a cell makes, pinned leaf by leaf: each leaf's dtype, shape,
float64 sum and sum of squares for both configurations at the host's cut
widths, two seeds, as ``weights.make`` gave them when the weight tree and
init rules still lived in the harness (``weights_pinned.json``).  A change
of draw order, std, rule or dtype moves a leaf's numbers."""
from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch

from portbench.harness import common, weights
from portbench.tests import smoke

PINNED = json.loads((Path(__file__).parent / "weights_pinned.json")
                    .read_text())


def _config(name: str) -> dict:
    entry = next(c for c in common.benchmark()["configs"]
                 if c["name"] == name)
    return common.load_json(common.ROOT / entry["file"])


@pytest.mark.parametrize("case", PINNED, ids=lambda c: "{}-{}-{}".format(
    c["config"], c["dtype"], c["seed"]))
def test_weights_are_drawn_as_pinned(case):
    config = _config(case["config"])
    m = dict(config["model"], **smoke.SMOKE[case["driver"]])
    made = weights.flat(weights.make(
        common.reference(config), m, case["seed"], smoke.CPU,
        getattr(torch, case["dtype"]), keep_f32=case["keep_f32"]))
    assert list(made) == list(case["leaves"])
    for path, (dtype, shape, total, squares) in case["leaves"].items():
        v = made[path]
        assert (str(v.dtype), list(v.shape)) == ("torch." + dtype, shape), \
            path
        v = v.double()
        assert float(v.square().sum()) == pytest.approx(squares, rel=1e-6), \
            path
        assert abs(float(v.sum()) - total) <= 1e-6 * math.sqrt(squares) \
            + 1e-12, path
