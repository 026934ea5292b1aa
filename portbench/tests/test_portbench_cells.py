"""Every cell of ``BENCHMARK.json`` end to end on the host at cut widths:
a sound run is correct, and each fault its driver can have, planted under
the timed path, makes ``correct`` false."""
from __future__ import annotations

import pytest

from portbench.harness.common import benchmark, cell, is_correct
from portbench.tests import smoke

CELLS = [w["name"] for w in benchmark()["workloads"]]
#: The faults a cell of each driver can have.
DRIVER_FAULTS = {"train": ("unchanged", "half_batch"), "serve": ("token",)}
FAULTS = [(name, fault) for name in CELLS
          for fault in DRIVER_FAULTS[cell(name)["workload"]["driver"]]]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out, checks, run = smoke.run(name, seed=2_147_483_659)
    assert out["window"]["attempted"] > 0
    assert out["window"]["failed"] == 0
    assert all(v > 0 for v in out["end_to_end"].values())
    assert is_correct(checks), (checks, getattr(run, "info", None))


@pytest.mark.parametrize("name,fault", FAULTS)
def test_planted_fault_is_not_correct(name, fault):
    _, checks, _ = smoke.run(name, seed=4_294_967_311, fault=fault)
    assert not is_correct(checks), checks
