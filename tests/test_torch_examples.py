"""The six examples of ``repro_torch.examples`` on the CPU.

Each runs as a subprocess, ``python -m repro_torch.examples.<name>
--device cpu`` with its smallest documented arguments, and must exit 0
with ``OK`` on its last line.  ``quickstart`` and ``anomaly_study`` must
print the same report as the JAX package's ``examples/`` run beside them
(exact: the same simulated cluster and the same analysis; the port adds
only ``anomaly_study``'s closing ``OK``).
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}

EXAMPLES = {
    "quickstart": [],
    "anomaly_study": [],
    "fault_tolerance_demo": [],
    "serve_demo": [],
    "train_100m_bigroots": ["--steps", "48"],
    "fleet_demo": ["--hosts", "2", "--steps", "24", "--kill-after", "8",
                   "--lease", "1.0"],
}
#: The reference examples whose report the port's must repeat.
SAME_REPORT = {"quickstart": "quickstart.py",
               "anomaly_study": "anomaly_study.py"}


def _run(cmd: list[str]) -> str:
    out = subprocess.run(cmd, env=ENV, cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu_and_prints_ok(name):
    got = _run([sys.executable, "-m", f"repro_torch.examples.{name}",
                "--device", "cpu", *EXAMPLES[name]])
    last = got.strip().splitlines()[-1]
    assert last.startswith("OK"), got[-2000:]
    if name in SAME_REPORT:
        want = _run([sys.executable,
                     str(ROOT / "examples" / SAME_REPORT[name])])
        lines = got.strip().splitlines()
        want_lines = want.strip().splitlines()
        if want_lines[-1] != "OK":
            lines = lines[:-1]
        assert lines == want_lines


def test_every_reference_example_has_its_port():
    ref = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    port = sorted(p.stem for p in (ROOT / "src" / "repro_torch" /
                                   "examples").glob("*.py")
                  if p.stem != "__init__")
    assert ref == port == sorted(EXAMPLES)
