"""No module a benchmark run loads has the top-level name of JAX or of the
JAX package (names compared whole: the port's begins with the JAX
package's)."""
from __future__ import annotations

import json
import subprocess
import sys

from portbench.harness.common import FORBIDDEN, ROOT

SCRIPT = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench.tests import smoke
import portbench.calibrate, portbench.harness.metrics, portbench.harness.trace
for name in ("granite_moe.train.solo", "jamba.serve.prompt"):
    smoke.run(name, seed=7, seconds=0.5)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = SCRIPT.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & set(FORBIDDEN)


def test_the_harness_sources_import_nothing_of_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        text = path.read_text()
        for name in FORBIDDEN:
            assert f"import {name}\n" not in text, path
            assert f"import {name}." not in text, path
            assert f"from {name} " not in text, path
            assert f"from {name}." not in text, path
