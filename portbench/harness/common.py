"""What every cell shares: finding its files by name, the device, the
traced entries, the result line and the limits it prints."""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
#: Folders searched in turn for ``<kind>/<name>.py`` (a configuration's
#: reference, an entry's recorder, a metric's reader).
SEARCH = [BENCH]
_LOADED: dict[Path, object] = {}
#: Top-level module names that may not be loaded in a benchmark process:
#: JAX and the JAX package (compared whole: the port's name starts with
#: the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The cell's entry of ``BENCHMARK.json`` joined with its workload file
    and its configuration file."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    wl = load_json(BENCH / "workloads" / f"{name}.json")
    cfg = load_json(ROOT / conf["file"])
    metrics = {"end_to_end": [m for m in bench["end_to_end"]
                              if name in m.get("workloads", [name])],
               "per_layer": [m for m in bench["per_layer"]
                             if name in m.get("workloads", [name])]}
    return {"name": name, "entry": entry, "workload": wl, "config": cfg,
            "metrics": metrics}


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the first folder of ``SEARCH``
    that holds it, loaded by file once."""
    path = next((d / kind / f"{name}.py" for d in SEARCH
                 if (d / kind / f"{name}.py").is_file()), None)
    if path is None:
        raise FileNotFoundError(f"no {kind}/{name}.py in {SEARCH}")
    if path not in _LOADED:
        key = f"portbench_{kind}_{name}".replace(".", "_")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def reference(config: dict):
    """The plain reference the configuration names (``"reference"``):
    its model, loss and products, its weight tree and how each leaf is
    made, its parameter count."""
    return load("reference", config["reference"])


def trace_entries(spans, entries: list[dict]) -> None:
    """A device span around each call of every entry, named by its span,
    and what the span's recorder keeps of the call."""
    from repro_torch.kernels import ops

    for e in entries:
        spans.wrap(ops, e["entry"], e["span"], host=False, device=True,
                   record=load("entries", e["span"]).record)


def entry_context(spans, entries: list[dict]) -> dict:
    """Each traced span's recorded calls and device milliseconds."""
    names = [e["span"] for e in entries]
    return {"calls": {n: spans.calls.get(n, []) for n in names},
            "device_ms": {n: spans.device_ms(n) for n in names}}


def port_config(model: dict, **over):
    """The program's configuration object for ``model`` (the
    configuration file's ``model`` fields, as the program names them)."""
    from repro_torch.models.config import ModelConfig

    return ModelConfig(**{**model, **over}).validate()


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def is_correct(checks: list[dict]) -> bool:
    """Every number within its limit (a count ``at_least`` its limit)."""
    return all((c["value"] >= c["limit"]) if c.get("at_least")
               else (c["value"] <= c["limit"]) for c in checks)


def emit_result(result: dict, checks: list[dict]) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result line last on standard output, with
    the same numbers under its last key."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    print(json.dumps(result), flush=True)


def cache_dirs() -> None:
    """Build and kernel caches inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
