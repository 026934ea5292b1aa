"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (weights from the seed on the device, the cell's shapes warmed up)
counts as ``setup_s``; the window then runs for ``--seconds``; the
program's outputs are checked against the plain reference; the last line
on standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``;
``checks`` last: each number compared beside its limit).  Exits non-zero
without a result where no CUDA device is present, or where JAX or the
JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import common  # noqa: E402

DRIVERS = {"train": "portbench.harness.train:TrainCell",
           "serve": "portbench.harness.serve:ServeCell"}


def driver(kind: str):
    mod, cls = DRIVERS[kind].split(":")
    return getattr(__import__(mod, fromlist=[cls]), cls)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    common.cache_dirs()
    import torch

    cell = common.cell(args.workload)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = driver(cell["workload"]["driver"])(cell, args.seed, device)
    torch.cuda.reset_peak_memory_stats(device)
    run.setup()
    gc.collect()
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START
    print("set-up seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in getattr(run, "times", {}).items()),
        file=sys.stderr)

    trace = None
    if args.trace:
        run.trace_entries()
        from portbench.harness.trace import DeviceTrace

        with DeviceTrace() as tr:
            w = run.window(args.seconds)
        trace = tr.reduce(w["t0"], w["t1"], run.spans.host)
    else:
        w = run.window(args.seconds)
    peak = torch.cuda.max_memory_allocated(device)
    window_s = w["t1"] - w["t0"]
    if args.trace:
        ctx = {"spans": run.spans, "t0": w["t0"], "t1": w["t1"],
               "window_s": window_s, "trace": trace,
               **run.layer_context(w)}
        from portbench.harness.metrics import read_all

        metrics = read_all(cell["metrics"]["per_layer"], ctx)
    else:
        e2e = run.end_to_end(w)
        e2e["setup_s"] = setup_s
        units = {m["name"]: m["unit"] for m in cell["metrics"]["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items()
                   if k in units}
    run.close()
    run.free()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = run.check()
    for k, v in getattr(run, "info", {}).items():
        print(f"reading {k}: {v!r} (not compared)", file=sys.stderr)
    found = common.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    correct = common.is_correct(checks)
    result = {
        "correct": bool(correct and w["failed"] == 0),
        "attempted": w["attempted"],
        "failed": w["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": chips, "memory_peak_bytes": int(peak)},
    }
    if args.trace:
        result["device"]["busy_s"] = trace["busy_s"]
        result["device"]["window_s"] = window_s
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    common.emit_result(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
