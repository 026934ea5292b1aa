#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA package (``repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA::

    python3 chip_smoke.py [--seed 0] [--ticks 5]

What it does, in phases (one JSON line each; any failure raises and the
process exits non-zero):

1. ``env``      torch / CUDA / nvcc versions, the GPU's name and power limit.
2. ``build``    compiles every CUDA kernel of the package from ``csrc/``.
3. ``kernels``  holds each kernel against its plain PyTorch version on the
                GPU (``torch.equal`` on the int8 gate bits: tolerance 0) at
                the full-incident shape and on a corner batch.
4. ``main_path`` drives the per-tick fleet diagnosis sweep through its user
                entry points — ``StepDelta`` bytes into a ``FleetAggregator``
                (default retention, ``attribution=True``), then driven ticks of
                ``Diagnosis.fleet(..., forecaster=...).tick`` — at a fleet of
                64 live stage windows x 16384 rows, and checks every tick's
                causes against a second run of the same package with the
                numpy gate oracle and everything else on the CPU.  Launch
                counters are zeroed just before and read just after.
5. the kernels at the main path's own last packed batch: compare, then time
   kernel, plain version and bound.

The last three lines of standard output are the GPU's name and power limit
as ``nvidia-smi`` gives them, one JSON object ``{"kernels": [...]}``, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import (  # noqa: E402
    BigRootsAnalyzer,
    BigRootsThresholds,
    Forecaster,
    JAX_FEATURES,
    cause_to_wire,
)
from repro_torch.core.forecast import PREDICTED_STRAGGLER  # noqa: E402
from repro_torch.kernels import bigroots_gates, build  # noqa: E402
from repro_torch.models import ForecastConfig, forecast_init  # noqa: E402
from repro_torch.serve import Diagnosis, FleetAggregator  # noqa: E402
from repro_torch.telemetry import StageDelta, StepDelta, StepTelemetry  # noqa: E402

#: Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth, and
#: the float64 rate outside the tensor cores (half the 67 TFLOP/s float32
#: rate) for the operations bound.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 33.5e12
#: sub, div, mul for each of the two peer means, and seven comparisons.
GATE_OPS_PER_ELEMENT = 13
#: The fleet: 64 live stage windows (the aggregator's default retention) of
#: 16384 rows each, filled by 32 senders; every tick 4 senders add 64 fresh
#: rows to every stage.  Only the number of ticks can be cut.
STAGES = 64
ROWS = 16384
SENDERS = 32
FRESH_SENDERS = 4
FRESH_ROWS = 64
NODE_NAMES = 512
RISK_TOL = 1e-12


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, message: str) -> None:
    """A failed check fails the run (also under ``python -O``)."""
    if not cond:
        raise RuntimeError(message)


# -- data ---------------------------------------------------------------------

def incident_columns(n: int, rng) -> dict:
    """A fleet-incident block of ``n`` rows: the Mantri threshold flags
    ~20% of rows as stragglers while only a ~0.2% hot set (at least one
    row) carries an attributable feature signal."""
    dur = rng.lognormal(mean=0.0, sigma=0.18, size=n) * 10.0
    slow = rng.choice(n, size=max(n // 5, 1), replace=False)
    dur[slow] *= 1.9
    cpu = rng.uniform(0.1, 0.3, n)
    hot = slow[: max(n // 500, 1)]
    cpu[hot] = 0.95
    return {
        "dur": dur,
        "hot": hot,
        "features": {
            "cpu": cpu,
            "disk": rng.uniform(0.15, 0.2, n),
            "network": rng.uniform(5e5, 6e5, n),
            "read_bytes": rng.uniform(0.95, 1.05, n) * 64e6,
            "gc_time": rng.uniform(0, 0.05, n),
            "data_load_time": rng.uniform(0, 0.4, n),
            "h2d_time": rng.uniform(0, 0.1, n),
        },
    }


def sender_payload(sender: int, seq: int, rows: int, first: int, tag: str,
                   seed: int) -> tuple[bytes, set]:
    """One sender's ``StepDelta`` wire payload: ``rows`` rows for each of
    the ``STAGES`` stage windows (hosts ``first .. first+rows-1``).  Returns
    the bytes and the injected hot task ids."""
    blocks, hot_ids = [], set()
    for s in range(STAGES):
        rng = np.random.default_rng([seed, sender, seq, s])
        cols = incident_columns(rows, rng)
        hosts = np.arange(first, first + rows)
        task_ids = [f"h{h}/{tag}s{s}" for h in hosts]
        hot_ids.update(task_ids[i] for i in cols["hot"])
        blocks.append(StageDelta(
            f"steps_{s:06d}", task_ids,
            [f"h{h % NODE_NAMES}" for h in hosts],
            np.zeros(rows), cols["dur"], np.zeros(rows, dtype=np.int16),
            cols["features"],
            {k: np.ones(rows, dtype=bool) for k in cols["features"]},
        ))
    return StepDelta(f"sender{sender}", seq, blocks, boot=1).to_bytes(), hot_ids


def make_stream(args) -> dict:
    """The whole run's payloads, made once and fed to both runs."""
    per_sender = ROWS // SENDERS
    fill, hot = [], set()
    for sender in range(SENDERS):
        raw, h = sender_payload(sender, 1, per_sender, sender * per_sender,
                                "", args.seed)
        fill.append(raw)
        hot |= h
    ticks = []
    for tick in range(args.ticks):
        batch, tick_hot = [], set()
        for sender in range(FRESH_SENDERS):
            raw, h = sender_payload(
                sender, 2 + tick, FRESH_ROWS,
                ROWS + (tick * FRESH_SENDERS + sender) * FRESH_ROWS,
                f"t{tick}", args.seed)
            batch.append(raw)
            tick_hot |= h
        ticks.append((batch, tick_hot))
    return {"fill": fill, "fill_hot": hot, "ticks": ticks}


# -- the main path ------------------------------------------------------------

class Stopwatch:
    """Host-clock spans around the path's public entry points (each span's
    work ends in a device synchronisation of its own: a ``.cpu()``
    read-back)."""

    def __init__(self) -> None:
        self.ms: dict[str, float] = {}
        self.started: dict[str, float] = {}
        self.sizes: dict[str, int] = {}

    def wrap(self, obj, attr: str, name: str) -> None:
        fn = getattr(obj, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            self.started[name] = t0
            if a and hasattr(a[0], "__len__"):
                self.sizes[name] = len(a[0])
            try:
                return fn(*a, **kw)
            finally:
                self.ms[name] = self.ms.get(name, 0.0) + (
                    time.perf_counter() - t0) * 1e3
                self.started[name + "_end"] = time.perf_counter()

        setattr(obj, attr, timed)

    def reset(self) -> None:
        self.ms.clear()
        self.started.clear()
        self.sizes.clear()


def build_fleet(args, device, backend: str, watch: Stopwatch | None):
    schema = JAX_FEATURES
    analyzer = BigRootsAnalyzer(schema, backend=backend, device=device)
    agg = FleetAggregator(schema, analyzer, attribution=True,
                          max_rows=ROWS, device=device)
    cfg = ForecastConfig(features=len(schema))
    forecaster = Forecaster(
        forecast_init(cfg, seed=args.seed), cfg, schema,
        risk_threshold=0.45, hold_steps=2, min_history=2, device=device)
    diag = Diagnosis.fleet(agg, forecaster=forecaster)
    if watch is not None:
        analyzer.staging.record_events = True
        watch.wrap(analyzer, "analyze_fleet", "sweep")
        watch.wrap(agg.stream.attributor, "attribute", "whatif")
        watch.wrap(forecaster, "step", "forecast")
    return analyzer, agg, forecaster, diag


def drive(args, stream, device, backend: str, timed: bool):
    """Ingest the fill payloads, then drive the ticks.  Returns the per-tick
    cause wire dicts (and the per-tick timings when ``timed``)."""
    watch = Stopwatch() if timed else None
    analyzer, agg, forecaster, diag = build_fleet(args, device, backend, watch)
    t0 = time.perf_counter()
    rows = sum(agg.ingest(raw) for raw in stream["fill"])
    ingest_s = time.perf_counter() - t0
    check(rows == STAGES * ROWS, f"fill ingested {rows} rows")
    check(len(agg.store) == STAGES, f"{len(agg.store)} stage windows")
    clock = iter(np.arange(0.0, 1e6, 10.0).tolist())
    telem = StepTelemetry("h0", wire=True, window=1, boot=1,
                          clock=lambda: next(clock))
    causes, timings = [], []
    for tick, (batch, _hot) in enumerate(stream["ticks"]):
        if watch is not None:
            watch.reset()
        t_in = time.perf_counter()
        for raw in batch:
            agg.ingest(raw)
        with telem.step(tick % STAGES) as scope:
            scope.add("read_bytes", 64e6)
        t_tick = time.perf_counter()
        fresh = diag.tick(telem, step_time=10.0)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        causes.append([cause_to_wire(c) for c in fresh])
        if watch is not None:
            st = watch.started
            staging = analyzer.staging
            h2d, kern, d2h = staging.last_ms
            gates_t0, gates_t1 = staging.last_span
            timings.append({
                "tick": tick,
                "windows_swept": watch.sizes["sweep"],
                "batch_shape": list(staging.last_inputs()[0].shape),
                "fresh_ingest_ms": (t_tick - t_in) * 1e3,
                "prelude_pack_ms": (gates_t0 - st["sweep"]) * 1e3,
                "h2d_ms": h2d, "gate_kernel_ms": kern, "d2h_ms": d2h,
                "gates_host_ms": (gates_t1 - gates_t0) * 1e3,
                "finish_ms": (st["sweep_end"] - gates_t1) * 1e3,
                "whatif_ms": watch.ms.get("whatif", 0.0),
                "forecast_ms": watch.ms["forecast"],
                "tick_total_ms": (t_end - t_tick) * 1e3,
                "causes": len(fresh),
            })
    return causes, timings, ingest_s, analyzer, agg


def compare_runs(got, want, stream) -> dict:
    """Tick by tick: confirmed causes and attributions exactly equal, forecast
    risks within ``RISK_TOL``; every injected hot task confirmed."""
    confirmed = attributed = predicted = 0
    found_cpu = set()
    for tick, (g_tick, w_tick) in enumerate(zip(got, want)):
        check(len(g_tick) == len(w_tick),
              f"tick {tick}: {len(g_tick)} causes vs oracle {len(w_tick)}")
        for g, w in zip(g_tick, w_tick):
            if w["feature"] == PREDICTED_STRAGGLER:
                predicted += 1
                g, w = dict(g), dict(w)
                gv, wv = g.pop("value"), w.pop("value")
                check(abs(gv - wv) <= RISK_TOL + RISK_TOL * abs(wv),
                      f"tick {tick}: forecast risk {gv} vs oracle {wv}")
                g.pop("guidance"), w.pop("guidance")  # quotes the risk
            else:
                confirmed += 1
                attributed += w["attribution"] is not None
                if w["feature"] == "cpu":
                    found_cpu.add(w["task_id"])
            check(g == w, f"tick {tick}: {g} != {w}")
        for g in g_tick:
            check(np.isfinite(g["value"]), f"tick {tick}: non-finite {g}")
    injected = set(stream["fill_hot"])
    for _batch, hot in stream["ticks"]:
        injected |= hot
    # A hot row is only a finding when its duration also clears the
    # straggler threshold, which the draw leaves to ~7 in 8 of them.
    recall = len(injected & found_cpu) / len(injected)
    check(recall >= 0.7,
          f"only {recall:.2f} of the injected hot set confirmed")
    check(confirmed > 0 and attributed > 0 and predicted > 0,
          f"confirmed={confirmed} attributed={attributed} "
          f"predicted={predicted}")
    return {"confirmed": confirmed, "attributed": attributed,
            "predicted": predicted, "injected_hot": len(injected),
            "hot_confirmed": len(injected & found_cpu),
            "cpu_causes_outside_hot_set": len(found_cpu - injected)}


# -- the kernel against its plain version -------------------------------------

def synthetic_batch(rng, W, R, F, device):
    counts = rng.integers(R // 2, R + 1, size=W)
    rowmask = (np.arange(R)[None, :] < counts[:, None]).astype(np.float64)
    arrays = (
        rng.normal(1.0, 2.0, (W, R, F)), rng.normal(2.0, 4.0, (W, R, F)),
        rng.integers(0, 6, (W, R, 1)).astype(np.float64),
        rng.integers(0, 6, (W, R, 1)).astype(np.float64),
        rowmask[:, :, None], rng.normal(0.0, 8.0, (W, 1, F)),
        rng.normal(0.5, 1.0, (W, 1, F)), rng.choice([0.0, 1.0], (W, 1, F)),
        np.where(rng.random((1, 1, F)) < 0.3, 0.2, -np.inf),
    )
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def corner_batch(rng, device, F: int):
    """NaN values, zero counts, padded rows, an odd row count."""
    t = [x.cpu().numpy().copy() for x in synthetic_batch(rng, 3, 257, F, "cpu")]
    t[0][0, :40] = np.nan
    t[2][:, ::2] = 0.0
    t[3][:, 1::2] = 0.0
    t[1][0, ::2] = t[5][0]
    t[4][1] = 0.0
    t[4][2, 100:] = 0.0
    t[0][2, 100:] = 100.0
    return tuple(torch.from_numpy(a).to(device) for a in t)


def hold_against_plain(tensors, peer_mean: float) -> dict:
    got = bigroots_gates.gates_launch(*tensors, peer_mean=peer_mean)
    torch.cuda.synchronize()
    want = bigroots_gates.eval_gates_torch(*tensors, peer_mean=peer_mean)
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    mismatches = int((diff != 0).sum().item())
    check(torch.equal(got, want),
          f"{mismatches} gate bits differ at {list(got.shape)}")
    return {"shape": list(tensors[0].shape), "mismatches": mismatches,
            "max_abs_err": float(diff.max().item()),
            "fired": int((want != 0).sum().item())}


def time_ms(fn, flush, reps: int = 25) -> list[float]:
    """Device times of ``reps`` launches of ``fn`` (CUDA events), with the
    50 MB L2 cache displaced before each launch by *reading* a larger buffer
    (writing one would leave dirty lines whose write-back competes with the
    timed launch).  The warm-up keeps the card busy for a quarter of a second
    first: the main path leaves it idle most of the time, and an idle card
    clocks down."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.25:
        flush.sum()
        fn()
        torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        flush.sum()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def gate_bound(W: int, R: int, F: int) -> dict:
    read = W * R * (16 * F + 24) + 24 * W * F + 8 * F
    written = W * R * F
    bytes_ms = (read + written) / HBM_BYTES_PER_S * 1e3
    ops_ms = W * R * F * GATE_OPS_PER_ELEMENT / FP64_FLOPS * 1e3
    return {"bytes": read + written, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def measure(tensors, peer_mean: float, flush, rounds: int = 4) -> dict:
    """Kernel and plain version, timed in turns (``rounds`` times each,
    order reversed every other round): at a batch this small one block of
    launches can sit ~40 % off the next, so each number is the median over
    all rounds and the round medians are kept beside it."""
    W, R, F = tensors[0].shape
    out = torch.empty((W, R, F), dtype=torch.int8, device=tensors[0].device)
    fns = {
        "ms": lambda: bigroots_gates.gates_launch(
            *tensors, peer_mean=peer_mean, out=out),
        "plain_ms": lambda: bigroots_gates.eval_gates_torch(
            *tensors, peer_mean=peer_mean),
    }
    samples = {k: [] for k in fns}
    per_round = {k: [] for k in fns}
    for rnd in range(rounds):
        order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
        for k in order:
            got = time_ms(fns[k], flush)
            samples[k] += got
            per_round[k].append(statistics.median(got))
    return {"shape": [W, R, F],
            **{k: statistics.median(v) for k, v in samples.items()},
            "round_medians": per_round, **gate_bound(W, R, F)}


# -- phases -------------------------------------------------------------------

def phase_env() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    nvcc = subprocess.run([build.find_nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.splitlines()[-1], "gpu": card,
          "device_name": torch.cuda.get_device_name(0)})
    return card.splitlines()[0]


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = build.build(["bigroots_gates"], verbose=True)
    build.load("bigroots_gates")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(str(v), ROOT)
                        for k, v in paths.items()},
          "flags": " ".join(build.NVCC_FLAGS)})


def run(args) -> None:
    card = phase_env()
    device = torch.device("cuda")
    phase_build()
    peer_mean = BigRootsThresholds().peer_mean
    F = len(JAX_FEATURES)
    rng = np.random.default_rng(args.seed)
    flush = torch.zeros(32 << 20, dtype=torch.float32, device=device)  # 128 MB

    full = synthetic_batch(rng, 64, 16384, F, device)
    checks = [hold_against_plain(full, peer_mean),
              hold_against_plain(corner_batch(rng, device, F), peer_mean),
              hold_against_plain(corner_batch(rng, device, 9), peer_mean)]
    full_timing = measure(full, peer_mean, flush)
    del full
    emit({"phase": "kernels", "name": "bigroots_gates",
          "tolerance": "exact (int8 gate bits, torch.equal)",
          "checks": checks, "full_incident": full_timing})

    t0 = time.perf_counter()
    stream = make_stream(args)
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "stages": STAGES, "rows_per_stage": ROWS,
          "fill_payload_bytes": sum(map(len, stream["fill"])),
          "ticks": args.ticks,
          "fresh_rows_per_stage_per_tick": FRESH_SENDERS * FRESH_ROWS})

    bigroots_gates.LAUNCHES = 0
    got, timings, ingest_s, analyzer, agg = drive(
        args, stream, device, "torch", timed=True)
    launches = bigroots_gates.LAUNCHES
    check(launches == args.ticks,
          f"gate kernel launched {launches} times over {args.ticks} ticks")
    last = tuple(t.clone() for t in analyzer.staging.last_inputs())
    for t in timings:
        emit({"phase": "main_path_tick", **t})
    want, _, oracle_ingest_s, _, _ = drive(
        args, stream, torch.device("cpu"), "numpy", timed=False)
    check(bigroots_gates.LAUNCHES == launches,
          "the oracle run launched the kernel")
    summary = compare_runs(got, want, stream)
    emit({"phase": "main_path", "ok": True, "live_rows": agg.num_live_rows,
          "stage_windows": len(agg.store), "fill_ingest_s": ingest_s,
          "oracle_fill_ingest_s": oracle_ingest_s,
          "gate_launches": launches, **summary})

    at_path = hold_against_plain(last, peer_mean)
    path_timing = measure(last, peer_mean, flush)
    print(card, flush=True)
    emit({"kernels": [{
        "name": "bigroots_gates", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bigroots_gates.cu",
        "replaces": "src/repro/kernels/bigroots_gates.py:63",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks + [at_path]),
        "ms": path_timing["ms"], "plain_ms": path_timing["plain_ms"],
        "bound_ms": path_timing["bound_ms"],
        "bound_by": path_timing["bound_by"], "library_ms": None,
        "shape": path_timing["shape"], "bytes": path_timing["bytes"],
        "in_tick_ms": statistics.median(
            t["gate_kernel_ms"] for t in timings),
        "round_medians": path_timing["round_medians"],
        "full_incident": full_timing,
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=5,
                    help="driven ticks (the fleet's size is fixed)")
    run(ap.parse_args())


if __name__ == "__main__":
    main()
