"""The port stands alone: it imports ``torch`` and ``numpy``, never
``jax`` and nothing of the ``repro`` package, and it does not run on the
CPU unasked."""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

ONE_TICK = r"""
import sys
import repro_torch
from repro_torch.core import BigRootsAnalyzer, Forecaster, JAX_FEATURES
from repro_torch.models import ForecastConfig, forecast_init
from repro_torch.serve import Diagnosis, FleetAggregator
from repro_torch.telemetry import StepTelemetry
import repro_torch.convert, repro_torch.kernels, repro_torch.kernels.build

schema = JAX_FEATURES
agg = FleetAggregator(schema, BigRootsAnalyzer(schema, device="cpu"),
                      attribution=True)
cfg = ForecastConfig(features=len(schema))
diag = Diagnosis.fleet(agg, forecaster=Forecaster(
    forecast_init(cfg, 0), cfg, schema, device="cpu"))
telems = [StepTelemetry(f"h{i}", wire=True, boot=1) for i in range(6)]
for i, t in enumerate(telems):
    with t.step(0) as s:
        s.add("read_bytes", 10.0 if i else 1000.0)
for t in telems[1:]:
    agg.ingest(t.drain_delta().to_bytes())
fresh = diag.tick(telems[0], step_time=1.0)
assert agg.rows_ingested == 6, agg.rows_ingested
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("BAD=" + ",".join(bad))
"""


def test_one_tick_imports_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", ONE_TICK], env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout + "\n", out.stdout


SERVE = r"""
import sys
from dataclasses import replace
import numpy as np
from repro_torch.configs import get_config
from repro_torch.models import Model, smoke_variant
from repro_torch.serve import Request, ServeEngine

import repro_torch.kernels.ops, repro_torch.models.moe, repro_torch.models.ssd

for arch in ("glm4_9b", "granite_moe_1b_a400m", "mamba2_130m"):
    # the kernel paths (their plain versions on CPU tensors)
    cfg = replace(smoke_variant(get_config(arch)), attention_impl="cuda",
                  moe_impl="gmm", ssm_impl="cuda")
    model = Model(cfg)
    engine = ServeEngine(model, model.init(device="cpu"), max_len=24,
                         batch_size=2, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8))
    done = engine.run([Request(f"r{i}", p.astype(np.int32), max_new_tokens=2)
                       for i, p in enumerate(prompts)])
    assert [len(r.output) for r in done] == [2, 2]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("BAD=" + ",".join(bad))
"""


def test_serving_imports_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", SERVE], env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout + "\n", out.stdout


DIAGNOSIS = r"""
import sys
import repro_torch.ft, repro_torch.anomaly
from repro_torch.anomaly import ab_compare, export_episodes, run_scenario
from repro_torch.core import (PCCAnalyzer, evaluate_forecaster, roc_sweep,
                              train_forecaster)
from repro_torch.core.reference import reference_root_causes

res = run_scenario("hot_host_cpu", device="cpu")
assert res.causes
assert ab_compare("cpu", stages=4, device="cpu").baseline.engine.dry_run
es = export_episodes("hot_host_cpu", device="cpu")
evaluate_forecaster(train_forecaster(es, steps=2, device="cpu"), es)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("BAD=" + ",".join(bad))
"""


def test_diagnosis_stack_imports_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", DIAGNOSIS], env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout + "\n", out.stdout


TRAIN = r"""
import sys, tempfile
import repro_torch.ckpt, repro_torch.data, repro_torch.parallel, repro_torch.train
from repro_torch.ft import Supervisor
from repro_torch.launch import train

with tempfile.TemporaryDirectory() as d:
    out = train.run(train.build_argparser().parse_args([
        "--arch", "granite_moe_1b_a400m", "--smoke", "--device", "cpu",
        "--steps", "3", "--batch", "2", "--seq", "8", "--accum", "2",
        "--compress-grads", "--ckpt-dir", d, "--ckpt-every", "1"]))
    assert out["steps"] == 3
    assert repro_torch.ckpt.CheckpointManager(d).latest_step() == 2
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("BAD=" + ",".join(bad))
"""


def test_training_imports_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", TRAIN], env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout + "\n", out.stdout


SLICE6 = r"""
import sys
from dataclasses import replace
import torch
import repro_torch.launch.mesh, repro_torch.models.encdec
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model, smoke_variant
from repro_torch.parallel import compressed_allreduce_mean, ep_moe, pipeline
from repro_torch.parallel.sharding import param_shardings
from repro_torch.train import AdamWConfig, abstract_state, state_shardings

cfg = replace(smoke_variant(get_config("seamless_m4t_medium")),
              attention_impl="cuda")
model = Model(cfg)
params = model.init(device="cpu")
batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
         "enc_embeds": torch.zeros((2, 4, cfg.d_model))}
cache = model.init_cache(params, batch, 12)
_, cache = model.prefill(params, batch, cache)
model.decode(params, batch["tokens"][:, :1], cache)
ep_moe.set_mesh(make_mesh((1, 2), ("data", "model")))
moe = replace(smoke_variant(get_config("granite_moe_1b_a400m")),
              moe_impl="ep")
Model(moe).forward(Model(moe).init(device="cpu"), batch)
compressed_allreduce_mean([torch.ones(3), torch.zeros(3)])
pipeline.pipeline_apply(lambda w, x: x * w, torch.ones(2), torch.ones(2, 3),
                        make_mesh((2,), ("pipe",)))
state_shardings(abstract_state(model, AdamWConfig()), get_config(
    "seamless_m4t_medium"), make_mesh((16, 16), ("data", "model")), True)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("BAD=" + ",".join(bad))
"""


def test_encdec_and_parallel_import_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", SLICE6], env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout + "\n", out.stdout


SLICE9 = r"""
import os, sys, tempfile
from dataclasses import replace
import torch
import torch.distributed as dist
import repro_torch.parallel.dist
from repro_torch.configs import get_config
from repro_torch.launch.mesh import init_ranks, make_mesh
from repro_torch.models import Model, smoke_variant
from repro_torch.parallel import compressed_allreduce_mean, ep_moe, pipeline
from repro_torch.parallel.collectives import shards

with tempfile.TemporaryDirectory() as d:
    dm = init_ranks(make_mesh((1, 1), ("data", "model")), 0,
                    os.path.join(d, "store"))
    assert type(shards(dm)).__name__ == "RankShards"
    ep_moe.set_mesh(dm)
    moe = replace(smoke_variant(get_config("granite_moe_1b_a400m")),
                  moe_impl="ep")
    Model(moe).forward(Model(moe).init(device="cpu"),
                       {"tokens": torch.zeros((2, 8), dtype=torch.int32)})
    compressed_allreduce_mean(torch.ones(3), dist.group.WORLD)
    pipeline.pipeline_apply(lambda w, x: x * w, torch.ones(1),
                            torch.ones(2, 3),
                            make_mesh((1,), ("pipe",)).device_mesh())
    dist.destroy_process_group()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("BAD=" + ",".join(bad))
"""


def test_rank_form_of_parallel_imports_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", SLICE9], env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout + "\n", out.stdout


SLICE10 = r"""
import os, sys, tempfile
import torch
import torch.distributed as dist
import repro_torch.parallel.tensor
from repro_torch.configs import get_config
from repro_torch.launch.mesh import init_ranks, make_mesh
from repro_torch.models import Model, smoke_variant
from repro_torch.parallel.sharding import gather_tree, shard_tree
from repro_torch.train import (AdamWConfig, abstract_state, init_state,
                               make_train_step, state_shardings)

cfg = smoke_variant(get_config("jamba_v0_1_52b"))
model = Model(cfg)
opt = AdamWConfig()
state = init_state(model, None, opt, device="cpu")
with tempfile.TemporaryDirectory() as d:
    dm = init_ranks(make_mesh((1, 1), ("data", "model")), 0,
                    os.path.join(d, "store"))
    sh = state_shardings(abstract_state(model, opt), cfg,
                         make_mesh((1, 1), ("data", "model")), zero_opt=True)
    local = shard_tree(state, sh, {"data": 0, "model": 0})
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    local, metrics = make_train_step(model, opt, shards=dm, shardings=sh)(
        local, {"tokens": tokens, "labels": tokens})
    gather_tree(local, sh, repro_torch.parallel.tensor.Participant(dm).shards,
                state)
    dist.destroy_process_group()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("BAD=" + ",".join(bad))
"""


def test_sharded_train_step_imports_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", SLICE10], env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout + "\n", out.stdout


SLICE7 = r"""
import sys, tempfile
import repro_torch.launch.dryrun, repro_torch.launch.report
import repro_torch.launch.roofline, repro_torch.launch.specs
import repro_torch.kernels.ref
import repro_torch.examples
from repro_torch.examples import (anomaly_study, fault_tolerance_demo,
                                  fleet_demo, quickstart, serve_demo,
                                  train_100m_bigroots)
from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun

with tempfile.TemporaryDirectory() as d:
    r = dryrun.run_cell("mamba2_130m", SHAPES["decode_32k"], "single",
                        results_dir=d)
    assert r["status"] == "ok", r
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("BAD=" + ",".join(bad))
"""


def test_dry_run_ref_and_examples_import_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", SLICE7], env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout + "\n", out.stdout


NO_CUDA = r"""
import torch
from repro_torch.core import (BigRootsAnalyzer, Forecaster, JAX_FEATURES,
                              WhatIfReplayer)
from repro_torch.models import ForecastConfig, forecast_init
from repro_torch.serve import FleetAggregator
assert not torch.cuda.is_available()
cfg = ForecastConfig(features=len(JAX_FEATURES))
params = forecast_init(cfg, 0)
for make in (lambda: BigRootsAnalyzer(JAX_FEATURES),
             lambda: WhatIfReplayer(JAX_FEATURES),
             lambda: Forecaster(params, cfg, JAX_FEATURES),
             lambda: FleetAggregator(JAX_FEATURES)):
    try:
        make()
    except RuntimeError as exc:
        assert "CUDA" in str(exc), exc
    else:
        raise SystemExit("ran on the CPU unasked")
# The numpy oracle is host only: it needs no GPU and no device argument.
Forecaster(params, cfg, JAX_FEATURES, backend="numpy")

from repro_torch.anomaly import ScenarioEngine, ab_compare, build_scenario
from repro_torch.anomaly.scenario import main as scenario_main
from repro_torch.core import train_forecaster
for make in (lambda: ScenarioEngine(build_scenario("hot_host_cpu")),
             lambda: ab_compare("cpu", stages=2),
             lambda: train_forecaster(None),
             lambda: scenario_main(["--check", "hot_host_cpu"])):
    try:
        make()
    except RuntimeError as exc:
        assert "CUDA" in str(exc), exc
    else:
        raise SystemExit("diagnosed on the CPU unasked")

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import Model, smoke_variant
from repro_torch.serve import ServeEngine
model = Model(smoke_variant(get_config("glm4_9b")))
host_params = model.init(device="cpu")
for make in (lambda: model.init(),
             lambda: ServeEngine(model, host_params),
             lambda: serve.main(["--smoke", "--requests", "1",
                                 "--prompt-len", "4", "--max-new", "1"])):
    try:
        make()
    except RuntimeError as exc:
        assert "CUDA" in str(exc), exc
    else:
        raise SystemExit("served on the CPU unasked")

from repro_torch.launch import train
from repro_torch.train import AdamWConfig, init_state
for make in (lambda: init_state(model, None, AdamWConfig()),
             lambda: train.main(["--smoke", "--steps", "1"])):
    try:
        make()
    except RuntimeError as exc:
        assert "CUDA" in str(exc), exc
    else:
        raise SystemExit("trained on the CPU unasked")

from repro_torch.examples import quickstart, serve_demo
for make in (lambda: quickstart.main([]), lambda: serve_demo.main([])):
    try:
        make()
    except RuntimeError as exc:
        assert "CUDA" in str(exc), exc
    else:
        raise SystemExit("an example ran on the CPU unasked")
print("RAISED")
"""


def test_default_device_raises_without_cuda():
    env = {**ENV, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", NO_CUDA], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    assert "RAISED" in out.stdout


FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)"
    r"|from\s+repro(\.|\s))", re.M)


def port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def test_source_scan_finds_no_jax_or_repro_import():
    files = port_sources()
    assert len(files) > 20
    for path in files:
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path}: {hits}"


@pytest.mark.parametrize("line,bad", [
    ("import jax", True), ("from jax import numpy", True),
    ("    import jax.numpy as jnp", True), ("import repro", True),
    ("from repro.core import x", True), ("from repro import core", True),
    ("import repro_torch", False), ("from repro_torch.core import x", False),
    ("import torch", False), ("# import jax is not done here", False),
])
def test_the_scan_pattern_itself(line, bad):
    assert bool(FORBIDDEN.search(line)) is bad
