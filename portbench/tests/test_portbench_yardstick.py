"""The frozen arithmetic, pinned to numbers worked out when the benchmark
was defined (the parameter counts and layer pattern are the configuration's
reference's, which the model FLOPs read)."""
from __future__ import annotations

import json

import pytest

from portbench.harness.common import BENCH, reference
from portbench.yardstick import work


def config(name: str) -> dict:
    with open(BENCH / "configs" / f"{name}.json") as f:
        return json.load(f)


def model(name: str) -> dict:
    return config(name)["model"]


@pytest.mark.parametrize("name,total,active", [
    ("granite_moe_1b_a400m", 1_334_628_352, 428_658_688),
    ("jamba_v0_1_52b_p1", 13_267_656_416, 3_402_653_408),
])
def test_param_counts(name, total, active):
    ref = reference(config(name))
    m = model(name)
    assert ref.param_count(m) == total
    assert work.active_params(ref, m) == active


def test_model_flops():
    ref = reference(config("granite_moe_1b_a400m"))
    n = work.active_params(ref, model("granite_moe_1b_a400m"))
    assert work.train_flops(n, 4096) == 6.0 * 428_658_688 * 4096
    assert work.serve_flops(n, 100) == 2.0 * 428_658_688 * 100


def test_flash_work():
    w = work.flash_work(8, 1024, 1024, 32, 8, 128, causal=True)
    assert w["flops"] == 4 * 8 * 32 * 128 * (1024 * 1025 // 2)
    assert w["bytes"] == 2 * 128 * (2 * 8 * 1024 * 32 + 2 * 8 * 1024 * 8)
    assert work.causal_pairs(3, 5) == 6
    assert work.causal_pairs(5, 3) == 12
    full = work.flash_work(1, 4, 6, 2, 1, 8, causal=False)
    assert full["flops"] == 4 * 2 * 8 * 24


def test_gmm_work_and_bound():
    w = work.gmm_work(65536, 1024, 512, 32)
    assert w["flops"] == 2 * 65536 * 1024 * 512
    assert w["bytes"] == 2 * (65536 * 1024 + 32 * 1024 * 512 + 65536 * 512)
    ffn = work.moe_ffn_work(65536, 1024, 512, 32)
    assert ffn["flops"] == 3 * w["flops"]
    assert work.bound_s(w) == pytest.approx(
        max(w["flops"] / 989e12, w["bytes"] / 3.35e12))
    assert (work.PEAK_FLOPS, work.HBM_BW) == (989e12, 3.35e12)


def test_pattern():
    ref = reference(config("granite_moe_1b_a400m"))
    assert ref.pattern(model("granite_moe_1b_a400m")) == [("attn", "moe")]
    jamba = reference(config("jamba_v0_1_52b_p1")).pattern(
        model("jamba_v0_1_52b_p1"))
    assert [m for m, _ in jamba] == ["ssm"] * 4 + ["attn"] + ["ssm"] * 3
    assert [f for _, f in jamba] == ["mlp", "moe"] * 4
