"""The served paths of ``chip_smoke.py`` on the CPU: how each family is cut
to one card, which kernels a call must launch, and the helpers the GPU run
leans on to fit jamba-v0.1-52b (``cast_params(in_place=True)``, the master
drawn again, the control rounded block by block).  The paths
themselves run on the GPU only (``python3 chip_smoke.py``)."""
from __future__ import annotations

import importlib.util
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention
from repro_torch.models import Model, smoke_variant
from repro_torch.serve.engine import cast_params

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

def test_jamba_is_served_as_one_pattern_period():
    """8 of jamba's 32 layers: 1 attention, 7 SSM and 4 MoE layers, 13.3 B
    parameters; a prefill launches K2 once, K4 7 times and K5 12 times,
    a decode step K3 once and K5 12 times."""
    cfg = cs.served_config("jamba_v0_1_52b")
    assert (cfg.n_layers, cfg.n_blocks, cfg.d_model) == (8, 1, 4096)
    assert 13.2e9 < cfg.param_count() < 13.3e9
    prefill, step = cs.expected_launches(cfg)
    assert prefill == {"flash_attention": 1, "decode_attention": 0,
                       "ssd_scan": 7, "moe_gmm": 12}
    assert step == {"flash_attention": 0, "decode_attention": 1,
                    "ssd_scan": 0, "moe_gmm": 12}


@pytest.mark.parametrize("arch,layers,prefill,step", [
    ("olmoe_1b_7b", 16, {"flash_attention": 16, "moe_gmm": 48},
     {"decode_attention": 16, "moe_gmm": 48}),
    ("codeqwen1_5_7b", 32, {"flash_attention": 32}, {"decode_attention": 32}),
    ("granite_3_8b", 40, {"flash_attention": 40}, {"decode_attention": 40}),
    ("granite_8b", 36, {"flash_attention": 36}, {"decode_attention": 36}),
    ("internvl2_26b", 8, {"flash_attention": 8}, {"decode_attention": 8}),
])
def test_served_depth_and_launches(arch, layers, prefill, step):
    cfg = cs.served_config(arch)
    assert cfg.n_layers == layers
    assert cfg.d_model == get_config(arch).d_model
    want = cs.expected_model_launches(cfg)
    assert want["init_cache"] == dict.fromkeys(want["prefill"], 0)
    assert {k: v for k, v in want["prefill"].items() if v} == prefill
    assert {k: v for k, v in want["decode"].items() if v} == step


def test_vlm_cache_holds_the_patches():
    cfg = cs.served_config(cs.VLM_ARCH)
    assert cfg.frontend_tokens == 1024
    assert cs.serve_max_len(cfg) == 1024 + cs.PROMPT_LEN + cs.MAX_NEW + 8
    assert cs.serve_max_len(get_config("glm4_9b")) == cs.MAX_LEN


def test_the_master_is_drawn_again_bit_for_bit():
    """The serving phase casts the seeded float32 master to bf16 in place
    for the engine and draws it again for the float32 reference (the two
    together do not fit one card for jamba at 8 layers: 6 bytes a
    parameter, 79.6 GB): a seeded generator gives the same values."""
    assert 6 * cs.served_config(cs.HYBRID_ARCH).param_count() > 0.9 * 85e9
    cfg = smoke_variant(get_config(cs.HYBRID_ARCH))
    first, again = (Model(cfg).init(torch.Generator().manual_seed(3))
                    for _ in range(2))
    want = tree.leaves_with_path(first)
    got = tree.leaves_with_path(again)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(torch.equal(g, w) for (_, g), (_, w) in zip(got, want))


@pytest.mark.parametrize("arch,ask,layers", [
    ("jamba_v0_1_52b", 4, 8), ("jamba_v0_1_52b", 8, 8),
    ("glm4_9b", 2, 2), ("granite_moe_1b_a400m", 1, 1)])
def test_cut_params_keeps_whole_periods(arch, ask, layers):
    """A depth cut takes whole periods of the stacked pattern: jamba's
    float32 variant runs at 8 layers whatever fewer it asks for."""
    cfg = replace(smoke_variant(get_config(arch)),
                  n_layers=2 * len(get_config(arch).pattern()))
    params = Model(cfg).init(device="cpu")
    cut, ccfg = cs.cut_params(params, cfg, ask)
    assert ccfg.n_layers == layers
    for slot in cut["blocks"].values():
        for t in slot.values():
            assert t.shape[0] == ccfg.n_blocks
    # the cut model runs
    toks = torch.zeros((1, 8), dtype=torch.int32)
    logits, _ = Model(replace(ccfg, attention_impl="dense",
                              moe_impl="ragged", ssm_impl="chunked")
                      ).forward(cut, {"tokens": toks})
    assert logits.shape == (1, 8, cfg.vocab_padded)


def test_control_is_rounded_block_by_block():
    """``coarse_params`` rounds each block of a stacked leaf on its own:
    the same bits as rounding the whole leaf at once."""
    cfg = replace(smoke_variant(get_config("olmoe_1b_7b")), n_layers=3)
    params = Model(cfg).init(device="cpu")
    got = cs.coarse_params(params, 5)["blocks"]["L0_moe"]["w_gate"]
    w = params["blocks"]["L0_moe"]["w_gate"]
    m, e = torch.frexp(w)
    assert torch.equal(got, torch.ldexp(torch.round(m * 32) / 32, e))
    assert not torch.equal(got, w)
    assert cs.coarse_params(params, 5)["blocks"]["L0_moe"]["router"] \
        is params["blocks"]["L0_moe"]["router"]


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "seamless_m4t_medium"])
def test_the_in_place_control_is_the_copy(arch):
    """``coarsen_in_place`` (the sharded jamba cases' control, rounded into
    a participant's block in chunks) writes ``coarse_params``' bits into
    the tree it is given, the weights it does not round untouched."""
    cfg = replace(smoke_variant(get_config(arch)), dtype="bfloat16")
    params = cast_params(Model(cfg).init(device="cpu"), cfg,
                         torch.device("cpu"))
    want = cs.coarse_params(params, cs.CONTROL_BITS)
    before = [t.clone() for t in tree.leaves(params)]
    cs.coarsen_in_place(params, cs.CONTROL_BITS)
    moved = 0
    for g, w, b in zip(tree.leaves(params), tree.leaves(want), before,
                       strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)
        moved += not torch.equal(g, b)
    assert moved


def test_cast_params_in_place_gives_the_copy():
    cfg = replace(smoke_variant(get_config("jamba_v0_1_52b")),
                  dtype="bfloat16")
    params = Model(cfg).init(device="cpu")
    want = cast_params(params, cfg, torch.device("cpu"))
    got = cast_params(params, cfg, torch.device("cpu"), in_place=True)
    assert got is params
    for k, slot in want["blocks"].items():
        for n, t in slot.items():
            assert got["blocks"][k][n].dtype == t.dtype
            assert torch.equal(got["blocks"][k][n], t)
    assert got["blocks"]["L0_ssm"]["A_log"].dtype == torch.float32
    assert got["embed"].dtype == torch.bfloat16


def test_internvl2_decode_is_one_partial_head_group():
    """n_rep 6: each kv head's 6 query heads are one partial group of the
    kernel's 16, 8 x 8 groups over 132 SMs: two splits of 1056 positions
    of the 2088-position cache, edges at 1055 / 1056."""
    assert decode_attention.split_plan(8, 8, 6, 2088, 132) == (2, 1056)
    assert -(-6 // decode_attention.HEAD_GROUP) == 1


def test_routing_replay_counts_flips_and_moved_slots():
    """A replayed top-3 that swaps one expert: the recorded experts are
    routed to; the sorted lists differ in 3 positions (the flips the
    float32 limit holds) while 1 slot's expert moved (what the bf16 limit
    holds)."""
    routing = cs.Routing()
    routing.recorded.append(torch.tensor([[0, 2, 3], [3, 1, 2]]))
    with routing.replay() as tally:
        got = cs.moe_layer._routing_hook(
            None, torch.tensor([[2, 3, 5], [1, 2, 3]]))
    assert torch.equal(got, routing.recorded[0])
    assert tally == {"routings": 6, "flips": 3, "moved": 1}
    assert cs.flip_share(tally) == 1 / 6
    assert cs.flip_share(tally, "float32") == 0.5


def test_routing_check_needs_its_control_past_the_limit():
    """The bf16 routing check holds each sound run's moved share to the
    limit and the control's past it; a run that routes nothing (a dense
    model's tally) holds none."""
    limit = cs.ROUTING_FLIP_SHARE["bfloat16"]

    def tally(share):
        return {"routings": 10_000, "flips": 0, "moved": round(share * 1e4)}
    sound, control = tally(limit * 0.8), tally(limit * 1.25)
    assert cs.routing_ok([sound, sound], control)
    assert not cs.routing_ok([sound, tally(limit * 1.1)], control)
    assert not cs.routing_ok([sound], tally(limit))      # inside: can't tell
    none = {"routings": 0, "flips": 0, "moved": 0}
    assert cs.routing_ok([none], none)
    assert "olmoe_1b_7b" in cs.SERVE_PATHS
