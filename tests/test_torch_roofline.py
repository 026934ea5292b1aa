"""``repro_torch.launch.roofline`` and ``repro_torch.kernels.ref`` against
the JAX package.

- ``model_flops_for`` equals the reference's for all 32 cells (exact: the
  same integer arithmetic).
- ``Roofline.build(...).to_dict()`` equals the reference's with the
  reference module's three constants set, at run time, to the H100's
  (relative 1e-12).
- The collective counter mirrors ``tests/test_substrate.py::
  TestRooflineParser`` case for case (exact).
- The FLOP count of a 2-layer dense GQA smoke config equals an analytic
  count of every product, written out here, in the forward and in a train
  step (exact).
- The kernel work counted on ``meta`` equals the ``*_work`` formulas
  (exact).
- ``kernels/ref.py`` against the reference's ``ref.py`` loaded by file
  path, float32 inputs (2e-5 absolute and relative, the JAX package's
  float32 kernel tolerance).
"""
from __future__ import annotations

import importlib.util
import os
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.roofline as ref_roofline
from repro.configs import cells as ref_cells
from repro.configs import get_config as ref_config
from repro_torch import tree
from repro_torch.configs import cells, get_config
from repro_torch.kernels import (
    decode_attention,
    flash_attention,
    moe_gmm,
    ref,
    ssd_scan,
)
from repro_torch.launch import roofline
from repro_torch.launch.roofline import Roofline, StepCounter
from repro_torch.models import Model, smoke_variant
from repro_torch.parallel import collectives
from repro_torch.train import AdamWConfig, abstract_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_TOL = 2e-5


def _load_ref_kernels():
    spec = importlib.util.spec_from_file_location(
        "_ref_kernels_ref", os.path.join(REPO, "src", "repro", "kernels",
                                         "ref.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- model_flops_for and Roofline ----------------------------------------------

def test_model_flops_equal_the_reference_for_every_cell():
    got = [(a, s.name) for a, s in cells()]
    want = [(a, s.name) for a, s in ref_cells()]
    assert got == want and len(got) == 32
    for (arch, shape), (_, rshape) in zip(cells(), ref_cells()):
        assert roofline.model_flops_for(get_config(arch), shape) == \
            ref_roofline.model_flops_for(ref_config(arch), rshape), arch


def test_the_peaks_are_the_h100_data_sheet_s():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9
    assert roofline.PEAK_FLOPS_BY_DTYPE[torch.float32] == 67e12
    assert roofline.PEAK_FLOPS_BY_DTYPE[torch.float64] == 34e12


@pytest.mark.parametrize("args", [
    (1e15, 2e12, 4e11, 256, 1.2e17, None),
    (3e14, 9e12, 1e9, 512, 5e16, 2e13),
    (989e12, 3.35e12, 900e9, 256, 989e12 * 256 * 0.5, None),
    (0.0, 1e9, 0.0, 256, 0.0, 1e9),
])
def test_roofline_equals_the_reference_at_the_h100_peaks(args, monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(ref_roofline, name, getattr(roofline, name))
    flops, nbytes, coll, chips, model, upper = args
    got = Roofline.build(flops, nbytes, coll, chips, model,
                         bytes_upper=upper).to_dict()
    want = ref_roofline.Roofline.build(flops, nbytes, coll, chips, model,
                                       bytes_upper=upper).to_dict()
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k], k
        else:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_roofline_terms():
    r = Roofline.build(flops=roofline.PEAK_FLOPS, bytes_=roofline.HBM_BW,
                       coll_bytes=roofline.LINK_BW * 2, chips=256,
                       model_flops=roofline.PEAK_FLOPS * 256 * 0.5)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(2.0)
    assert r.dominant == "collective"
    assert r.useful_ratio == pytest.approx(0.5)


def test_an_uncounted_collective_term_is_left_out():
    r = Roofline.build(flops=roofline.PEAK_FLOPS, bytes_=2 * roofline.HBM_BW,
                       coll_bytes=None, chips=256, model_flops=0.0)
    d = r.to_dict()
    assert d["collective_s"] is None and d["collective_bytes_per_device"] is None
    assert r.dominant == "memory" and r.bound_s == pytest.approx(2.0)
    assert r.roofline_fraction == pytest.approx(0.5)


# -- the collective counter (TestRooflineParser's cases) -----------------------

def test_collective_counter_symbol_table():
    shards = [torch.empty((128, 256), device="meta") for _ in range(16)]
    with StepCounter() as c:
        gathered = collectives.all_gather(shards).reshape(2048, 256)
        collectives.psum([gathered] * 16)
    stats = c.collectives
    assert stats.count_by_kind == {"all-gather": 1, "all-reduce": 1}
    assert stats.bytes_by_kind["all-gather"] == 128 * 256 * 4
    assert stats.bytes_by_kind["all-reduce"] == 2048 * 256 * 4


def test_collective_counter_all_to_all_and_permute():
    sends = [torch.empty((4, 8, 16), dtype=torch.bfloat16, device="meta")
             for _ in range(4)]
    with StepCounter() as c:
        collectives.all_to_all(sends)
        collectives.ppermute_next([torch.empty((8, 16), device="meta")] * 4)
        collectives.pmean([torch.empty((3,), device="meta")] * 4)
    assert c.collectives.count_by_kind == {
        "all-to-all": 1, "collective-permute": 1, "all-reduce": 1}
    assert c.collectives.bytes_by_kind == {
        "all-to-all": 4 * 8 * 16 * 2, "collective-permute": 8 * 16 * 4,
        "all-reduce": 12}
    assert c.collectives.total_count == 3
    # Outside a counter nothing is recorded, and strings still pass.
    assert collectives.all_to_all([["a", "b"], ["c", "d"]])[1] == ["b", "d"]


# -- the FLOP count, analytically -----------------------------------------------

def _dense_gqa(remat: bool):
    cfg = replace(smoke_variant(get_config("glm4_9b")), remat=remat)
    assert cfg.n_layers == 2 and cfg.n_heads != cfg.n_kv_heads
    return cfg


def _analytic_forward(cfg, B: int, S: int) -> tuple[int, int]:
    """(block products, head product) of one forward: per layer the q, k,
    v and o projections, the two attention products over all S × S pairs
    (the dense form masks, it does not skip), the three MLP products; then
    the head."""
    T, d, H, KV, hd = B * S, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    per_layer = (2 * T * d * H * hd + 2 * 2 * T * d * KV * hd
                 + 2 * 2 * B * H * S * S * hd + 2 * T * H * hd * d
                 + 3 * 2 * T * d * cfg.d_ff)
    return cfg.n_layers * per_layer, 2 * T * d * cfg.vocab_padded


def _batch(cfg, B, S):
    return {"tokens": torch.zeros((B, S), dtype=torch.int32, device="meta"),
            "labels": torch.zeros((B, S), dtype=torch.int32, device="meta")}


def test_forward_flops_are_every_product():
    cfg = _dense_gqa(remat=False)
    B, S = 2, 32
    blocks, head = _analytic_forward(cfg, B, S)
    params = Model(cfg).abstract_params()
    with torch.no_grad(), StepCounter() as c:
        Model(cfg).forward(params, _batch(cfg, B, S))
    assert c.flops == blocks + head
    assert c.kernels == {}


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_flops_are_every_product_and_its_gradients(remat):
    """Each product's backward is two products of its size; ``remat``
    recomputes every block's forward once more, up to the last tensor its
    backward saved (``torch.utils.checkpoint`` stops there): all but the
    MLP's down projection, whose output no backward reads."""
    cfg = _dense_gqa(remat)
    B, S = 2, 32
    blocks, head = _analytic_forward(cfg, B, S)
    down = cfg.n_layers * 2 * B * S * cfg.d_ff * cfg.d_model
    model = Model(cfg)
    state = abstract_state(model, AdamWConfig())
    step = make_train_step(model, AdamWConfig())
    with StepCounter() as c:
        new_state, _ = step(state, _batch(cfg, B, S))
    assert c.flops == 3 * (blocks + head) + (blocks - down if remat else 0)
    assert [t.shape for t in tree.leaves(new_state["params"])] == \
        [t.shape for t in tree.leaves(state["params"])]
    assert c.bytes > 0 and c.bytes_upper >= c.bytes


# -- the kernels' work on meta ---------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("causal,Sq,Sk", [(True, 1024, 1024),
                                          (False, 1024, 256),
                                          (True, 300, 17)])
def test_flash_work_on_meta(causal, Sq, Sk):
    B, H, KV, D = 8, 16, 8, 64
    with StepCounter() as c:
        out = flash_attention.flash_attention(
            _meta(B, Sq, H, D), _meta(B, Sk, KV, D), _meta(B, Sk, KV, D),
            causal=causal)
    assert out.device.type == "meta" and out.shape == (B, Sq, H, D)
    want = roofline.flash_work(B, Sq, Sk, H, KV, D, torch.bfloat16, causal)
    assert c.kernels == {"flash_attention": {
        "launches": 1, "flops": want["flops"], "bytes": want["bytes"]}}
    assert c.flops == want["flops"]
    assert flash_attention.LAUNCHES == 0


def test_causal_pairs_count_each_query_s_keys():
    for Sq, Sk in ((1, 1), (5, 3), (3, 5), (1024, 1024), (17, 129)):
        assert roofline.causal_pairs(Sq, Sk) == sum(
            min(i + 1, Sk) for i in range(Sq))


def test_decode_work_on_meta_counts_the_whole_cache():
    B, S, H, KV, D = 8, 1064, 32, 2, 128
    n = torch.empty((), dtype=torch.int32, device="meta")
    with StepCounter() as c:
        out = decode_attention.decode_attention(
            _meta(B, H, D), _meta(B, S, KV, D), _meta(B, S, KV, D), n)
    assert out.shape == (B, H, D) and out.device.type == "meta"
    want = roofline.decode_work(B, H, KV, D, S, torch.bfloat16)
    assert c.kernels["decode_attention"] == {
        "launches": 1, "flops": want["flops"], "bytes": want["bytes"]}


def test_ssd_work_on_meta():
    B, S, H, G, N, P, Q = 2, 512, 24, 1, 128, 64, 256
    x = _meta(B, S, H, P)
    dt = _meta(B, S, H, dtype=torch.float32)
    A = _meta(H, dtype=torch.float32)
    with StepCounter() as c:
        y, states, seg = ssd_scan.ssd_intra_chunk(
            x, dt, A, _meta(B, S, G, N), _meta(B, S, G, N), Q)
    assert (y.shape, states.shape, seg.shape) == (
        (B, S, H, P), (B, H, S // Q, N, P), (B, H, S // Q, Q))
    want = roofline.ssd_work(B, S, H, G, N, Q, torch.bfloat16, P)
    assert c.kernels["ssd_scan"] == {
        "launches": 1, "flops": want["flops"], "bytes": want["bytes"]}


@pytest.mark.parametrize("rows", [64, 65536])
def test_gmm_work_on_meta(rows):
    E, K, N = 32, 1024, 512
    sizes = torch.empty((E,), dtype=torch.int64, device="meta")
    with StepCounter() as c:
        out = moe_gmm.grouped_matmul(_meta(rows, K), _meta(E, K, N), sizes)
    assert out.shape == (rows, N)
    want = roofline.gmm_work(rows, K, N, min(E, rows), torch.bfloat16)
    assert c.kernels["moe_gmm"] == {
        "launches": 1, "flops": want["flops"], "bytes": want["bytes"]}


def test_kernel_work_in_a_meta_train_step_counts_forward_and_recompute():
    """The kernel paths on meta: each forward kernel once per layer in the
    forward and once more in the recompute; the plain versions' autograd
    (their backward) is counted by the aten counters."""
    cfg = replace(get_config("granite_moe_1b_a400m"), n_layers=2)
    model = Model(cfg)
    state = abstract_state(model, AdamWConfig())
    B, S = 2, 256
    with StepCounter() as c:
        make_train_step(model, AdamWConfig())(state, _batch(cfg, B, S))
    assert c.kernels["flash_attention"]["launches"] == 2 * cfg.n_layers
    assert c.kernels["moe_gmm"]["launches"] == 2 * 3 * cfg.n_layers
    one = roofline.flash_work(B, S, S, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, torch.bfloat16, True)
    assert c.kernels["flash_attention"]["flops"] == 4 * one["flops"]


def test_the_work_formulas_give_the_bound():
    w = roofline.flash_work(8, 1024, 1024, 32, 2, 128, torch.bfloat16, True)
    b = roofline.work_bound(w)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(w["flops"] / 989e12 * 1e3)
    g = roofline.gate_work(64, 3072, 14, 1000, 10, 5)
    assert roofline.work_bound(g)["bound_by"] == "bytes"
    assert g["bytes"] == (8 * 64 * 3072 + 8 * 14 * 1000 + 32 * 10 + 64 * 5
                          + 24 * 64 * 14 + 8 * 14 + 64 * 3072 * 14)


# -- kernels/ref.py ---------------------------------------------------------------

def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32),
                               np.asarray(want, np.float32),
                               rtol=REF_TOL, atol=REF_TOL)


@pytest.mark.parametrize("causal,n_rep", [(True, 1), (True, 4), (False, 2)])
def test_flash_attention_ref_matches_the_reference(causal, n_rep):
    rk = _load_ref_kernels()
    rng = np.random.default_rng(0)
    q = rng.standard_normal((8, 40, 16), np.float32)
    k = rng.standard_normal((8 // n_rep, 40, 16), np.float32)
    v = rng.standard_normal((8 // n_rep, 40, 16), np.float32)
    _close(ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, n_rep=n_rep),
           rk.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, n_rep=n_rep))


@pytest.mark.parametrize("cache_len", [0, 17, 63])
def test_decode_attention_ref_matches_the_reference(cache_len):
    rk = _load_ref_kernels()
    rng = np.random.default_rng(1)
    q = rng.standard_normal((8, 16), np.float32)
    k = rng.standard_normal((4, 64, 16), np.float32)
    v = rng.standard_normal((4, 64, 16), np.float32)
    _close(ref.decode_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                    cache_len, n_rep=2),
           rk.decode_attention_ref(*map(jnp.asarray, (q, k, v)),
                                   cache_len, n_rep=2))


def test_ssd_intra_chunk_ref_matches_the_reference():
    rk = _load_ref_kernels()
    rng = np.random.default_rng(2)
    B, H, Nc, Q, P, N = 2, 3, 2, 8, 4, 5
    x = rng.standard_normal((B, H, Nc, Q, P), np.float32)
    dt = rng.uniform(0.01, 0.2, (B, H, Nc, Q)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm = rng.standard_normal((B, H, Nc, Q, N), np.float32)
    Cm = rng.standard_normal((B, H, Nc, Q, N), np.float32)
    got = ref.ssd_intra_chunk_ref(*map(torch.from_numpy, (x, dt, A, Bm, Cm)))
    want = rk.ssd_intra_chunk_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm)))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


def test_grouped_matmul_ref_matches_the_reference():
    rk = _load_ref_kernels()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 16), np.float32)
    w = rng.standard_normal((4, 16, 8), np.float32)
    _close(ref.grouped_matmul_ref(torch.from_numpy(x), torch.from_numpy(w)),
           rk.grouped_matmul_ref(jnp.asarray(x), jnp.asarray(w)))
