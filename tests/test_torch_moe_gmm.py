"""The MoE layer and the grouped-matmul kernel's plain version against the
JAX package: its Pallas ``grouped_matmul`` (interpret mode, loaded by file
path, as ``repro.kernels`` cannot be imported on every jax build), its
``ref.grouped_matmul_ref`` oracle, and ``repro.models.moe``.

Inputs are made from a seed with numpy and handed to both packages.  The
kernel tolerances are the JAX package's own for this kernel (3e-2 bf16,
1e-4 float32); the MoE layer agrees to 1e-5 in float32 (sums in another
order) and its aux terms to 1e-6.  On the CPU the port's wrappers take the
kernel's plain version, so the CUDA kernel itself is held against that
version by ``chip_smoke.py`` on the GPU.
"""
from __future__ import annotations

import importlib.util
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models import smoke_variant as ref_smoke_variant

from repro_torch.configs import get_config
from repro_torch.kernels import moe_gmm, ops
from repro_torch.models import moe, smoke_variant

KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro" / "kernels"
KERNEL_TOL = {jnp.bfloat16: dict(rtol=3e-2, atol=3e-2),
              jnp.float32: dict(rtol=1e-4, atol=1e-4)}
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_kernel_{name}", KERNELS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


pallas_gmm = _load("moe_gmm").grouped_matmul
ref = _load("ref")


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# the kernel's plain version (K5)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("jdt,tdt", [(jnp.bfloat16, torch.bfloat16),
                                     (jnp.float32, torch.float32)])
def test_plain_matches_pallas_on_padded_groups(jdt, tdt):
    """The reference's ``[E, Cap, d]`` zero-padded layout is the ragged
    layout with ``E`` groups of ``Cap`` rows."""
    rng = np.random.default_rng(1)
    E, cap, d, f = 3, 16, 32, 48
    x = rng.standard_normal((E, cap, d)).astype(np.float32)
    x[1, 9:] = 0.0     # padding rows of a short group
    w = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    want = np.asarray(pallas_gmm(xj, wj, block_t=8, block_f=16, block_k=16,
                                 interpret=True), np.float32)
    oracle = np.asarray(ref.grouped_matmul_ref(xj, wj), np.float32)
    got = moe_gmm.grouped_matmul(
        _t(x, tdt).reshape(E * cap, d), _t(w, tdt),
        torch.full((E,), cap, dtype=torch.int64))
    assert got.dtype == tdt and moe_gmm.LAUNCHES == 0
    got = got.float().numpy().reshape(E, cap, f)
    np.testing.assert_allclose(got, want, **KERNEL_TOL[jdt])
    np.testing.assert_allclose(got, oracle, **KERNEL_TOL[jdt])


def test_plain_refuses_sizes_that_do_not_split_the_rows():
    xs, w = torch.zeros(10, 4), torch.zeros(2, 4, 3)
    with pytest.raises(ValueError):
        moe_gmm.grouped_matmul(xs, w, torch.tensor([4, 5]))
    with pytest.raises(ValueError):
        moe_gmm.grouped_matmul(xs, torch.zeros(3, 4, 3), torch.tensor([4, 6]))
    with pytest.raises(TypeError):
        moe_gmm.grouped_matmul(xs, w.double(), torch.tensor([4, 6]))
    with pytest.raises(TypeError):
        moe_gmm.grouped_matmul(xs, w, torch.tensor([4.0, 6.0]))


def test_the_kernels_expert_limit_is_the_wrappers():
    """``MAX_EXPERTS`` of ``csrc/moe_gmm.cu`` (one shared int per expert)
    is the wrapper's constant, checked before a launch."""
    src = (Path(moe_gmm.__file__).parent / "csrc" / "moe_gmm.cu").read_text()
    assert f"constexpr int MAX_EXPERTS = {moe_gmm.MAX_EXPERTS};" in src


def test_the_kernels_tile_heights_are_the_wrappers():
    """``TILE_ROWS_SMALL`` / ``TILE_ROWS_LARGE`` of ``csrc/moe_gmm.cu``
    (the bf16 kernel's template arguments) are the wrapper's
    ``TILE_ROWS``."""
    src = (Path(moe_gmm.__file__).parent / "csrc" / "moe_gmm.cu").read_text()
    small, large = moe_gmm.TILE_ROWS
    assert f"constexpr int TILE_ROWS_SMALL = {small};" in src
    assert f"constexpr int TILE_ROWS_LARGE = {large};" in src


@pytest.mark.parametrize("M,E,want", [
    (8 * 1024 * 8, 32, 128),     # granite-moe prefill: 65536 rows / 32
    (8 * 8, 32, 64),             # granite-moe decode: 64 rows / 32
    (64 * 32, 32, 128),          # a mean of exactly 64 rows
    (64 * 32 - 1, 32, 64),
    (25, 1, 64),
])
def test_tile_height_follows_rows_per_expert(M, E, want):
    assert moe_gmm.tile_rows(M, E) == want


def test_grid_bounds_the_tiles_of_any_routing():
    """``ceil(M / bm) + E`` row tiles cover every group's tiles for any
    split of M rows, and the bound is met by groups of one tile plus one
    row each."""
    rng = np.random.default_rng(7)
    for _ in range(200):
        E = int(rng.integers(1, 40))
        sizes = rng.multinomial(int(rng.integers(0, 5000)),
                                rng.dirichlet(np.full(E, 0.3)))
        M = int(sizes.sum())
        for bm in moe_gmm.TILE_ROWS:
            need = int(sum(-(-int(n) // bm) for n in sizes))
            assert need <= moe_gmm.row_tiles(M, E, bm)
    for bm in moe_gmm.TILE_ROWS:
        sizes = [bm + 1] * bm          # M = bm (bm + 1): ceil(M / bm) = bm + 1
        assert sum(-(-n // bm) for n in sizes) == 2 * bm
        assert moe_gmm.row_tiles(sum(sizes), bm, bm) == 2 * bm + 1


def test_gmm_kernel_refuses_what_tma_cannot_take():
    """The CUDA branch's checks, run on CPU tensors: bf16 xs or w off 16
    bytes, or K / N not multiples of 8 (a row stride off 16 bytes), is
    refused, never copied; float32 needs only contiguity."""
    bf = torch.bfloat16
    xs, w = torch.zeros(10, 16, dtype=bf), torch.zeros(2, 16, 24, dtype=bf)
    moe_gmm.check_kernel_inputs(xs, w)
    flat = torch.zeros(10 * 16 + 8, dtype=bf)
    with pytest.raises(ValueError, match="16 bytes"):
        moe_gmm.check_kernel_inputs(flat[1:161].view(10, 16), w)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        moe_gmm.check_kernel_inputs(torch.zeros(10, 12, dtype=bf),
                                    torch.zeros(2, 12, 24, dtype=bf))
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        moe_gmm.check_kernel_inputs(xs, torch.zeros(2, 16, 20, dtype=bf))
    with pytest.raises(ValueError, match="contiguous"):
        moe_gmm.check_kernel_inputs(torch.zeros(16, 10, dtype=bf).t(), w)
    moe_gmm.check_kernel_inputs(torch.zeros(10, 12), torch.zeros(2, 12, 20))
    assert moe_gmm.LAUNCHES == 0


def test_tile_height_override_is_checked_on_every_device():
    xs, w = torch.zeros(10, 16), torch.zeros(2, 16, 24)
    sizes = torch.tensor([4, 6])
    with pytest.raises(ValueError, match="rows_per_tile"):
        moe_gmm.grouped_matmul(xs, w, sizes, rows_per_tile=32)
    for bm in moe_gmm.TILE_ROWS:
        out = moe_gmm.grouped_matmul(xs, w, sizes, rows_per_tile=bm)
        assert out.shape == (10, 24)


# ---------------------------------------------------------------------------
# the gradient's plain forms, which the two backward kernels are held to
# ---------------------------------------------------------------------------
GRAD_SIZES = {
    "ragged": [5, 0, 7, 1, 19],
    "empty experts": [0, 13, 0, 0, 4],
    "one group holds every row": [0, 0, 23, 0],
    "no rows": [0, 0, 0],
}
GRAD_DTYPES = [(jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)]


def _grad_inputs(sizes, tdt, K=16, N=24):
    rng = np.random.default_rng(len(sizes) + sum(sizes))
    M, E = sum(sizes), len(sizes)
    xs, g = (rng.standard_normal(shape).astype(np.float32)
             for shape in ((M, K), (M, N)))
    w = (rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float32)
    return xs, w, g, (_t(xs, tdt), _t(w, tdt), _t(g, tdt),
                      torch.tensor(sizes))


@pytest.mark.parametrize("jdt,tdt", GRAD_DTYPES)
@pytest.mark.parametrize("case", list(GRAD_SIZES))
def test_plain_gradient_forms_are_the_plain_versions_autograd(case, jdt,
                                                              tdt):
    """``dX`` and ``dW`` of the plain version's autograd, bit for bit (the
    same float32 products, rounded once); no rows: an empty ``dX`` and a
    zero ``dW``."""
    _, _, _, (xs, w, g, sizes) = _grad_inputs(GRAD_SIZES[case], tdt)
    dx = moe_gmm.grouped_matmul_dx_torch(g, w, sizes)
    dw = moe_gmm.grouped_matmul_dw_torch(xs, g, sizes)
    assert dx.shape == xs.shape and dw.shape == w.shape
    assert dx.dtype == dw.dtype == tdt
    if not xs.shape[0]:
        assert not dw.any()
        return
    leaves = [t.clone().requires_grad_() for t in (xs, w)]
    out = moe_gmm.grouped_matmul_torch(*leaves, sizes)
    want_dx, want_dw = torch.autograd.grad(out, leaves, g)
    assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw)
    for e in np.flatnonzero(np.asarray(GRAD_SIZES[case]) == 0):
        assert not dw[e].any()


@pytest.mark.parametrize("jdt,tdt", GRAD_DTYPES)
@pytest.mark.parametrize("case", list(GRAD_SIZES))
def test_plain_gradient_forms_match_jax_grad_of_ragged_dot(case, jdt, tdt):
    """Against ``jax.vjp`` of the JAX package's ragged grouped product
    (``jax.lax.ragged_dot``, as ``repro.models.moe._ragged_ffn`` calls
    it), at the JAX package's tolerances for this kernel."""
    sizes = GRAD_SIZES[case]
    x, w, g, (txs, tw, tg, tsizes) = _grad_inputs(sizes, tdt)
    gs = jnp.asarray(sizes, jnp.int32)
    _, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, gs),
                     jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    want_dx, want_dw = vjp(jnp.asarray(g, jdt))
    got_dx = moe_gmm.grouped_matmul_dx_torch(tg, tw, tsizes)
    got_dw = moe_gmm.grouped_matmul_dw_torch(txs, tg, tsizes)
    np.testing.assert_allclose(got_dx.float().numpy(),
                               np.asarray(want_dx, np.float32),
                               **KERNEL_TOL[jdt])
    np.testing.assert_allclose(got_dw.float().numpy(),
                               np.asarray(want_dw, np.float32),
                               **KERNEL_TOL[jdt])


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_tensors_keep_the_plain_gradient(device):
    """Only bfloat16 CUDA tensors take the backward kernels: CPU and
    ``meta`` tensors, bfloat16 included, keep ``PlainGradient`` (the CPU
    tests' path and the dry run's count), and launch nothing."""
    _, _, _, (xs, w, g, sizes) = _grad_inputs([3, 0, 5], torch.bfloat16)
    xs, w, g, sizes = (t.to(device) for t in (xs, w, g, sizes))
    leaves = [t.requires_grad_() for t in (xs, w)]
    before = moe_gmm.BACKWARD_LAUNCHES
    out = moe_gmm.grouped_matmul(*leaves, sizes)
    assert out.grad_fn.name() == "PlainGradientBackward"
    dx, dw = torch.autograd.grad(out, leaves, g)
    assert dx.shape == xs.shape and dw.shape == w.shape
    assert moe_gmm.BACKWARD_LAUNCHES == before and moe_gmm.LAUNCHES == 0


@pytest.mark.parametrize("need", [(True, True), (True, False),
                                  (False, True)])
@pytest.mark.parametrize("sizes", [[3, 0, 5], [0, 0, 0]])
def test_kernel_gradient_launches_what_the_inputs_need(monkeypatch, need,
                                                       sizes):
    """``KernelGradient``'s wiring, its launches replaced by the plain
    forms: the forward gets int32 group sizes, the backward launches the
    ``dX`` kernel only for ``xs``'s gradient and the ``dW`` kernel only for
    ``w``'s, on the saved inputs, and nothing on zero rows."""
    calls = []

    def forward(xs, w, s, *, rows_per_tile):
        assert s.dtype == torch.int32 and rows_per_tile is None
        return moe_gmm.grouped_matmul_torch(xs, w, s)

    def backward(name, inputs, out, ints):
        calls.append(name)
        a, b, s = inputs
        out.copy_(moe_gmm.grouped_matmul_dx_torch(a, b, s)
                  if name == "moe_gmm_bwd_dx"
                  else moe_gmm.grouped_matmul_dw_torch(a, b, s))
        return out

    monkeypatch.setattr(moe_gmm, "_launch", forward)
    monkeypatch.setattr(moe_gmm, "_launch_backward", backward)
    _, _, _, (xs, w, g, tsizes) = _grad_inputs(sizes, torch.bfloat16)
    leaves = [t.requires_grad_(n) for t, n in zip((xs, w), need)]
    out = moe_gmm.KernelGradient.apply(*leaves, tsizes, None)
    got = torch.autograd.grad(out, [t for t in leaves if t.requires_grad],
                              g, allow_unused=True)
    M = sum(sizes)
    assert calls == ([] if not M else
                     ["moe_gmm_bwd_dx"] * need[0] + ["moe_gmm_bwd_dw"]
                     * need[1])
    want = iter((moe_gmm.grouped_matmul_dx_torch(g, w, tsizes),
                 moe_gmm.grouped_matmul_dw_torch(xs, g, tsizes)))
    for n, want_t in zip(need, want):
        if n:
            assert torch.equal(got[0], want_t)
            got = got[1:]


# ---------------------------------------------------------------------------
# ops.moe_gmm_ffn against the reference's ragged FFN; nothing is dropped
# ---------------------------------------------------------------------------
def _ffn_inputs(rng, sizes, d=16, f=8):
    E = len(sizes)
    xs = rng.standard_normal((sum(sizes), d)).astype(np.float32)
    p = {name: (rng.standard_normal(shape) * 0.3).astype(np.float32)
         for name, shape in (("w_gate", (E, d, f)), ("w_up", (E, d, f)),
                             ("w_down", (E, f, d)))}
    return xs, p


@pytest.mark.parametrize("sizes", [
    [5, 0, 7, 0],              # empty experts
    [0, 40, 300, 20],          # expert 2 holds 3.3x the mean
    [0, 0, 1, 0],              # one routed row
])
def test_moe_gmm_ffn_matches_ragged_reference(sizes):
    rng = np.random.default_rng(sum(sizes))
    xs, p = _ffn_inputs(rng, sizes)
    want = np.asarray(ref_moe._ragged_ffn(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(xs),
        jnp.asarray(sizes, jnp.int32), jnp.float32))
    got = ops.moe_gmm_ffn(_t(xs), torch.tensor(sizes),
                          *(_t(p[k]) for k in ("w_gate", "w_up", "w_down")))
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)


def test_moe_gmm_ffn_drops_no_row_past_the_reference_capacity():
    """The reference's padded ``ops.moe_gmm_ffn`` (``repro/kernels/ops.py``
    :118-137) sizes every expert's capacity to the mean group size rounded
    up to a 128-row tile and returns zeros for the rows past it.  With 360
    routed rows over 4 experts that capacity is 128, and expert 2 holds
    300: the reference would zero its last 172 rows; the port computes
    them, equal to the reference's ragged path."""
    sizes = [0, 40, 300, 20]
    T, E, tile = sum(sizes), len(sizes), 128
    cap = max(tile, ((T + E - 1) // E + tile - 1) // tile * tile)
    assert cap == 128 and max(sizes) > 2 * T / E
    rng = np.random.default_rng(7)
    xs, p = _ffn_inputs(rng, sizes)
    got = ops.moe_gmm_ffn(_t(xs), torch.tensor(sizes),
                          *(_t(p[k]) for k in ("w_gate", "w_up", "w_down")))
    start = sizes[0] + sizes[1]
    past_cap = got[start + cap:start + sizes[2]]
    assert past_cap.shape[0] == 172
    assert bool((past_cap.abs().sum(-1) > 0).all())
    want = np.asarray(ref_moe._ragged_ffn(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(xs),
        jnp.asarray(sizes, jnp.int32), jnp.float32))
    np.testing.assert_allclose(past_cap.numpy(),
                               want[start + cap:start + sizes[2]],
                               **LAYER_TOL)


# ---------------------------------------------------------------------------
# the MoE layer: router and every implementation against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def layer():
    """(ref cfg, port cfg, jax params, port params, x) for one MoE layer of
    granite-moe's smoke variant (top-2 of 4 experts, d 64)."""
    cfg = ref_smoke_variant(ref_get_config("granite_moe_1b_a400m"))
    p = ref_moe.moe_init(jax.random.key(3), cfg)
    np_p = {k: np.asarray(v) for k, v in p.items()}
    x = np.random.default_rng(4).standard_normal((2, 12, cfg.d_model)) \
        .astype(np.float32)
    port_cfg = smoke_variant(get_config("granite_moe_1b_a400m"))
    return cfg, port_cfg, p, {k: _t(v) for k, v in np_p.items()}, x


def _aux_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_route_matches_jax(layer):
    cfg, port_cfg, p, tp, x = layer
    x2d = x.reshape(-1, cfg.d_model)
    experts, weights, aux = ref_moe._route(p, jnp.asarray(x2d), cfg)
    g_experts, g_weights, g_aux = moe._route(tp, _t(x2d), port_cfg)
    np.testing.assert_array_equal(g_experts.numpy(), np.asarray(experts))
    np.testing.assert_allclose(g_weights.numpy(), np.asarray(weights),
                               rtol=1e-6, atol=1e-6)
    _aux_close(g_aux, aux)
    assert float(g_aux.expert_load.sum()) == pytest.approx(1.0)


@pytest.mark.parametrize("impl,ref_fn", [
    ("gmm", ref_moe.moe_apply_ragged),
    ("ragged", ref_moe.moe_apply_ragged),
    ("dense", ref_moe.moe_apply_dense),
    ("gathered", ref_moe.moe_apply_gathered),
])
def test_every_moe_impl_matches_jax(layer, impl, ref_fn):
    cfg, port_cfg, p, tp, x = layer
    want, want_aux = ref_fn(p, jnp.asarray(x), cfg)
    got, got_aux = moe.moe_apply(tp, _t(x), replace(port_cfg, moe_impl=impl))
    assert moe_gmm.LAUNCHES == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    _aux_close(got_aux, want_aux)


def test_routing_hook_records_and_replays(layer):
    """A hook that returns the experts it is given changes nothing; one
    that returns a recorded routing routes there, weighted by the
    replaying run's own renormalised probabilities."""
    cfg, port_cfg, p, tp, x = layer
    x2d = _t(x.reshape(-1, cfg.d_model))
    experts, weights, aux = moe._route(tp, x2d, port_cfg)
    seen = []
    with moe.routing_hook(lambda probs, e: seen.append((probs, e)) or e):
        h_experts, h_weights, h_aux = moe._route(tp, x2d, port_cfg)
    assert len(seen) == 1 and moe._routing_hook is None
    assert torch.equal(h_experts, experts) and torch.equal(h_weights, weights)
    _aux_close(h_aux, aux)
    pinned = torch.flip(experts, dims=[-1]).roll(1, dims=0)
    with moe.routing_hook(lambda probs, e: pinned):
        r_experts, r_weights, _ = moe._route(tp, x2d, port_cfg)
    want = seen[0][0].gather(-1, pinned)
    assert torch.equal(r_experts, pinned)
    torch.testing.assert_close(r_weights, want / want.sum(-1, keepdim=True))
    out, _ = moe.moe_apply(tp, _t(x), replace(port_cfg, moe_impl="gmm"))
    with moe.routing_hook(lambda probs, e: e):
        same, _ = moe.moe_apply(tp, _t(x), replace(port_cfg, moe_impl="gmm"))
    assert torch.equal(out, same)


def test_sort_is_stable_as_jnp_argsort(layer):
    """Rows of one expert keep their (token, slot) order."""
    cfg, port_cfg, p, tp, x = layer
    flat = torch.tensor([2, 0, 2, 1, 0, 2, 1, 0])
    order = torch.argsort(flat, stable=True)
    np.testing.assert_array_equal(
        order.numpy(), np.asarray(jnp.argsort(jnp.asarray(flat.numpy()))))


def test_expert_parallel_raises_until_ported():
    """Expert parallelism is ported (``parallel/ep_moe.py``,
    ``tests/test_torch_parallel.py``): ``"ep"`` validates, an unknown
    implementation still raises."""
    cfg = get_config("granite_moe_1b_a400m")
    assert cfg.moe_impl == "gmm"
    assert smoke_variant(cfg).moe_impl == "ragged"
    assert replace(cfg, moe_impl="ep").validate().moe_impl == "ep"
    with pytest.raises(ValueError):
        replace(cfg, moe_impl="megablocks").validate()
