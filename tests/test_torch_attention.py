"""The attention kernels' plain versions and model-layout wrappers against
the JAX package's Pallas kernels (interpret mode) and oracles.

``repro.kernels`` cannot be imported on every jax build (its ``__init__``
pulls in the float64 gate kernel), so the three modules used here are
loaded by file path.  Inputs are made from a seed with numpy and handed to
both packages; float32, rtol/atol 2e-5 (sums are taken in another order).
On the CPU the port's wrappers take the kernels' plain versions, so the
CUDA kernels themselves are held against those versions by
``chip_smoke.py`` on the GPU.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as port_decode
from repro_torch.kernels import flash_attention as port_flash
from repro_torch.kernels import ops

KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro" / "kernels"
TOL = dict(rtol=2e-5, atol=2e-5)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_kernel_{name}", KERNELS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


pallas_flash = _load("flash_attention").flash_attention
pallas_decode = _load("decode_attention").decode_attention
ref = _load("ref")


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bhsd_to_model(a):
    """The JAX kernels' ``[BH, S, D]`` as the port's ``[1, S, BH, D]``
    (a permuted view: the kernels read strides, nothing is copied)."""
    return _t(a).permute(1, 0, 2)[None]


# ---------------------------------------------------------------------------
# flash attention (K2)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_rep,d", [(1, 64), (4, 16), (16, 64)])
def test_flash_plain_matches_pallas(causal, n_rep, d):
    rng = np.random.default_rng([1, n_rep, d, causal])
    kv, s = 2 if n_rep < 16 else 1, 64
    q = _normal(rng, kv * n_rep, s, d)
    k, v = _normal(rng, kv, s, d), _normal(rng, kv, s, d)
    want = np.asarray(pallas_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=32, block_k=32, n_rep=n_rep, interpret=True))
    got = port_flash.flash_attention(
        _bhsd_to_model(q), _bhsd_to_model(k), _bhsd_to_model(v),
        causal=causal)
    np.testing.assert_allclose(got[0].permute(1, 0, 2).numpy(), want, **TOL)


def test_flash_model_layout_wrapper_matches_pallas():
    rng = np.random.default_rng(2)
    B, S, H, KV, D = 2, 64, 8, 2, 16
    q = _normal(rng, B, S, H, D)
    k, v = _normal(rng, B, S, KV, D), _normal(rng, B, S, KV, D)

    def bhsd(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(-1, S, D))

    want = np.asarray(pallas_flash(
        bhsd(q), bhsd(k), bhsd(v), causal=True, block_q=32, block_k=32,
        n_rep=H // KV, interpret=True))
    got = ops.mha_flash(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(
        got.numpy().transpose(0, 2, 1, 3).reshape(-1, S, D), want, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ragged_tail_matches_ref(causal):
    """S = 50 is no multiple of any tile (the Pallas kernel refuses it)."""
    rng = np.random.default_rng(3)
    q = _normal(rng, 8, 50, 16)
    k, v = _normal(rng, 2, 50, 16), _normal(rng, 2, 50, 16)
    want = np.asarray(ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        n_rep=4))
    got = port_flash.flash_attention(
        _bhsd_to_model(q), _bhsd_to_model(k), _bhsd_to_model(v),
        causal=causal)
    np.testing.assert_allclose(got[0].permute(1, 0, 2).numpy(), want, **TOL)


def test_flash_wrapper_refuses_what_does_not_fit():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError):
        port_flash.flash_attention(q, torch.zeros(1, 8, 3, 16),
                                   torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError):
        port_flash.flash_attention(q, torch.zeros(1, 8, 2, 8),
                                   torch.zeros(1, 8, 2, 8))
    with pytest.raises(TypeError):
        port_flash.flash_attention(q, torch.zeros(1, 8, 2, 16).double(),
                                   torch.zeros(1, 8, 2, 16).double())
    assert port_flash.LAUNCHES == 0


def _misaligned(shape, dtype=torch.bfloat16):
    """A tensor of ``shape`` whose base lies 2 bytes past a 16-byte
    boundary (torch's own allocations start on 64)."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)


def test_flash_kernel_refuses_what_tma_cannot_take():
    """The CUDA branch's checks (run here on CPU tensors, as the wrapper
    runs them on CUDA ones before a launch): a bf16 base address off 16
    bytes, or a stride that is not a multiple of 16 bytes, is refused and
    never copied; the JAX layout's permuted view is taken as it is."""
    bf = torch.bfloat16
    q = torch.zeros(2, 16, 8, 64, dtype=bf)
    kv = torch.zeros(2, 16, 2, 64, dtype=bf)
    port_flash.check_kernel_inputs(q, kv, kv)
    with pytest.raises(ValueError, match="16 bytes"):
        port_flash.check_kernel_inputs(_misaligned((2, 16, 8, 64)), kv, kv)
    # 68 values a row: the sequence stride is 136 bytes.
    odd = torch.zeros(2, 16, 2, 68, dtype=bf)[..., :64]
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        port_flash.check_kernel_inputs(q, odd, kv)
    view = torch.zeros(16, 16, 64, dtype=bf).permute(1, 0, 2)[None]
    port_flash.check_kernel_inputs(view, view[:, :, :4], view[:, :, :4])
    # float32 is not loaded by TMA: only the head dimension must be
    # contiguous.
    port_flash.check_kernel_inputs(_misaligned((2, 16, 8, 64), torch.float32),
                                   kv.float(), kv.float())
    with pytest.raises(ValueError, match="contiguous"):
        port_flash.check_kernel_inputs(
            torch.zeros(2, 16, 8, 128, dtype=bf)[..., ::2], kv, kv)
    assert port_flash.LAUNCHES == 0


def test_tma_strides_fill_in_axes_of_one():
    """A tensor map needs a 16-byte multiple for every stride, also of an
    axis of one element, whose stride torch may report as anything."""
    from repro_torch.kernels.tma import tma_strides
    q = torch.zeros(2, 16, 8, 64, dtype=torch.bfloat16)
    assert tma_strides(q) == [16 * 8 * 64, 8 * 64, 64]
    one = torch.zeros(1, 16, 1, 64, dtype=torch.bfloat16).as_strided(
        (1, 16, 1, 64), (3, 64, 5, 1))
    assert tma_strides(one) == [16 * 64, 64, 64]
    assert all(s * 2 % 16 == 0 for s in tma_strides(one))


def test_the_kernels_query_tile_is_the_wrappers():
    """``BF16_BQ`` of ``csrc/flash_attention.cu`` (query rows per work
    item of the bf16 kernel: two consumer warpgroups of 64) is the
    wrapper's."""
    src = (Path(port_flash.__file__).parent / "csrc"
           / "flash_attention.cu").read_text()
    assert f"constexpr int BF16_BQ = {port_flash.BF16_BQ};" in src
    assert port_flash.BF16_BQ == 2 * 64


# ---------------------------------------------------------------------------
# decode attention (K3)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_rep,d,cache_len", [
    (1, 64, 0),      # one valid position
    (4, 16, 31),     # the last position of the first split
    (4, 16, 32),     # the first position of the second split
    (16, 64, 95),    # the last position of the cache
    (16, 16, 50),
])
def test_decode_plain_matches_pallas(n_rep, d, cache_len):
    rng = np.random.default_rng([4, n_rep, d, cache_len])
    kv, s = 2, 96
    q = _normal(rng, kv * n_rep, d)
    k, v = _normal(rng, kv, s, d), _normal(rng, kv, s, d)
    want = np.asarray(pallas_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.int32(cache_len), block_k=32, n_rep=n_rep, interpret=True))
    got = port_decode.decode_attention(
        _t(q)[None], _bhsd_to_model(k), _bhsd_to_model(v),
        torch.tensor(cache_len, dtype=torch.int32))
    np.testing.assert_allclose(got[0].numpy(), want, **TOL)


def test_decode_model_layout_wrapper_matches_pallas():
    rng = np.random.default_rng(5)
    B, S, H, KV, D, cache_len = 2, 64, 8, 2, 16, 40
    q = _normal(rng, B, 1, H, D)
    k, v = _normal(rng, B, S, KV, D), _normal(rng, B, S, KV, D)

    def bhsd(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(-1, S, D))

    want = np.asarray(pallas_decode(
        jnp.asarray(q.reshape(B * H, D)), bhsd(k), bhsd(v),
        jnp.int32(cache_len), block_k=32, n_rep=H // KV, interpret=True))
    got = ops.mha_decode(_t(q), _t(k), _t(v),
                         torch.tensor(cache_len, dtype=torch.int32))
    assert got.shape == (B, 1, H, D)
    np.testing.assert_allclose(got.numpy().reshape(B * H, D), want, **TOL)


def test_decode_ragged_cache_matches_ref():
    """S_max = 70 is no multiple of any split (the Pallas kernel refuses
    it)."""
    rng = np.random.default_rng(6)
    q = _normal(rng, 8, 16)
    k, v = _normal(rng, 2, 70, 16), _normal(rng, 2, 70, 16)
    for cache_len in (0, 63, 64, 69):
        want = np.asarray(ref.decode_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cache_len,
            n_rep=4))
        got = port_decode.decode_attention(
            _t(q)[None], _bhsd_to_model(k), _bhsd_to_model(v),
            torch.tensor(cache_len, dtype=torch.int32))
        np.testing.assert_allclose(got[0].numpy(), want, **TOL)


@pytest.mark.parametrize("cache_len", [0, 5])
def test_decode_mask_is_inclusive(cache_len):
    """Position ``cache_len`` holds the new token and is attended: with a
    key that dominates every logit there, the output is its value row.
    A ``<`` mask would miss it and fail this."""
    B, S, H, KV, D = 1, 16, 4, 1, 16
    q = torch.ones(B, H, D)
    k = torch.zeros(B, S, KV, D)
    v = torch.arange(S, dtype=torch.float32)[None, :, None, None].expand(
        B, S, KV, D).contiguous()
    k[:, cache_len] = 10.0
    got = port_decode.decode_attention(
        q, k, v, torch.tensor(cache_len, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.full((B, H, D), cache_len),
                               atol=1e-6)
    k[:, cache_len] = 0.0
    got = port_decode.decode_attention(
        q, k, v, torch.tensor(cache_len, dtype=torch.int32))
    # uniform over positions 0..cache_len inclusive
    np.testing.assert_allclose(got.numpy(), np.full((B, H, D), cache_len / 2),
                               atol=1e-5)
    assert port_decode.LAUNCHES == 0


# ---------------------------------------------------------------------------
# the bfloat16 decode kernel's split plan and combine (K3)
# ---------------------------------------------------------------------------
def test_the_kernels_split_plan_is_the_wrappers():
    """The plan constants of ``csrc/decode_attention.cu`` are the
    wrapper's: the kernel checks the plan it is given against them, and
    four warps of 16 positions make a tile."""
    src = (Path(port_decode.__file__).parent / "csrc"
           / "decode_attention.cu").read_text()
    for name, value in (("TILE", port_decode.TILE),
                        ("SPLIT_MULTIPLE", port_decode.SPLIT_MULTIPLE),
                        ("MAX_SPLITS", port_decode.MAX_SPLITS),
                        ("HG", port_decode.HEAD_GROUP),
                        ("SPLIT", port_decode.SPLIT)):
        assert f"constexpr int {name} = {value};" in src, name
    assert "constexpr int BF16_WARPS = 4;" in src
    assert port_decode.TILE == 4 * 16


@pytest.mark.parametrize("S", [1, 5, 16, 63, 64, 70, 100, 511, 1000, 1064,
                               4096])
@pytest.mark.parametrize("B,KV,n_rep", [(1, 1, 1), (2, 2, 4), (8, 2, 16),
                                        (8, 8, 2), (2, 2, 32), (64, 8, 2)])
def test_split_plan_covers_every_position_once(S, B, KV, n_rep):
    n, length = port_decode.split_plan(B, KV, n_rep, S)
    assert 1 <= n <= port_decode.MAX_SPLITS
    assert length % port_decode.SPLIT_MULTIPLE == 0
    seen = np.zeros(S, dtype=int)
    for s in range(n):
        seen[s * length:min((s + 1) * length, S)] += 1
    assert (seen == 1).all()
    assert (n - 1) * length < S <= n * length


@pytest.mark.parametrize("arch,B,KV,n_rep", [
    ("glm4-9b", 8, 2, 16), ("granite-moe-1b-a400m", 8, 8, 2)])
def test_split_plan_is_about_one_wave_at_the_serving_shapes(arch, B, KV,
                                                            n_rep):
    """At the serving decode (cache 1064) the grid is within a sixth of one
    wave of an H100's 132 SMs, never over it."""
    n, length = port_decode.split_plan(B, KV, n_rep, 1064, sms=132)
    blocks = B * KV * -(-n_rep // 16) * n
    assert 110 <= blocks <= 132, (arch, n, length, blocks)


@pytest.mark.parametrize("n_rep,d,cache_len,B", [
    (1, 64, 0, 1), (4, 16, 31, 2), (4, 16, 32, 2), (16, 64, 95, 1),
    (16, 16, 50, 2), (32, 16, 70, 1)])
def test_split_combine_matches_plain_and_pallas(n_rep, d, cache_len, B):
    """The partials and combine at the kernel's own plan (float32, where
    the two forms differ only in the order of their sums) against the plain
    version and the Pallas kernel."""
    rng = np.random.default_rng([7, n_rep, d, cache_len, B])
    kv, s = 2, 96
    q = _normal(rng, B * kv * n_rep, d)
    k, v = _normal(rng, B * kv, s, d), _normal(rng, B * kv, s, d)
    want = np.asarray(pallas_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.int32(cache_len), block_k=32, n_rep=n_rep, interpret=True))
    tq = _t(q).view(B, kv * n_rep, d)
    tk = _t(k).view(B, kv, s, d).permute(0, 2, 1, 3)
    tv = _t(v).view(B, kv, s, d).permute(0, 2, 1, 3)
    n = torch.tensor(cache_len, dtype=torch.int32)
    n_s, length = port_decode.split_plan(B, kv, n_rep, s)
    assert n_s > 1 or s <= length
    got = port_decode.decode_attention_splits_torch(tq, tk, tv, n, length)
    plain = port_decode.decode_attention_torch(tq, tk, tv, n)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(got.reshape(-1, d).numpy(), want, **TOL)


@pytest.mark.parametrize("length", [16, 48, 144])
def test_split_combine_in_bfloat16_matches_plain(length):
    """bf16 inputs, p rounded to bf16 per split: within the kernel's bf16
    tolerance of the plain version, also with splits past cache_len."""
    g = torch.Generator().manual_seed(length)
    q = torch.randn(2, 8, 64, generator=g).bfloat16()
    k = torch.randn(2, 300, 2, 64, generator=g).bfloat16()
    v = torch.randn(2, 300, 2, 64, generator=g).bfloat16()
    for cache_len in (0, length - 1, length, 200, 299):
        n = torch.tensor(cache_len, dtype=torch.int32)
        got = port_decode.decode_attention_splits_torch(q, k, v, n, length)
        want = port_decode.decode_attention_torch(q, k, v, n)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


def test_decode_kernel_refuses_what_16_byte_loads_cannot_take():
    """The CUDA branch's checks (run here on CPU tensors, as the wrapper
    runs them on CUDA ones before a launch): for bfloat16 a base address
    off 16 bytes, or a stride that is not a multiple of 16 bytes, is
    refused and never copied; the model layout's cache and a decode step's
    ``q[:, 0]`` view are taken as they are."""
    bf = torch.bfloat16
    q = torch.zeros(2, 1, 8, 64, dtype=bf)[:, 0]
    kv = torch.zeros(2, 100, 2, 64, dtype=bf)
    port_decode.check_kernel_inputs(q, kv, kv)
    with pytest.raises(ValueError, match="16 bytes"):
        port_decode.check_kernel_inputs(_misaligned((2, 8, 64)), kv, kv)
    with pytest.raises(ValueError, match="16 bytes"):
        port_decode.check_kernel_inputs(q, _misaligned((2, 100, 2, 64)), kv)
    # 68 values a row: the position stride is 136 bytes.
    odd = torch.zeros(2, 100, 2, 68, dtype=bf)[..., :64]
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        port_decode.check_kernel_inputs(q, kv, odd)
    # float32 is read element by element: only D must be contiguous.
    port_decode.check_kernel_inputs(_misaligned((2, 8, 64), torch.float32),
                                    kv.float(), kv.float())
    with pytest.raises(ValueError, match="contiguous"):
        port_decode.check_kernel_inputs(
            torch.zeros(2, 8, 128, dtype=bf)[..., ::2], kv, kv)
    with pytest.raises(ValueError, match="head_dim"):
        port_decode.check_kernel_inputs(torch.zeros(2, 8, 32, dtype=bf),
                                        kv[..., :32], kv[..., :32])
    assert port_decode.LAUNCHES == 0


# ---------------------------------------------------------------------------
# the decode kernel's statistics form (K3 over one block of a cache)
# ---------------------------------------------------------------------------
def _stats_blocks(q, k, v, cache_len: int, bounds):
    """The statistics form over each block ``[lo, hi)`` of the cache, the
    token at its block index ``cache_len - lo`` clamped to ``[-1, hi - lo
    - 1]``, stacked."""
    parts = [port_decode.decode_attention(
        q, k[:, lo:hi], v[:, lo:hi],
        torch.tensor(max(-1, min(cache_len - lo, hi - lo - 1)),
                     dtype=torch.int32), stats=True) for lo, hi in bounds]
    return tuple(torch.stack(t) for t in zip(*parts))


@pytest.mark.parametrize("cache_len,bounds", [
    (7, [(0, 8), (8, 16), (16, 24), (24, 30)]),     # at a block's last
    (8, [(0, 8), (8, 16), (16, 24), (24, 30)]),     # at a block's first
    (12, [(0, 8), (8, 16), (16, 24), (24, 30)]),    # two blocks empty
    (27, [(0, 11), (11, 13), (13, 30)]),            # uneven blocks
    (0, [(0, 8), (8, 16), (16, 24), (24, 30)]),     # the first position
    (29, [(0, 15), (15, 30)]),                      # the last position
])
def test_stats_blocks_combine_to_the_whole_cache(cache_len, bounds):
    """Blocks of the statistics form, combined by ``combine_blocks``, give
    the plain version over the whole cache and the JAX package's decode
    oracle."""
    rng = np.random.default_rng([8, cache_len, len(bounds)])
    B, S, KV, n_rep, D = 2, 30, 2, 4, 16
    q = _normal(rng, B, KV * n_rep, D)
    k, v = _normal(rng, B, S, KV, D), _normal(rng, B, S, KV, D)
    o, m, l = _stats_blocks(_t(q), _t(k), _t(v), cache_len, bounds)
    got = port_decode.combine_blocks(o, m, l)
    whole = port_decode.decode_attention_torch(
        _t(q), _t(k), _t(v), torch.tensor(cache_len, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)
    for b in range(B):
        want = np.asarray(ref.decode_attention_ref(
            jnp.asarray(q[b]), jnp.asarray(k[b].transpose(1, 0, 2)),
            jnp.asarray(v[b].transpose(1, 0, 2)), cache_len, n_rep=n_rep))
        np.testing.assert_allclose(got[b].numpy(), want, **TOL)
    for i, (lo, _) in enumerate(bounds):
        if lo > cache_len:                    # past the token: empty
            assert (m[i] == -1e30).all() and not l[i].any()
            assert not o[i].any()
        else:
            assert (l[i] >= 1).all() and (m[i] > -1e30).all()
    assert port_decode.LAUNCHES == 0


def test_stats_of_a_block_with_no_valid_position():
    """``cache_len = -1``: ``m = -1e30``, ``l = 0``, ``o = 0`` (float32),
    whatever the block holds; in bfloat16 too."""
    g = torch.Generator().manual_seed(9)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(1, 8, 64, generator=g).to(dtype)
        k = torch.randn(1, 262, 2, 64, generator=g).to(dtype)
        o, m, l = port_decode.decode_attention(
            q, k, k, torch.tensor(-1, dtype=torch.int32), stats=True)
        assert o.dtype == m.dtype == l.dtype == torch.float32
        assert o.shape == (1, 8, 64) and m.shape == l.shape == (1, 8)
        assert not o.any() and not l.any() and (m == -1e30).all()


def test_stats_in_bfloat16_are_the_plain_versions_rounding():
    """bf16 blocks of a 262-position block length: the combine is within
    the kernel's bf16 tolerance of the default form over the whole cache,
    and the statistics form's output is float32, the default's bf16."""
    g = torch.Generator().manual_seed(10)
    q = torch.randn(1, 16, 64, generator=g).bfloat16()
    k = torch.randn(1, 1048, 8, 64, generator=g).bfloat16()
    v = torch.randn(1, 1048, 8, 64, generator=g).bfloat16()
    bounds = [(i * 262, (i + 1) * 262) for i in range(4)]
    for cache_len in (511, 523, 524):
        o, m, l = _stats_blocks(q, k, v, cache_len, bounds)
        got = port_decode.combine_blocks(o, m, l)
        want = port_decode.decode_attention(
            q, k, v, torch.tensor(cache_len, dtype=torch.int32))
        assert want.dtype == torch.bfloat16 and got.dtype == torch.float32
        torch.testing.assert_close(got, want.float(), rtol=2e-2, atol=2e-2)


def test_stats_form_takes_the_kernels_checks_on_meta():
    """On ``meta`` tensors (the dry run) the statistics form takes the
    kernel's checks and returns float32 shapes: a block of 262 positions
    is taken, a head_dim the kernel lacks is refused, never passed to a
    plain version."""
    from repro_torch.launch import roofline

    bf = torch.bfloat16
    q = torch.empty(1, 16, 64, dtype=bf, device="meta")
    kv = torch.empty(1, 262, 8, 64, dtype=bf, device="meta")
    n = torch.empty((), dtype=torch.int32, device="meta")
    with roofline.StepCounter() as counter:
        o, m, l = port_decode.decode_attention(q, kv, kv, n, stats=True)
        port_decode.decode_attention(q, kv, kv, n)
    assert (o.shape, m.shape, l.shape) == ((1, 16, 64), (1, 16), (1, 16))
    assert o.dtype == m.dtype == l.dtype == torch.float32
    assert counter.kernels["decode_attention"]["launches"] == 2
    with pytest.raises(ValueError, match="head_dim"):
        port_decode.decode_attention(q[..., :16], kv[..., :16],
                                     kv[..., :16], n, stats=True)
    assert port_decode.LAUNCHES == 0


def test_the_stats_entry_point_takes_the_wrappers_arguments():
    """``decode_attention_stats_fwd`` in ``csrc/decode_attention.cu`` has
    the default entry point's arguments with ``m_out`` and ``l_out`` after
    the output: the ctypes binding the wrapper declares."""
    import re

    src = (Path(port_decode.__file__).parent / "csrc"
           / "decode_attention.cu").read_text()

    def params(name):
        sig = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{",
                        src, re.S).group(1)
        return [p.split()[-1].lstrip("*") for p in sig.split(",")]
    default, stats = params("decode_attention_fwd"), params(
        "decode_attention_stats_fwd")
    i = default.index("out") + 1
    assert stats == default[:i] + ["m_out", "l_out"] + default[i:]
    assert len(stats) == 30
