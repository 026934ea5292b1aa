"""The Mamba2 SSD layer and the intra-chunk kernel's plain version against
the JAX package: its Pallas ``ssd_intra_chunk`` (interpret mode, loaded by
file path, as ``repro.kernels`` cannot be imported on every jax build), its
``ref.ssd_intra_chunk_ref`` oracle, and ``repro.models.ssd``.

Inputs are made from a seed with numpy and handed to both packages, in
float32.  The kernel's plain version agrees to 1e-5 (the reference
kernel's own test tolerance); the chunked layer, the sequential oracle and
the mixer to 1e-4 (sums and scans in another order).  On the CPU the
port's wrappers take the kernel's plain version, so the CUDA kernel itself
is held against that version by ``chip_smoke.py`` on the GPU.
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
from repro.models import Model as RefModel
from repro.models import smoke_variant as ref_smoke_variant
from repro.models import ssd as ref_ssd

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops, ssd_scan
from repro_torch.models import smoke_variant
from repro_torch.models import ssd

KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro" / "kernels"
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_kernel_{name}", KERNELS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


pallas_ssd = _load("ssd_scan").ssd_intra_chunk
ref = _load("ref")


def _inputs(seed, B=2, S=32, H=4, G=2, P=8, N=16):
    """x, dt (a softplus output, 0.02-0.3), A (negative), B, C — numpy
    float32, the model layout."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(-2.5, 0.7, (B, S, H)))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.5, H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _chunked_layout(a, Q, rep=1):
    """Model layout ``[B, S, X, w]`` (X heads, or groups repeated ``rep``
    times) → the Pallas kernel's ``[B, H, Nc, Q, w]``."""
    a = np.repeat(a, rep, axis=2)
    B, S, H, W = a.shape
    return a.reshape(B, S // Q, Q, H, W).transpose(0, 3, 1, 2, 4)


# ---------------------------------------------------------------------------
# the kernel's plain version (K4)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Q", [8, 16, 32])
def test_plain_matches_pallas_and_ref(Q):
    x, dt, A, Bm, Cm = _inputs(Q)
    H, G = x.shape[2], Bm.shape[2]
    args = (jnp.asarray(_chunked_layout(x, Q)),
            jnp.asarray(_chunked_layout(dt[..., None], Q)[..., 0]),
            jnp.asarray(A),
            jnp.asarray(_chunked_layout(Bm, Q, H // G)),
            jnp.asarray(_chunked_layout(Cm, Q, H // G)))
    want_pallas = pallas_ssd(*args, interpret=True)
    want_ref = ref.ssd_intra_chunk_ref(*args)
    y, states, seg = ssd_scan.ssd_intra_chunk(*map(_t, (x, dt, A, Bm, Cm)), Q)
    assert ssd_scan.LAUNCHES == 0
    got = (_chunked_layout(y.numpy(), Q), states.numpy(), seg.numpy())
    for want in (want_pallas, want_ref):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), **KERNEL_TOL)


def test_y_intra_is_float32_for_bfloat16_inputs():
    """``y`` is the intra-chunk part, which ``ssd_chunked_cuda`` adds to the
    inter-chunk part before it rounds: float32 whatever x's dtype.  Cast to
    bf16 it is the Pallas kernel's bf16 ``y``, to its bf16 tolerance."""
    Q = 16
    x, dt, A, Bm, Cm = _inputs(4)
    H, G = x.shape[2], Bm.shape[2]
    bf = [_t(a).bfloat16() for a in (x, Bm, Cm)]
    y, states, seg = ssd_scan.ssd_intra_chunk(bf[0], _t(dt), _t(A), bf[1],
                                              bf[2], Q)
    assert y.dtype == states.dtype == seg.dtype == torch.float32
    j = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in bf]
    want = pallas_ssd(jnp.asarray(_chunked_layout(np.asarray(j[0]), Q)),
                      jnp.asarray(_chunked_layout(dt[..., None], Q)[..., 0]),
                      jnp.asarray(A),
                      jnp.asarray(_chunked_layout(np.asarray(j[1]), Q, H // G)),
                      jnp.asarray(_chunked_layout(np.asarray(j[2]), Q, H // G)),
                      interpret=True)
    assert want[0].dtype == jnp.bfloat16
    got = _chunked_layout(y.bfloat16().float().numpy(), Q)
    np.testing.assert_allclose(got, np.asarray(want[0], np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(states.numpy(), np.asarray(want[1]),
                               rtol=2e-2, atol=2e-2)


def test_upper_triangle_is_selected_not_multiplied():
    """exp(seg_i - seg_j) overflows for i < j when the decay is steep: a
    0/1 mask multiplied in would give inf · 0 = NaN."""
    x, dt, A, Bm, Cm = _inputs(5, S=16)
    A = np.full_like(A, -60.0)
    y, states, _ = ssd_scan.ssd_intra_chunk(*map(_t, (x, dt, A, Bm, Cm)), 16)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(states).all())


def test_wrapper_refuses_what_does_not_fit():
    x, dt, A, Bm, Cm = map(_t, _inputs(6))
    with pytest.raises(ValueError):
        ssd_scan.ssd_intra_chunk(x, dt, A, Bm, Cm, 12)      # 32 % 12
    with pytest.raises(TypeError):
        ssd_scan.ssd_intra_chunk(x, dt.double(), A, Bm, Cm, 16)
    three_groups = torch.zeros(2, 32, 3, 16)             # 4 heads % 3
    with pytest.raises(ValueError):
        ssd_scan.ssd_intra_chunk(x, dt, A, three_groups, three_groups, 16)


# ---------------------------------------------------------------------------
# the chunked layer: kernel entry point and plain form against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,chunk,G,h0", [
    (32, 8, 2, False),     # Nc = 4, G > 1
    (32, 8, 1, True),      # a given initial state
    (16, 16, 2, True),     # Nc = 1
    (12, 64, 4, False),    # chunk > S: one chunk of S steps
    (20, 256, 1, True),    # one chunk of 20 steps, padded to 32 for K4
    (100, 256, 2, True),   # one chunk of 100 steps, padded to 112
])
def test_chunked_forms_match_jax(S, chunk, G, h0):
    x, dt, A, Bm, Cm = _inputs(S + chunk + G, S=S, G=G)
    B_, _, H, P = x.shape
    h_init = (np.random.default_rng(9).standard_normal(
        (B_, H, P, Bm.shape[3])).astype(np.float32) if h0 else None)
    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jh0 = None if h_init is None else jnp.asarray(h_init)
    want_y, want_h = ref_ssd.ssd_chunked(*jargs, chunk, h0=jh0)
    seq_y, seq_h = ref_ssd.ssd_reference(*jargs, h0=jh0)
    targs = [_t(a) for a in (x, dt, A, Bm, Cm)]
    th0 = None if h_init is None else _t(h_init)
    for fn in (ops.ssd_chunked_cuda, ssd.ssd_chunked):
        y, h = fn(*targs, chunk, h0=th0)
        for g, w in ((y, want_y), (h, want_h), (y, seq_y), (h, seq_h)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    y, h = ssd.ssd_reference(*targs, h0=th0)
    np.testing.assert_allclose(y.numpy(), np.asarray(seq_y), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(seq_h), **TOL)


def test_chunked_cuda_gives_the_kernel_whole_tiles(monkeypatch):
    """A one-chunk S that is not a multiple of 16 reaches the kernel padded
    with dt = 0 steps (on a GPU the kernel takes whole 16-step tiles), and
    the result is that of the plain chunked form on the unpadded input."""
    seen = []

    def spy(x, dt, A, Bm, Cm, chunk):
        seen.append((x.shape[1], chunk))
        return ssd_scan.ssd_intra_chunk(x, dt, A, Bm, Cm, chunk)
    monkeypatch.setattr(ops, "ssd_intra_chunk", spy)
    for S in (1, 12, 16, 100):
        x, dt, A, Bm, Cm = map(_t, _inputs(S, S=S))
        h0 = torch.randn((2, 4, 8, 16), generator=torch.Generator()
                         .manual_seed(S))
        y, h = ops.ssd_chunked_cuda(x, dt, A, Bm, Cm, 256, h0=h0)
        want_y, want_h = ssd.ssd_chunked(x, dt, A, Bm, Cm, 256, h0=h0)
        assert y.shape == x.shape
        torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-5)
    assert seen == [(16, 16), (16, 16), (16, 16), (112, 112)]


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    pre = rng.standard_normal((2, 3, 6)).astype(np.float32) \
        if with_state else None
    want = ref_ssd.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if pre is None else jnp.asarray(pre))
    got = ssd.causal_conv1d(_t(x), _t(w), _t(b),
                            None if pre is None else _t(pre))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the mixer, with parameters carried from the JAX model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mixer():
    cfg = ref_smoke_variant(ref_get_config("mamba2_130m"))
    np_params = jax.tree.map(np.asarray,
                             RefModel(cfg).init(jax.random.key(2)))
    rng = np.random.default_rng(3)
    blk = np_params["blocks"]["L0_ssm"]
    for name in ("norm_scale", "inner_norm", "D", "conv_x_b", "conv_bc_b"):
        blk[name] = (blk[name] + rng.normal(0, 0.1, blk[name].shape)) \
            .astype(np.float32)
    port_cfg = smoke_variant(get_config("mamba2_130m"))
    params = lm_params_from_numpy(np_params, port_cfg, device="cpu")
    jp = {k: jnp.asarray(v[0]) for k, v in blk.items()}
    tp = {k: v[0] for k, v in params["blocks"]["L0_ssm"].items()}
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    return cfg, port_cfg, jp, tp, x


@pytest.mark.parametrize("impl", ["cuda", "chunked"])
def test_ssm_apply_and_state_match_jax(mixer, impl):
    cfg, port_cfg, jp, tp, x = mixer
    want, want_st = ref_ssd.ssm_apply(jp, jnp.asarray(x), cfg,
                                      return_state=True)
    got, got_st = ssd.ssm_apply(tp, _t(x), replace(port_cfg, ssm_impl=impl),
                                return_state=True)
    assert ssd_scan.LAUNCHES == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for g, w in zip(got_st, want_st):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_ssm_decode_continues_the_prefill_state(mixer):
    """Prefill 8 steps (one chunk), then decode the last 8 one at a time:
    each step matches the JAX recurrent step on the JAX state, and the
    outputs match the full-sequence mixer's last 8 positions."""
    cfg, port_cfg, jp, tp, x = mixer
    full = ref_ssd.ssm_apply(jp, jnp.asarray(x), cfg)
    _, jst = ref_ssd.ssm_apply(jp, jnp.asarray(x[:, :8]), cfg,
                               return_state=True)
    _, st = ssd.ssm_apply(tp, _t(x[:, :8]), port_cfg, return_state=True)
    for t in range(8, 16):
        want, jst = ref_ssd.ssm_decode(jp, jnp.asarray(x[:, t:t + 1]), cfg,
                                       jst)
        got, st = ssd.ssm_decode(tp, _t(x[:, t:t + 1]), port_cfg, st)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(full)[:, t:t + 1],
                                   **TOL)
        for g, w in zip(st, jst):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_default_is_the_kernel_and_smoke_keeps_the_plain_form():
    cfg = get_config("mamba2_130m")
    assert cfg.ssm_impl == "cuda"
    assert smoke_variant(cfg).ssm_impl == "chunked"
    with pytest.raises(ValueError):
        replace(cfg, ssm_impl="scan").validate()


# ---------------------------------------------------------------------------
# the bfloat16 kernel's head groups (K4)
# ---------------------------------------------------------------------------
def test_the_kernels_head_group_plan_is_the_wrappers():
    """The plan's constants and shared-memory sum in ``csrc/ssd_scan.cu``
    are the wrapper's: the kernel refuses a plan past them."""
    src = (Path(ssd_scan.__file__).parent / "csrc" / "ssd_scan.cu").read_text()
    for name, value in (("MAX_HEADS_PER_BLOCK", ssd_scan.MAX_HEADS_PER_BLOCK),
                        ("SMEM_MAX", ssd_scan.SMEM_MAX),
                        ("MAX_Q", ssd_scan.MAX_CHUNK)):
        assert f"constexpr int {name} = {value};" in src, name
    assert "return Q * N * 2 + hb * Q * (P * 2 + 20);" in src
    assert ssd_scan.smem_bytes(128, 256, 3) == 256 * 128 * 2 + 3 * 256 * 148
    for hb in (1, 2, 3):
        assert f"case {hb}: return launch_bf16<P, N, {hb}>" in src
    assert "launch_bf16<P, N, 4>" not in src


@pytest.mark.parametrize("H,G", [(24, 1), (8, 2), (16, 2), (8, 8), (12, 3),
                                 (48, 1), (128, 8), (6, 1), (7, 1)])
@pytest.mark.parametrize("B,S,N,Q", [(8, 1024, 128, 256), (2, 512, 64, 256),
                                     (2, 256, 16, 64), (1, 16, 128, 16)])
def test_head_group_plan_never_spans_two_groups(H, G, B, S, N, Q):
    hb = ssd_scan.head_group_plan(B, S, H, G, N, Q)
    assert 1 <= hb <= ssd_scan.MAX_HEADS_PER_BLOCK
    assert (H // G) % hb == 0
    assert ssd_scan.smem_bytes(N, Q, hb) <= ssd_scan.SMEM_MAX
    rep = H // G
    for h0 in range(0, H, hb):
        assert len({h // rep for h in range(h0, h0 + hb)}) == 1


def test_head_group_plan_at_mamba2_prefill():
    """mamba2-130m's prefill (8 × 1024 steps, 24 heads on one B/C group,
    N 128, chunk 256): 3 heads a block, 256 blocks in two waves of an
    H100, where one block per (chunk, head) made 768 in six."""
    cfg = get_config("mamba2_130m")
    hb = ssd_scan.head_group_plan(8, 1024, cfg.ssm_heads, cfg.ssm_groups,
                                  cfg.ssm_state, cfg.ssm_chunk, sms=132)
    assert hb == 3
    assert 8 * (1024 // cfg.ssm_chunk) * cfg.ssm_heads // hb == 256
    assert ssd_scan.smem_bytes(cfg.ssm_state, cfg.ssm_chunk, hb) == 179200


def test_head_group_plan_at_jamba_prefill():
    """jamba-v0.1-52b's prefill (8 × 1024 steps, 128 heads on one B/C
    group, N 16, chunk 256): a block's heads divide the 128 of the group,
    so 3 is out; 2 heads a block, 2048 blocks in 15.5 waves of an H100,
    where one head a block made 4096 in 31.0."""
    cfg = get_config("jamba_v0_1_52b")
    assert (cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state) == (128, 1, 16)
    hb = ssd_scan.head_group_plan(8, 1024, cfg.ssm_heads, cfg.ssm_groups,
                                  cfg.ssm_state, cfg.ssm_chunk, sms=132)
    assert hb == 2
    assert 8 * (1024 // cfg.ssm_chunk) * cfg.ssm_heads // hb == 2048


@pytest.mark.parametrize("shape,hb", [
    ((2, 512, 8, 2, 64, 256), 1), ((3, 256, 12, 2, 16, 64), 2),
    ((3, 1024, 12, 2, 128, 256), 2), ((3, 1024, 6, 2, 16, 64), 3)])
def test_the_gpu_corners_reach_every_heads_per_block(shape, hb):
    """``chip_smoke.py``'s SSD corners (B, S, H, G, N, Q) take each number
    of heads per block with G > 1, so every template the kernel builds is
    run on the card, and the plan never asks for shared memory past an
    H100's: at the built widths (P 64, N <= 128, Q <= 256) the largest,
    3 heads at N 128 and Q 256, fits; a wider head would not."""
    assert ssd_scan.head_group_plan(*shape, sms=132) == hb
    assert ssd_scan.smem_bytes(128, 256, 3) <= ssd_scan.SMEM_MAX
    assert ssd_scan.smem_bytes(128, 256, 3, P=128) > ssd_scan.SMEM_MAX


def test_y_leaves_in_16_byte_rows():
    """The bf16 kernel stores y four floats at a time: the wrapper's y is
    contiguous with P = 64, so every (step, head) row starts on 16 bytes."""
    y = torch.empty((8, 1024, 24, 64), dtype=torch.float32)
    assert all(s % 4 == 0 for s in y.stride()[:3])
    assert ssd_scan.HEAD_DIMS == (64,)
