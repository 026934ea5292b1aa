"""Training: ``repro_torch``'s loss, gradients, AdamW, gradient
compression and train step against ``repro``'s.

The same seeded parameters (drawn by the JAX package, carried with
``repro_torch.convert``) and batches go through both packages in float32
at smoke size, on ``device="cpu"``.  Limits: loss 1e-5 relative; each
gradient leaf 1e-4 of its largest magnitude; one AdamW update 1e-6 (of
the leaf's scale); three train steps 1e-5 (on 99 % of the elements: see
``STEP_OUTLIER_SHARE``); int8 payloads and scales byte-identical.  On CPU tensors the kernel paths (``attention_impl="cuda"``,
``moe_impl="gmm"``, ``ssm_impl="cuda"``) run the kernels' plain versions
through the same ``torch.autograd.Function`` as the card
(``repro_torch.kernels.grad.PlainGradient``); their gradients must equal
direct autograd of the plain versions bit for bit.
"""
from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import requires_grad_through_barrier

import repro.models.lm as ref_lm
import repro.parallel.compress as ref_compress
import repro.train as ref_train
from repro.configs import get_config as ref_config
from repro.data.pipeline import DataConfig, HostDataLoader
from repro.models import Model as RefModel, smoke_variant as ref_smoke
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import (
    lm_params_from_numpy,
    lm_params_to_numpy,
    train_state_from_numpy,
)
from repro_torch.kernels import flash_attention, moe_gmm, ops, ssd_scan
from repro_torch.models import Model, lm, smoke_variant
from repro_torch.parallel import compress
from repro_torch.train import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_state,
    make_schedule,
    make_train_step,
)
from repro_torch.train.optimizer import _decay_mask

ARCHS = ("granite_moe_1b_a400m", "mamba2_130m", "glm4_9b")
KERNEL_PATHS = dict(attention_impl="cuda", moe_impl="gmm", ssm_impl="cuda")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def np_batch(vocab: int, seed: int = 0, batch: int = 2, seq: int = 16):
    """Next-token batch whose last label is ignored (-1)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


def ref_setup(arch: str, seed: int = 0, seq: int = 16):
    """The JAX package's smoke config, parameters (numpy) and a batch."""
    cfg = ref_smoke(ref_config(arch))
    params = jax.jit(RefModel(cfg).init)(jax.random.key(seed))
    return cfg, jax.tree.map(np.asarray, params), np_batch(cfg.vocab, seed,
                                                           seq=seq)


def port_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def leaf_errors(got: list, want: list) -> list[float]:
    """Per leaf: largest difference over the reference leaf's largest
    magnitude."""
    return [float(np.abs(np.asarray(g) - np.asarray(w)).max()
                  / max(np.abs(np.asarray(w)).max(), 1e-30))
            for g, w in zip(got, want, strict=True)]


# -- loss and gradients against jax.grad --------------------------------------

@requires_grad_through_barrier
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    rcfg, params, batch = ref_setup(arch)
    (ref_loss, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_lm.loss_fn(p, rcfg, b), has_aux=True))(
        params, batch)
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref_grads))
    smoke = smoke_variant(get_config(arch))
    # The reference's plain forms, then the kernel paths under remat.
    for cfg in (smoke, replace(smoke, remat=True, **KERNEL_PATHS)):
        port = lm_params_from_numpy(params, cfg, "cpu")
        leaves = [p.requires_grad_() for p in tree.leaves(port)]
        loss, metrics = lm.loss_fn(port, cfg, port_batch(batch))
        grads = torch.autograd.grad(loss, leaves)
        assert float(loss.detach()) == pytest.approx(float(ref_loss),
                                                     rel=LOSS_RTOL)
        for k, v in ref_metrics.items():
            assert float(metrics[k].detach()) == pytest.approx(
                float(v), rel=LOSS_RTOL, abs=1e-7), k
        errs = leaf_errors([g.numpy() for g in grads], want)
        assert max(errs) <= GRAD_TOL, (cfg.attention_impl, errs)


def test_remat_changes_nothing():
    """Per-block checkpointing recomputes the same values: the loss and
    every gradient leaf equal those without it, bit for bit."""
    cfg = replace(smoke_variant(get_config("granite_moe_1b_a400m")),
                  **KERNEL_PATHS)
    batch = port_batch(np_batch(cfg.vocab, seq=8))
    params = Model(cfg).init(device="cpu")
    out = []
    for remat in (False, True):
        leaves = [p.detach().clone().requires_grad_()
                  for p in tree.leaves(params)]
        loss, _ = lm.loss_fn(tree.unflatten(params, leaves),
                             replace(cfg, remat=remat), batch)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_cross_entropy_matches_jax_on_masked_bf16_logits():
    """bf16 logits with padded columns masked to -1e30 (``head_logits``)
    and labels below 0 ignored."""
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 4, (2, 5, 256)).astype(np.float32)
    logits[..., 250:] = -1e30
    labels = rng.integers(0, 250, (2, 5)).astype(np.int32)
    got = lm.cross_entropy(torch.from_numpy(logits).bfloat16(),
                           torch.from_numpy(labels))
    want = ref_lm.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                                jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert bool(torch.isfinite(got).all())


# -- the kernel wrappers' gradients -------------------------------------------

def _flash(gen):
    q = torch.randn(2, 24, 4, 16, generator=gen)
    k, v = (torch.randn(2, 24, 2, 16, generator=gen) for _ in range(2))
    return ((q, k, v), lambda *t: flash_attention.flash_attention(*t),
            lambda *t: flash_attention.flash_attention_torch(*t))


def _gmm(gen):
    xs = torch.randn(13, 8, generator=gen)
    w = torch.randn(4, 8, 6, generator=gen)
    sizes = torch.tensor([5, 0, 7, 1])
    return ((xs, w, sizes), moe_gmm.grouped_matmul,
            moe_gmm.grouped_matmul_torch)


def _ssd(gen):
    x = torch.randn(2, 32, 4, 8, generator=gen)
    dt = torch.rand(2, 32, 4, generator=gen)
    A = -torch.rand(4, generator=gen)
    Bm, Cm = (torch.randn(2, 32, 2, 16, generator=gen) for _ in range(2))
    return ((x, dt, A, Bm, Cm), lambda *t: ssd_scan.ssd_intra_chunk(*t, 16),
            lambda *t: ssd_scan.ssd_intra_chunk_torch(*t, 16))


@pytest.mark.parametrize("case", [_flash, _gmm, _ssd],
                         ids=["flash_attention", "moe_gmm", "ssd_scan"])
def test_wrapper_gradient_is_the_plain_versions_bit_for_bit(case):
    gen = torch.Generator().manual_seed(0)
    inputs, wrapper, plain = case(gen)
    runs = []
    for fn in (wrapper, plain):
        args = [t.clone().requires_grad_(t.is_floating_point())
                for t in inputs]
        outs = fn(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        weights = [torch.randn(o.shape, generator=torch.Generator()
                               .manual_seed(i)) for i, o in enumerate(outs)]
        loss = sum((o * w).sum() for o, w in zip(outs, weights))
        runs.append((outs, torch.autograd.grad(
            loss, [a for a in args if a.requires_grad])))
    (got_out, got), (want_out, want) = runs
    assert got_out[0].grad_fn.name() == "PlainGradientBackward"
    assert all(torch.equal(a, b) for a, b in zip(got_out, want_out))
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_a_parameter_cut_off_from_the_loss_raises(monkeypatch):
    """An attention output without a gradient (what the kernels gave before
    they were differentiable) leaves wq/wk/wv without one: the train step
    raises instead of training another function."""
    cfg = replace(smoke_variant(get_config("glm4_9b")), **KERNEL_PATHS)
    model = Model(cfg)
    state = init_state(model, torch.Generator().manual_seed(0),
                       AdamWConfig(), device="cpu")
    step = make_train_step(model, AdamWConfig())
    batch = port_batch(np_batch(cfg.vocab, seq=8))
    step(state, batch)
    flash = ops.mha_flash
    monkeypatch.setattr(ops, "mha_flash",
                        lambda *a, **kw: flash(*a, **kw).detach())
    with pytest.raises(RuntimeError, match="not have been used"):
        step(state, batch)


# -- AdamW, schedule, clip, decay mask ----------------------------------------

def _sched_pair(**kw):
    return (make_schedule(AdamWConfig(**kw)),
            ref_train.make_schedule(ref_train.AdamWConfig(**kw)))


@pytest.mark.parametrize("kw", [
    dict(schedule="cosine", warmup_steps=10, total_steps=100),
    dict(schedule="linear", warmup_steps=3, total_steps=40, lr=1e-3),
    dict(schedule="constant", warmup_steps=0),
])
def test_schedule_matches_jax(kw):
    got, want = _sched_pair(**kw)
    for s in (0, 1, 2, 3, 7, 10, 11, 50, 99, 100, 150):
        assert float(got(torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(float(want(jnp.asarray(s, jnp.int32))), rel=1e-6,
                          abs=1e-12), s


def test_clip_and_norm_match_jax():
    rng = np.random.default_rng(1)
    grads = {"a": rng.normal(0, 3, (4, 5)).astype(np.float32),
             "b": {"c": rng.normal(0, 1, (7,)).astype(np.float32)}}
    got, gnorm = clip_by_global_norm(tree.map(torch.from_numpy, grads), 1.0)
    want, wnorm = ref_train.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads), 1.0)
    assert float(gnorm) == pytest.approx(float(wnorm), rel=1e-6)
    assert float(global_norm(got)) == pytest.approx(1.0, rel=1e-6)
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_decay_mask_follows_the_reference_names():
    from repro.train.optimizer import _decay_mask as ref_mask

    model = RefModel(ref_smoke(ref_config("jamba_v0_1_52b")))
    want = [ref_mask(path, leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(model.abstract_params())[0]]
    def meta(shapes):
        return {k: meta(v) if isinstance(v, dict)
                else torch.empty(v, device="meta") for k, v in shapes.items()}
    port = meta(lm.param_shapes(smoke_variant(get_config("jamba_v0_1_52b"))))
    got = [_decay_mask(path, leaf)
           for path, leaf in tree.leaves_with_path(port)]
    assert got == want
    assert True in got and False in got


def test_one_adamw_update_matches_jax():
    """One update of seeded granite-moe parameters by JAX's own gradient,
    with non-zero moments and a mid-schedule step."""
    cfg = smoke_variant(get_config("granite_moe_1b_a400m"))
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda p: rng.normal(0, 0.02, p.shape).astype(
        np.float32), RefModel(ref_smoke(ref_config(
            "granite_moe_1b_a400m"))).abstract_params())
    grads = jax.tree.map(lambda p: rng.normal(0, 0.3, p.shape).astype(
        np.float32), params)
    m = jax.tree.map(lambda p: rng.normal(0, 0.01, p.shape).astype(
        np.float32), params)
    v = jax.tree.map(lambda p: rng.uniform(0, 1e-3, p.shape).astype(
        np.float32), params)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=20, grad_clip=5.0)
    ref_state = ref_train.AdamWState(m=m, v=v, step=np.int32(6))
    want_p, want_s, want_m = jax.jit(lambda *t: ref_train.adamw_update(
        *t, ref_train.AdamWConfig(**opt)))(grads, ref_state, params)
    state = train_state_from_numpy({"params": params, "opt": ref_state}, cfg,
                                   "cpu")
    got_p, got_s, got_m = adamw_update(
        lm_params_from_numpy(grads, cfg, "cpu"), state["opt"],
        state["params"], AdamWConfig(**opt))
    assert int(got_s.step) == int(want_s.step) == 7
    for k in ("grad_norm", "lr"):
        assert float(got_m[k]) == pytest.approx(float(want_m[k]), rel=1e-6)
    for got, want in ((got_p, want_p), (got_s.m, want_s.m),
                      (got_s.v, want_s.v)):
        errs = leaf_errors(tree.leaves(lm_params_to_numpy(got)),
                           jax.tree.leaves(want))
        assert max(errs) <= 1e-6, errs


def test_adamw_decays_weights_not_norms():
    params = {"w": torch.ones((3, 3)), "norm_scale": torch.ones((3,))}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0,
                      schedule="constant", grad_clip=1e9)
    new, _, _ = adamw_update(tree.map(torch.zeros_like, params),
                             adamw_init(params), params, cfg)
    assert float(new["w"][0, 0]) < 1.0
    assert float(new["norm_scale"][0]) == 1.0


# -- int8 compression with error feedback -------------------------------------

@pytest.mark.parametrize("shape,scale", [((1000,), 2.0), ((3, 256), 1e-3),
                                         ((5, 7, 11), 50.0), ((1,), 1.0)])
def test_quantize_is_byte_identical_to_jax(shape, scale):
    x = np.random.default_rng(0).normal(0, scale, shape).astype(np.float32)
    x.reshape(-1)[: min(x.size, 3)] = 0.0      # an all-zero start of block
    got = compress.quantize(torch.from_numpy(x))
    want = ref_compress.quantize(jnp.asarray(x))
    assert got.size == want.size
    assert got.q.numpy().tobytes() == np.asarray(want.q).tobytes()
    assert got.scale.numpy().tobytes() == np.asarray(want.scale).tobytes()
    deq = compress.dequantize(got, shape).numpy()
    assert deq.tobytes() == np.asarray(
        ref_compress.dequantize(want, shape)).tobytes()


def test_round_half_to_even_as_jax():
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, 64.5] + [0.0] * 248,
                 np.float32)
    got = compress.quantize(torch.from_numpy(x)).q.numpy()
    assert got.tobytes() == np.asarray(
        ref_compress.quantize(jnp.asarray(x)).q).tobytes()


def test_ef_compress_is_byte_identical_to_jax_over_steps():
    rng = np.random.default_rng(2)
    grads = {"w": rng.normal(0, 1, (300,)).astype(np.float32),
             "b": {"c": rng.normal(0, 1e-2, (4, 70)).astype(np.float32)}}
    got_r = compress.ef_init(tree.map(torch.from_numpy, grads))
    want_r = ref_compress.ef_init(jax.tree.map(jnp.asarray, grads))
    for _ in range(4):
        got_d, got_r = compress.ef_compress(tree.map(torch.from_numpy, grads),
                                            got_r)
        want_d, want_r = ref_compress.ef_compress(
            jax.tree.map(jnp.asarray, grads), want_r)
        for g, w in zip(tree.leaves(got_d) + tree.leaves(got_r),
                        jax.tree.leaves(want_d) + jax.tree.leaves(want_r)):
            assert g.numpy().tobytes() == np.asarray(w).tobytes()


def test_quantize_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 2, (1000,))
                         .astype(np.float32))
    qt = compress.quantize(x)
    deq = compress.dequantize(qt, x.shape)
    assert float((x - deq).abs().max()) <= float(qt.scale.max()) / 2 + 1e-6
    assert qt.q.dtype == torch.int8
    assert torch.equal(compress.quantization_error(x), x - deq)


def test_error_feedback_reduces_bias():
    g_true = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (512,))
                              .astype(np.float32))
    grads = {"w": g_true}
    residual = compress.ef_init(grads)
    acc = torch.zeros_like(g_true)
    for _ in range(20):
        deq, residual = compress.ef_compress(grads, residual)
        acc = acc + deq["w"]
    err = float((acc - 20 * g_true).abs().max())
    assert err <= 2 * float(compress.quantize(g_true).scale.max())


# -- the train step -----------------------------------------------------------

#: Three steps of both packages drift apart elementwise only where the
#: step is discontinuous or ill-conditioned: a corrected gradient within
#: rounding of a half quantum rounds to the neighbouring int8 value in the
#: other package (one quantum moves the applied gradient, m, v and the
#: residual), and AdamW's ``m / (sqrt(v) + eps)`` magnifies a near-zero
#: gradient's relative error.  On the smoke models 0-475 of ~74 000
#: elements of a tree lie beyond 1e-5 of their leaf's scale after three
#: steps; the rest must lie within it.
STEP_TOL = 1e-5
STEP_OUTLIER_SHARE = 0.01


def step_outliers(got, want, scale_factor: float = 1.0) -> tuple[int, int]:
    """``(elements beyond STEP_TOL of their leaf's scale, elements)``; the
    scale is ``scale_factor`` × the reference leaf's largest magnitude."""
    off = total = 0
    for g, w in zip(tree.leaves(lm_params_to_numpy(got)),
                    jax.tree.leaves(jax.tree.map(np.asarray, want)),
                    strict=True):
        scale = scale_factor * max(float(np.abs(w).max()), 1e-30)
        off += int((np.abs(g - w) > STEP_TOL * scale).sum())
        total += w.size
    return off, total


@requires_grad_through_barrier
def test_three_accumulated_compressed_steps_match_jax():
    """``accum=2, compress=True`` from one state on one batch stream: after
    each step the metrics agree to 1e-5 relative, and params, both moments
    and the error-feedback residual to 1e-5 of each leaf's scale on all
    but ``STEP_OUTLIER_SHARE`` of their elements.  A residual is at most
    half a quantum of its block, 1/254 of the block's largest gradient, so
    it is measured on that gradient's scale (127 × its own largest)."""
    arch = "mamba2_130m"
    rcfg = ref_smoke(ref_config(arch))
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    ref_model = RefModel(rcfg)
    ref_state = jax.jit(lambda key: ref_train.init_state(
        ref_model, key, ref_train.AdamWConfig(**opt_kw), compress=True))(
        jax.random.key(0))
    cfg = smoke_variant(get_config(arch))
    state = train_state_from_numpy(jax.tree.map(np.asarray, ref_state), cfg,
                                   "cpu")
    ref_step = jax.jit(ref_train.make_train_step(
        ref_model, ref_train.AdamWConfig(**opt_kw), accum=2, compress=True))
    step = make_train_step(Model(cfg), AdamWConfig(**opt_kw), accum=2,
                           compress=True)
    loader = HostDataLoader(DataConfig(vocab=cfg.vocab, seq_len=16,
                                       batch_per_host=4), 0, 1)
    for i in range(3):
        batch, _ = loader.batch_at(i)
        ref_state, want_m = ref_step(ref_state,
                                     jax.tree.map(jnp.asarray, batch))
        state, got_m = step(state, port_batch(batch))
        for k, v in want_m.items():
            assert float(got_m[k]) == pytest.approx(float(v), rel=STEP_TOL,
                                                    abs=1e-8), (i, k)
        assert int(state["opt"].step) == int(ref_state["opt"].step) == i + 1
        for name, got, want, factor in (
                ("params", state["params"], ref_state["params"], 1.0),
                ("m", state["opt"].m, ref_state["opt"].m, 1.0),
                ("v", state["opt"].v, ref_state["opt"].v, 1.0),
                ("ef", state["ef"], ref_state["ef"], 127.0)):
            off, total = step_outliers(got, want, factor)
            assert off <= STEP_OUTLIER_SHARE * total, (i, name, off, total)


def test_accumulated_step_matches_the_full_batch():
    """The reference's ``test_accum_matches_full_batch`` on the port."""
    cfg = smoke_variant(get_config("mamba2_130m"))
    model = Model(cfg)
    opt = AdamWConfig(lr=1e-3)
    batch, _ = HostDataLoader(DataConfig(vocab=cfg.vocab, seq_len=16,
                                         batch_per_host=4), 0, 1).batch_at(0)
    outs = []
    for accum in (1, 2):
        state = init_state(model, torch.Generator().manual_seed(0), opt,
                           device="cpu")
        outs.append(make_train_step(model, opt, accum=accum)(
            state, port_batch(batch)))
    (full, m_full), (micro, m_micro) = outs
    assert float(m_full["loss"]) == pytest.approx(float(m_micro["loss"]),
                                                  rel=1e-5)
    for a, b in zip(tree.leaves(full["params"]),
                    tree.leaves(micro["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_compressed_train_step_converges():
    cfg = smoke_variant(get_config("mamba2_130m"))
    model = Model(cfg)
    opt = AdamWConfig(lr=1e-3, total_steps=10)
    state = init_state(model, torch.Generator().manual_seed(0), opt,
                       compress=True, device="cpu")
    step = make_train_step(model, opt, compress=True)
    batch, _ = HostDataLoader(DataConfig(vocab=cfg.vocab, seq_len=16,
                                         batch_per_host=2), 0, 1).batch_at(0)
    losses = []
    for _ in range(6):
        state, m = step(state, port_batch(batch))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """A 64-step chunk whose decay spans exp(±256): above the diagonal
    ``seg_i - seg_j`` overflows float32.  The reference selects the decay
    after the exponent, so its gradient in dt is NaN (0 · inf); the port
    masks before it: the same forward values, a finite gradient."""
    from repro.models.ssd import ssd_chunked as ref_chunked
    from repro_torch.models.ssd import ssd_chunked

    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 64, 2, 4)).astype(np.float32)
    dt = np.full((1, 64, 2), 0.5, np.float32)
    A = np.array([-4.0, -8.0], np.float32)
    Bm, Cm = (rng.normal(size=(1, 64, 1, 8)).astype(np.float32)
              for _ in range(2))

    def ref(d):
        return ref_chunked(jnp.asarray(x), d, jnp.asarray(A),
                           jnp.asarray(Bm), jnp.asarray(Cm), 64)[0]
    assert not bool(jnp.isfinite(jax.grad(lambda d: ref(d).sum())(
        jnp.asarray(dt))).all())
    want = np.asarray(ref(jnp.asarray(dt)))
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    for fn in (lambda *t: ssd_chunked(*t, 64)[0],
               lambda *t: ops.ssd_chunked_cuda(*t, 64)[0]):
        d = args[1].clone().requires_grad_()
        y = fn(args[0], d, *args[2:])
        np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        (g,) = torch.autograd.grad(y.sum(), d)
        assert bool(torch.isfinite(g).all())
