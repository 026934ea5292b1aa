"""The encoder-decoder model (seamless-m4t-medium at smoke size: 2 + 2
layers, d 64, 4 heads over 4 kv heads, head_dim 16) against the JAX
package on the same parameters.

The JAX model's parameters are carried to the port with
``lm_params_from_numpy``; the batch is the reference's own ``TestEncDec``
batch (``tests/test_arch_smoke.py:make_batch``: 2 × 32 decoder tokens,
8 frame embeddings).  float32, ``attention_impl="dense"`` on both sides.
Limits: logits 1e-5 of their largest magnitude (forward, decode from an
empty cache, prefill then decode); the loss 1e-5 relative and every
gradient leaf 1e-4 relative RMS against ``jax.grad``.  The port's default
``"cuda"`` (on CPU tensors the kernels' plain versions) is held to its
``"dense"`` form to the same limits.
"""
from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import requires_grad_through_barrier

import repro.ckpt as ref_ckpt
import repro.train as ref_train
from repro.configs import get_config as ref_config
from repro.models import Model as RefModel, smoke_variant as ref_smoke
from repro_torch import tree
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.ft import Supervisor
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.launch import train as launch_train
from repro_torch.models import Model, encdec, smoke_variant
from repro_torch.train import (
    AdamWConfig,
    abstract_state,
    init_state,
    make_train_step,
)

ARCH = "seamless_m4t_medium"
B, S = 2, 32
LOGIT_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_REL_RMS = 1e-4
MAX_LEN = 16


def rel(got, want) -> float:
    """Largest difference over the reference's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def np_batch(cfg, seed: int = 0) -> dict:
    """``tests/test_arch_smoke.py:make_batch`` for an enc-dec config."""
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "enc_embeds": rng.normal(0, 1, (B, S // 4, cfg.d_model)).astype(
            np.float32),
    }


def port_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def carried():
    """(ref cfg, ref model, jax params, port cfg, port params, np batch)."""
    rcfg = ref_smoke(ref_config(ARCH))
    model = RefModel(rcfg)
    np_params = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.key(0)))
    # Norm scales off 1, so that they count.
    rng = np.random.default_rng(1)
    for blocks in ("enc_blocks", "dec_blocks"):
        for slot in np_params[blocks].values():
            slot["norm_scale"] = (slot["norm_scale"] + rng.normal(
                0, 0.1, slot["norm_scale"].shape)).astype(np.float32)
    cfg = smoke_variant(get_config(ARCH))
    params = lm_params_from_numpy(np_params, cfg, "cpu")
    return (rcfg, model, jax.tree.map(jnp.asarray, np_params), cfg, params,
            np_batch(rcfg))


def _ref_steps(model, params, batch):
    """The reference's ``TestEncDec`` decode: 8 steps from an empty cache."""
    cache = model.init_cache(params, batch, max_len=MAX_LEN)
    decode = jax.jit(model.decode)
    out = []
    for i in range(8):
        logits, cache = decode(params, batch["tokens"][:, i:i + 1], cache)
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out, axis=1)


def _port_steps(cfg, params, batch):
    model = Model(cfg)
    cache = model.init_cache(params, batch, MAX_LEN)
    out = []
    for i in range(8):
        logits, cache = model.decode(params, batch["tokens"][:, i:i + 1],
                                     cache)
        out.append(logits[:, 0].numpy())
    return np.stack(out, axis=1)


def _ref_prefill_decode(model, params, batch, n: int = 4):
    cache = model.init_cache(params, batch, max_len=S + n + 1)
    prompt = {"tokens": batch["tokens"][:, :S - n]}
    logits, cache = jax.jit(model.prefill)(params, prompt, cache)
    out = [np.asarray(logits[:, 0])]
    for i in range(S - n, S):
        logits, cache = jax.jit(model.decode)(
            params, batch["tokens"][:, i:i + 1], cache)
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out, axis=1)


def _port_prefill_decode(cfg, params, batch, n: int = 4):
    model = Model(cfg)
    cache = model.init_cache(params, batch, S + n + 1)
    logits, cache = model.prefill(
        params, {"tokens": batch["tokens"][:, :S - n]}, cache)
    out = [logits[:, 0].numpy()]
    for i in range(S - n, S):
        logits, cache = model.decode(params, batch["tokens"][:, i:i + 1],
                                     cache)
        out.append(logits[:, 0].numpy())
    return np.stack(out, axis=1)


@pytest.fixture(scope="module")
def ref_runs(carried):
    rcfg, model, params, _, _, batch = carried
    jb = jax.tree.map(jnp.asarray, batch)
    forward = np.asarray(jax.jit(model.forward)(params, jb)[0])
    return {"forward": forward, "steps": _ref_steps(model, params, jb),
            "prefill_decode": _ref_prefill_decode(model, params, jb)}


IMPLS = ("dense", "blocked", "cuda")


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(carried, ref_runs, impl):
    _, _, _, cfg, params, batch = carried
    logits, aux = Model(replace(cfg, attention_impl=impl)).forward(
        params, port_batch(batch))
    assert logits.shape == (B, S, cfg.vocab_padded)
    assert rel(logits.numpy(), ref_runs["forward"]) <= LOGIT_RTOL
    assert float(aux.load_balance_loss) == 0.0
    assert aux.expert_load.shape == (1,)


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_from_an_empty_cache_matches_jax(carried, ref_runs, impl):
    """The reference's ``TestEncDec``: each step's logits against the JAX
    model's steps (and, as there, against the forward's positions)."""
    _, _, _, cfg, params, batch = carried
    got = _port_steps(replace(cfg, attention_impl=impl), params,
                      port_batch(batch))
    assert rel(got, ref_runs["steps"]) <= LOGIT_RTOL
    assert rel(got, ref_runs["forward"][:, :8]) <= LOGIT_RTOL


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_then_decode_matches_jax(carried, ref_runs, impl):
    _, _, _, cfg, params, batch = carried
    got = _port_prefill_decode(replace(cfg, attention_impl=impl), params,
                               port_batch(batch))
    assert rel(got, ref_runs["prefill_decode"]) <= LOGIT_RTOL


def test_cuda_form_launches_nothing_on_the_cpu(carried):
    """On CPU tensors the kernel path takes the plain versions: no launch
    is counted, and the values are the dense form's."""
    _, _, _, cfg, params, batch = carried
    before = flash_attention.LAUNCHES, decode_attention.LAUNCHES
    got = _port_prefill_decode(replace(cfg, attention_impl="cuda"), params,
                               port_batch(batch))
    want = _port_prefill_decode(cfg, params, port_batch(batch))
    assert (flash_attention.LAUNCHES, decode_attention.LAUNCHES) == before
    assert rel(got, want) <= LOGIT_RTOL


@requires_grad_through_barrier
@pytest.mark.parametrize("impl,remat", [("dense", False), ("cuda", True)])
def test_loss_and_gradients_match_jax(carried, impl, remat):
    rcfg, model, params, cfg, port, batch = carried
    (ref_loss, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(params, jax.tree.map(jnp.asarray, batch))
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref_grads))
    leaves = [p.detach().clone().requires_grad_() for p in tree.leaves(port)]
    loss, metrics = Model(replace(cfg, attention_impl=impl, remat=remat)).loss(
        tree.unflatten(port, leaves), port_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    assert sorted(metrics) == sorted(ref_metrics) == ["ce", "loss"]
    assert float(loss.detach()) == pytest.approx(float(ref_loss),
                                                 rel=LOSS_RTOL)
    errs = [rel_rms(g.numpy(), w) for g, w in zip(grads, want, strict=True)]
    assert max(errs) <= GRAD_REL_RMS, errs


def test_remat_changes_nothing(carried):
    """Per-layer checkpointing of the encoder and the decoder recomputes
    the same values: loss and gradients bit for bit."""
    _, _, _, cfg, params, batch = carried
    out = []
    for remat in (False, True):
        leaves = [p.detach().clone().requires_grad_()
                  for p in tree.leaves(params)]
        loss, _ = Model(replace(cfg, remat=remat)).loss(
            tree.unflatten(params, leaves), port_batch(batch))
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_params_and_cache_keep_the_reference_layout(carried):
    rcfg, model, params, cfg, port, batch = carried
    ref_paths = [tuple(str(k.key) for k in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [p for p, _ in tree.leaves_with_path(port)] == ref_paths
    fresh = Model(cfg).init(device="cpu")
    assert [tuple(t.shape) for t in tree.leaves(fresh)] == \
        [tuple(t.shape) for t in tree.leaves(port)]
    meta = Model(cfg).abstract_params()
    assert all(t.device.type == "meta" for t in tree.leaves(meta))
    assert [(tuple(t.shape), t.dtype) for t in tree.leaves(meta)] == \
        [(tuple(t.shape), t.dtype) for t in tree.leaves(port)]
    jb = jax.tree.map(jnp.asarray, batch)
    ref_cache = model.init_cache(params, jb, max_len=MAX_LEN)
    cache = Model(cfg).init_cache(port, port_batch(batch), MAX_LEN)
    for part in ("self", "cross"):
        for name in ("k", "v"):
            assert tuple(cache[part][name].shape) == \
                ref_cache[part][name].shape
    np.testing.assert_allclose(cache["cross"]["k"].numpy(),
                               np.asarray(ref_cache["cross"]["k"]),
                               rtol=1e-5, atol=1e-5)
    assert int(cache["cross_len"]) == S // 4 - 1


def test_full_cache_raises_instead_of_clamping(carried):
    _, _, _, cfg, params, batch = carried
    model = Model(cfg)
    pb = port_batch(batch)
    cache = model.init_cache(params, pb, 4)
    _, cache = model.prefill(params, {"tokens": pb["tokens"][:, :4]}, cache)
    with pytest.raises(IndexError):
        model.decode(params, pb["tokens"][:, 4:5], cache)
    with pytest.raises(ValueError):
        model.prefill(params, pb, model.init_cache(params, pb, S - 1))


def test_full_config_geometry():
    """seamless-m4t-medium at its published size: 12 + 12 layers of plain
    MHA at head_dim 64, about 0.98 B parameters with the untied head."""
    cfg = get_config(ARCH)
    model = Model(cfg)
    assert (cfg.enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.d_ff) == \
        (12, 12, 1024, 16, 16, 64, 4096)
    assert cfg.vocab_padded == 256256
    meta = model.abstract_params()
    n = sum(t.numel() for t in tree.leaves(meta))
    assert 0.95e9 < n < 1.0e9
    assert meta["head"].shape == (1024, 256256)
    ref = RefModel(ref_config(ARCH)).abstract_params()
    assert [(tuple(t.shape), t.dtype.itemsize) for t in tree.leaves(meta)] \
        == [(tuple(s.shape), s.dtype.itemsize) for s in jax.tree.leaves(ref)]


# -- training -----------------------------------------------------------------

def test_train_driver_runs_seamless_on_the_cpu():
    args = launch_train.build_argparser().parse_args([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "24",
        "--batch", "2", "--seq", "32", "--window", "8", "--anomaly", "none"])
    out = launch_train.run(args)
    assert out["steps"] == 24
    assert np.isfinite(out["final_loss"])
    assert out["loss_decreased"]


def _ref_state():
    model = RefModel(ref_smoke(ref_config(ARCH)))
    opt = ref_train.AdamWConfig()
    state = jax.jit(lambda k: ref_train.init_state(model, k, opt))(
        jax.random.key(0))
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(0)
    opt_state = ref_train.AdamWState(
        m=jax.tree.map(lambda p: rng.normal(0, 1, p.shape).astype(p.dtype),
                       state["opt"].m),
        v=jax.tree.map(lambda p: rng.uniform(0, 1, p.shape).astype(p.dtype),
                       state["opt"].v),
        step=np.int32(5))
    return {**state, "opt": opt_state}, model, opt


def test_checkpoints_restore_across_the_packages(tmp_path):
    """A train state written by either package restores in the other,
    leaf for leaf, byte for byte."""
    state, model, opt = _ref_state()
    cfg = smoke_variant(get_config(ARCH))
    ref_ckpt.CheckpointManager(str(tmp_path / "ref")).save(3, state)
    template = init_state(Model(cfg), torch.Generator().manual_seed(1),
                          AdamWConfig(), device="cpu")
    got = CheckpointManager(str(tmp_path / "ref")).restore(template,
                                                           device="cpu")
    want = train_state_from_numpy(state, cfg, "cpu")
    for g, w in zip(tree.leaves(got), tree.leaves(want), strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)

    CheckpointManager(str(tmp_path / "port")).save(4, want)
    back = ref_ckpt.CheckpointManager(str(tmp_path / "port")).restore(
        ref_train.abstract_state(model, opt))
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(state),
                    strict=True):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_abstract_state_matches_the_reference():
    cfg = smoke_variant(get_config(ARCH))
    got = abstract_state(Model(cfg), AdamWConfig(), compress=True)
    want = ref_train.abstract_state(RefModel(ref_smoke(ref_config(ARCH))),
                                    ref_train.AdamWConfig(), compress=True)
    assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for t in tree.leaves(got)] == \
        [(tuple(s.shape), str(s.dtype)) for s in jax.tree.leaves(want)]
    assert all(t.device.type == "meta" for t in tree.leaves(got))


def test_encdec_module_names_the_reference_keys():
    shapes = encdec.param_shapes(smoke_variant(get_config(ARCH)))
    assert sorted(shapes) == ["dec_blocks", "embed", "enc_blocks",
                              "enc_final_norm", "final_norm", "head"]
    assert sorted(shapes["dec_blocks"]) == ["cross_attn", "mlp", "self_attn"]
    assert sorted(shapes["enc_blocks"]) == ["attn", "mlp"]


def test_supervisor_restarts_an_encdec_run_from_its_checkpoint(
        carried, tmp_path):
    """A train step on the encdec tree, a checkpoint, a crash: the
    supervisor hands the next attempt the state it saved, leaf for leaf."""
    _, _, _, cfg, _, batch = carried
    model = Model(cfg)
    opt = AdamWConfig()
    state = init_state(model, torch.Generator().manual_seed(2), opt,
                       device="cpu")
    step = make_train_step(model, opt)
    mgr = CheckpointManager(str(tmp_path))
    saved, seen = [], []

    def body(start, restored):
        seen.append(restored)
        if restored is None:
            new, metrics = step(state, port_batch(batch))
            assert sorted(metrics)[:2] == ["ce", "grad_norm"]
            mgr.save(1, new)
            saved.append(new)
            raise RuntimeError("node lost")
        return restored

    sup = Supervisor(mgr, tree.map(torch.empty_like, state), device="cpu")
    final = sup.run(body)
    assert sup.restarts == 1 and seen[0] is None
    for g, w in zip(tree.leaves(final), tree.leaves(saved[0]), strict=True):
        assert torch.equal(g, w)
