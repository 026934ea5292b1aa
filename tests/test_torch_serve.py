"""The serving path — ``Model`` prefill / decode and ``ServeEngine`` —
against the JAX package on the same parameters, at the smoke size of
glm4-9b (2 layers, d 64, 4 heads over 1 kv head, head_dim 16, qkv bias) in
float32, and of the MoE, SSM and hybrid archs (granite-moe-1b-a400m,
mamba2-130m, jamba-v0.1-52b: attention, SSM, MLP and MoE in one period).

The JAX model's parameters (biases and norm scales perturbed, so that they
count) are handed to the port through ``lm_params_from_numpy``.  The
port's three attention forms are held against the JAX model's: ``dense``
and ``blocked`` against its own forms, and ``cuda`` — which on CPU tensors
takes the kernels' plain versions and launches nothing — against its
``dense`` form.  Logits agree to 1e-4 (sums in another order through two
layers); greedy tokens are equal.
"""
from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import BigRootsAnalyzer as RefAnalyzer
from repro.core import JAX_FEATURES as REF_FEATURES
from repro.models import Model as RefModel
from repro.models import smoke_variant as ref_smoke_variant
from repro.serve import Diagnosis as RefDiagnosis
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro.telemetry import ResourceTimeline as RefTimeline
from repro.telemetry import StepTelemetry as RefTelemetry

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import BigRootsAnalyzer, JAX_FEATURES, cause_to_wire
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.launch import serve as launch_serve
from repro_torch.models import Model, smoke_variant
from repro_torch.models.layers import attention_decode
from repro_torch.serve import Diagnosis, FleetAggregator
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.telemetry import ResourceTimeline, StepTelemetry

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT = 12
MAX_LEN = PROMPT + 8 + 8   # prompt + max_new + 8, as launch/serve.py sizes it
STEPS = 4


@pytest.fixture(scope="module")
def carried():
    """(ref cfg, ref model, jax params, port params) on the same values."""
    cfg = ref_smoke_variant(ref_get_config("glm4_9b"))
    model = RefModel(cfg)
    np_params = jax.tree.map(np.asarray, model.init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    for slot in np_params["blocks"].values():
        for name in list(slot):
            if name.startswith("b") or name == "norm_scale":
                slot[name] = (slot[name] + rng.normal(
                    0.0, 0.1, slot[name].shape)).astype(np.float32)
    port_cfg = smoke_variant(get_config("glm4_9b"))
    params = lm_params_from_numpy(np_params, port_cfg, device="cpu")
    return cfg, model, jax.tree.map(jnp.asarray, np_params), params


def _prompts(n: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (n, PROMPT)).astype(np.int32)


def _ref_logits(cfg, model, params, tokens):
    """Prefill + STEPS greedy decode steps on the JAX model."""
    batch = {"tokens": jnp.asarray(tokens)}
    cache = model.init_cache(params, batch, MAX_LEN)
    logits, cache = model.prefill(params, batch, cache)
    out, feed = [np.asarray(logits)], []
    for _ in range(STEPS):
        nxt = jnp.argmax(logits[:, 0, :], axis=-1).astype(jnp.int32)[:, None]
        feed.append(np.array(nxt))
        logits, cache = model.decode(params, nxt, cache)
        out.append(np.asarray(logits))
    return out, feed


@pytest.fixture(scope="module")
def ref_runs(carried):
    cfg, model, params, _ = carried
    tokens = _prompts(2)
    runs = {}
    for impl in ("dense", "blocked"):
        c = replace(cfg, attention_impl=impl)
        runs[impl] = _ref_logits(c, RefModel(c), params, tokens)
    return tokens, runs


@pytest.mark.parametrize("impl,ref_impl", [
    ("dense", "dense"), ("blocked", "blocked"), ("cuda", "dense")])
def test_prefill_and_decode_logits_match_jax(carried, ref_runs, impl,
                                             ref_impl):
    _, _, _, params = carried
    tokens, runs = ref_runs
    want, feed = runs[ref_impl]
    cfg = replace(smoke_variant(get_config("glm4_9b")), attention_impl=impl)
    model = Model(cfg)
    flash_attention.LAUNCHES = decode_attention.LAUNCHES = 0
    batch = {"tokens": torch.from_numpy(tokens)}
    cache = model.init_cache(params, batch, MAX_LEN)
    logits, cache = model.prefill(params, batch, cache)
    got = [logits.numpy()]
    for nxt in feed:   # teacher-forced with the JAX run's tokens
        logits, cache = model.decode(params, torch.from_numpy(nxt), cache)
        got.append(logits.numpy())
    assert int(cache["len"]) == cache["pos"] == PROMPT + STEPS
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **LOGIT_TOL,
                                   err_msg=f"step {step}")
    assert flash_attention.LAUNCHES == decode_attention.LAUNCHES == 0


def test_forward_matches_jax(carried):
    cfg, model, params, port_params = carried
    tokens = _prompts(2, seed=2)
    want, _ = model.forward(params, {"tokens": jnp.asarray(tokens)})
    got, aux = Model(smoke_variant(get_config("glm4_9b"))).forward(
        port_params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert float(aux.load_balance_loss) == 0.0


def test_greedy_tokens_match_jax_engine(carried):
    cfg, model, params, port_params = carried
    prompts = _prompts(2, seed=3)
    ref = RefEngine(model, params, max_len=MAX_LEN, batch_size=2)
    want = ref.run([RefRequest(f"r{i}", p, max_new_tokens=8)
                    for i, p in enumerate(prompts)])
    port_cfg = replace(smoke_variant(get_config("glm4_9b")),
                       attention_impl="cuda")
    eng = ServeEngine(Model(port_cfg), port_params, max_len=MAX_LEN,
                      batch_size=2, device="cpu")
    got = eng.run([Request(f"r{i}", p, max_new_tokens=8)
                   for i, p in enumerate(prompts)])
    assert [r.output for r in got] == [r.output for r in want]
    assert all(len(r.output) == 8 and r.done for r in got)


def test_sampling_is_seeded_and_in_vocab(carried):
    *_, port_params = carried
    cfg = smoke_variant(get_config("glm4_9b"))
    outs = []
    for _ in range(2):
        eng = ServeEngine(Model(cfg), port_params, max_len=MAX_LEN,
                          batch_size=2, temperature=0.8, device="cpu")
        reqs = eng.run([Request(f"r{i}", p, max_new_tokens=6)
                        for i, p in enumerate(_prompts(2, seed=4))])
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert all(0 <= t < cfg.vocab for out in outs[0] for t in out)


# ---------------------------------------------------------------------------
# telemetry and diagnosis wiring (as tests/test_tree.py holds the reference)
# ---------------------------------------------------------------------------
def _scripted(telemetry_cls, timeline_cls):
    """A host whose decode step 9 runs 20x long under a CPU hog: the same
    clock and resource samples for either package."""
    ticks = iter(range(10_000))
    now = [0.0]

    def clock():
        i = next(ticks)
        now[0] += 20.0 if 36 <= i < 40 else 1.0   # 4 clock reads per step
        return now[0]

    timeline = timeline_cls()
    for t in range(0, 200):
        timeline.record("host0", "cpu", float(t), 0.95 if 36 < t < 120 else 0.1)
    return telemetry_cls("host0", timeline=timeline, window=16,
                         streaming=True, clock=clock), timeline


def test_live_root_causes_match_jax_engine(carried):
    cfg, model, params, port_params = carried
    prompts = _prompts(2, seed=5)
    telem, tl = _scripted(RefTelemetry, RefTimeline)
    ref = RefEngine(model, params, max_len=MAX_LEN, batch_size=2,
                    telemetry=telem, diagnosis=RefDiagnosis.local(
                        RefAnalyzer(REF_FEATURES, timelines=tl)))
    ref.run([RefRequest(f"r{i}", p, max_new_tokens=14)
             for i, p in enumerate(prompts)])
    telem, tl = _scripted(StepTelemetry, ResourceTimeline)
    eng = ServeEngine(Model(smoke_variant(get_config("glm4_9b"))),
                      port_params, max_len=MAX_LEN + 8, batch_size=2,
                      telemetry=telem, device="cpu",
                      diagnosis=Diagnosis.local(BigRootsAnalyzer(
                          JAX_FEATURES, timelines=tl, device="cpu")))
    eng.run([Request(f"r{i}", p, max_new_tokens=14)
             for i, p in enumerate(prompts)])
    import repro.core as ref_core

    want = [ref_core.cause_to_wire(c) for c in ref.live_root_causes]
    got = [cause_to_wire(c) for c in eng.live_root_causes]
    assert got == want
    assert any(c["feature"] == "cpu" for c in got), got


def _engine(port_params, telem, **kw):
    return ServeEngine(Model(smoke_variant(get_config("glm4_9b"))),
                       port_params, telemetry=telem, device="cpu", **kw)


def test_removed_legacy_kwargs_raise_type_error(carried):
    *_, port_params = carried
    for kw in (
        {"live_analyzer": BigRootsAnalyzer(JAX_FEATURES, device="cpu")},
        {"fleet": FleetAggregator(JAX_FEATURES, device="cpu")},
        {"fleet_step": False},
        {"delta_sink": object()},
        {"policy": object()},
    ):
        with pytest.raises(TypeError):
            _engine(port_params, StepTelemetry("h0", wire=True), **kw)


def test_diagnosis_modes_bind_at_construction(carried):
    *_, port_params = carried
    eng = _engine(port_params, StepTelemetry("h0", window=8, streaming=True),
                  diagnosis=Diagnosis.local(
                      BigRootsAnalyzer(JAX_FEATURES, device="cpu")))
    assert eng.diagnosis.mode == "local"
    agg = FleetAggregator(JAX_FEATURES, device="cpu")
    eng = _engine(port_params, StepTelemetry("h0", wire=True),
                  diagnosis=Diagnosis.fleet(agg, drive=False))
    assert eng.diagnosis.aggregator is agg and eng.diagnosis.drive is False
    with pytest.raises(ValueError):   # local mode needs a streaming window
        _engine(port_params, StepTelemetry("h0"), diagnosis=Diagnosis.local(
            BigRootsAnalyzer(JAX_FEATURES, device="cpu")))


# ---------------------------------------------------------------------------
# the command line, weights and errors
# ---------------------------------------------------------------------------
def test_launch_serve_runs_on_the_cpu(capsys):
    launch_serve.main(["--arch", "glm4_9b", "--smoke", "--device", "cpu",
                       "--requests", "2", "--prompt-len", "8",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert "BigRoots serve report — glm4-9b-smoke" in out
    assert '"generated_tokens": 6' in out


def test_engine_casts_weights_once_and_keeps_norms(carried):
    *_, port_params = carried
    cfg = replace(smoke_variant(get_config("glm4_9b")), dtype="bfloat16")
    eng = ServeEngine(Model(cfg), port_params, device="cpu")
    blk = eng.params["blocks"]["L0_attn"]
    assert blk["wq"].dtype == blk["bq"].dtype == torch.bfloat16
    assert eng.params["embed"].dtype == torch.bfloat16
    assert blk["norm_scale"].dtype == eng.params["final_norm"].dtype \
        == torch.float32
    assert torch.equal(blk["wq"], port_params["blocks"]["L0_attn"]["wq"].to(
        torch.bfloat16))
    # a tensor already in the engine's dtype and place is not copied
    same = ServeEngine(Model(smoke_variant(get_config("glm4_9b"))),
                       port_params, device="cpu")
    assert same.params["embed"] is port_params["embed"]


def test_carried_params_keep_keys_shapes_and_dtypes(carried):
    cfg, model, params, port_params = carried
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat_ref) == 3 + sum(len(s) for s in
                                    port_params["blocks"].values())
    for path, leaf in flat_ref:
        node = port_params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).removeprefix("torch.") == str(leaf.dtype)
    bad = jax.tree.map(np.asarray, params)
    bad["blocks"]["L0_attn"]["wq"] = bad["blocks"]["L0_attn"]["wq"][:, :8]
    with pytest.raises(ValueError, match="wq"):
        lm_params_from_numpy(bad, smoke_variant(get_config("glm4_9b")),
                             device="cpu")


def test_full_cache_raises_instead_of_clamping(carried):
    *_, port_params = carried
    cfg = smoke_variant(get_config("glm4_9b"))
    model = Model(cfg)
    batch = {"tokens": torch.from_numpy(_prompts(2))}
    cache = model.init_cache(port_params, batch, PROMPT + 1)
    logits, cache = model.prefill(port_params, batch, cache)
    nxt = logits[:, :, :].argmax(-1).to(torch.int32)
    logits, cache = model.decode(port_params, nxt, cache)  # fills the cache
    with pytest.raises(IndexError):
        model.decode(port_params, nxt, cache)
    p = {k: v[0] for k, v in port_params["blocks"]["L0_attn"].items()}
    k_cache = torch.zeros(2, 4, 1, 16)
    x = torch.zeros(2, 1, 64)
    with pytest.raises(IndexError):
        attention_decode(p, x, cfg, k_cache, k_cache.clone(),
                         torch.tensor(4, dtype=torch.int32))
    with pytest.raises(ValueError):   # a prompt longer than the cache
        model.prefill(port_params, batch,
                      model.init_cache(port_params, batch, PROMPT - 1))


def test_pallas_name_reads_as_cuda_and_default_is_the_kernel():
    cfg = get_config("glm4_9b")
    assert cfg.attention_impl == "cuda"
    assert replace(cfg, attention_impl="pallas").attention_impl == "cuda"
    assert smoke_variant(cfg).attention_impl == "dense"
    with pytest.raises(ValueError):
        replace(cfg, attention_impl="flash").validate()
    # encoder-decoder configs are ported too (tests/test_torch_encdec.py)
    assert Model(get_config("seamless_m4t_medium")).is_encdec
    # MoE and SSM layers are ported: their kernel paths are the defaults
    assert (cfg.moe_impl, cfg.ssm_impl) == ("gmm", "cuda")
    params = Model(smoke_variant(get_config("mamba2_130m"))).init(device="cpu")
    assert params["blocks"]["L0_ssm"]["A_log"].dtype == torch.float32


def test_bf16_params_carry_bit_for_bit(carried):
    """bf16 arrays (ml_dtypes in numpy) carry as torch.bfloat16, unchanged."""
    cfg, model, params, _ = carried
    bf = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), params)
    got = lm_params_from_numpy(bf, smoke_variant(get_config("glm4_9b")),
                               device="cpu")
    wq = got["blocks"]["L0_attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    want = bf["blocks"]["L0_attn"]["wq"].astype(np.float32)
    np.testing.assert_array_equal(wq.float().numpy(), want)


# ---------------------------------------------------------------------------
# MoE, SSM and hybrid archs (the K5 / K4 paths' models) and the dense archs
# with qkv bias, rope_theta 1e6, tied embeddings or an odd vocabulary
# ---------------------------------------------------------------------------
NEW_ARCHS = ["granite_moe_1b_a400m", "mamba2_130m", "jamba_v0_1_52b",
             "olmoe_1b_7b", "codeqwen1_5_7b", "granite_8b", "granite_3_8b"]
#: the kernel entry points (plain versions on CPU tensors) and the
#: reference's plain forms
IMPLS = {"kernel": dict(attention_impl="cuda", moe_impl="gmm",
                        ssm_impl="cuda"),
         "plain": dict(attention_impl="dense", moe_impl="ragged",
                       ssm_impl="chunked")}
#: prompts of 16 tokens: a multiple of the smoke SSM chunk (8)
ARCH_PROMPT = 16
ARCH_MAX_LEN = ARCH_PROMPT + 8 + 8


@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch_run(request):
    """(arch, JAX model, jax params, numpy params, port params, JAX
    teacher-forced logits and fed tokens) for one arch's smoke variant;
    norm scales, SSD D and conv biases perturbed so that they count."""
    arch = request.param
    cfg = ref_smoke_variant(ref_get_config(arch))
    model = RefModel(cfg)
    np_params = jax.tree.map(np.asarray, model.init(jax.random.key(1)))
    rng = np.random.default_rng(1)
    for slot in np_params["blocks"].values():
        for name in list(slot):
            if name in ("norm_scale", "inner_norm", "D", "conv_x_b",
                        "conv_bc_b"):
                slot[name] = (slot[name] + rng.normal(
                    0.0, 0.1, slot[name].shape)).astype(np.float32)
    params = lm_params_from_numpy(np_params, smoke_variant(get_config(arch)),
                                  device="cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    tokens = np.random.default_rng(2).integers(
        0, 256, (2, ARCH_PROMPT)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    cache = model.init_cache(jparams, batch, ARCH_MAX_LEN)
    logits, cache = model.prefill(jparams, batch, cache)
    want, feed = [np.asarray(logits)], []
    for _ in range(STEPS):
        nxt = jnp.argmax(logits[:, 0, :], axis=-1).astype(jnp.int32)[:, None]
        feed.append(np.array(nxt))
        logits, cache = model.decode(jparams, nxt, cache)
        want.append(np.asarray(logits))
    return arch, model, jparams, np_params, params, tokens, want, feed


def _port_cfg(arch, impl):
    return replace(smoke_variant(get_config(arch)), **IMPLS[impl])


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_new_archs_prefill_and_decode_match_jax(arch_run, impl):
    arch, _, _, _, params, tokens, want, feed = arch_run
    model = Model(_port_cfg(arch, impl))
    batch = {"tokens": torch.from_numpy(tokens)}
    cache = model.init_cache(params, batch, ARCH_MAX_LEN)
    logits, cache = model.prefill(params, batch, cache)
    got = [logits.numpy()]
    for nxt in feed:
        logits, cache = model.decode(params, torch.from_numpy(nxt), cache)
        got.append(logits.numpy())
    assert cache["pos"] == ARCH_PROMPT + STEPS
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **LOGIT_TOL,
                                   err_msg=f"{arch} {impl} step {step}")


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_new_archs_forward_and_aux_match_jax(arch_run, impl):
    arch, model, jparams, _, params, tokens, _, _ = arch_run
    want, want_aux = model.forward(jparams, {"tokens": jnp.asarray(tokens)})
    got, aux = Model(_port_cfg(arch, impl)).forward(
        params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    for g, w in zip(aux, want_aux):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_new_archs_greedy_tokens_match_jax_engine(arch_run):
    arch, model, jparams, _, params, _, _, _ = arch_run
    prompts = np.random.default_rng(3).integers(
        0, 256, (2, ARCH_PROMPT)).astype(np.int32)
    want = RefEngine(model, jparams, max_len=ARCH_MAX_LEN, batch_size=2).run(
        [RefRequest(f"r{i}", p, max_new_tokens=8)
         for i, p in enumerate(prompts)])
    got = ServeEngine(Model(_port_cfg(arch, "kernel")), params,
                      max_len=ARCH_MAX_LEN, batch_size=2, device="cpu").run(
        [Request(f"r{i}", p, max_new_tokens=8)
         for i, p in enumerate(prompts)])
    assert [r.output for r in got] == [r.output for r in want]


def test_new_archs_params_carry_key_for_key(arch_run):
    arch, _, _, np_params, params, _, _, _ = arch_run
    flat = jax.tree_util.tree_flatten_with_path(np_params)[0]
    assert len(flat) == len(np_params) - 1 + sum(
        len(s) for s in params["blocks"].values())
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).removeprefix("torch.") == str(leaf.dtype)


def test_bf16_engine_keeps_the_float32_reads_float32(arch_run):
    """The reference reads A_log, dt_bias (models/ssd.py:227-228) and every
    norm scale, inner_norm included (models/layers.py:32), in float32."""
    arch, _, _, _, params, _, _, _ = arch_run
    cfg = replace(_port_cfg(arch, "kernel"), dtype="bfloat16")
    eng = ServeEngine(Model(cfg), params, device="cpu")
    for slot in eng.params["blocks"].values():
        for name, t in slot.items():
            keep = name in ("norm_scale", "inner_norm", "A_log", "dt_bias")
            assert t.dtype == (torch.float32 if keep else torch.bfloat16), \
                name
    assert torch.equal(eng.params["final_norm"], params["final_norm"])


def test_ssm_cache_has_no_length_limit():
    """Only attention slots bound a cache: an SSM-only model decodes past
    ``max_len``, as in the reference, and gives the same logits."""
    cfg = smoke_variant(get_config("mamba2_130m"))
    model = Model(cfg)
    params = model.init(device="cpu")
    batch = {"tokens": torch.from_numpy(_prompts(2)[:, :8])}
    runs = []
    for max_len in (4, 64):
        cache = model.init_cache(params, batch, max_len)
        logits, cache = model.prefill(params, batch, cache)
        out = [logits]
        for _ in range(6):
            logits, cache = model.decode(
                params, logits.argmax(-1).to(torch.int32), cache)
            out.append(logits)
        runs.append(torch.cat(out, dim=1))
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "mamba2_130m"])
def test_launch_serve_runs_new_archs_on_the_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "2", "--prompt-len", "8",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert f"BigRoots serve report — {get_config(arch).name}-smoke" in out
    assert '"generated_tokens": 6' in out


# ---------------------------------------------------------------------------
# the VLM prefix: precomputed patch embeddings before the text
# ---------------------------------------------------------------------------
VLM_TEXT = 32
VLM_RTOL = 1e-5


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_vlm_prefix_matches_jax(impl):
    """internvl2-26b at smoke size, in the setup of the reference's
    ``TestVLM`` (``tests/test_arch_smoke.py:163``): 8 patch embeddings
    before 32 text tokens.  The forward, and the prefill then one greedy
    decode step with the embeddings, against the JAX model on the same
    parameters (float32; largest difference 1e-5 of the largest
    logit)."""
    cfg = ref_smoke_variant(ref_get_config("internvl2_26b"))
    model = RefModel(cfg)
    np_params = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.key(0)))
    jparams = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, VLM_TEXT)).astype(np.int32)
    embeds = rng.normal(0, 1, (2, cfg.frontend_tokens, cfg.d_model)).astype(
        np.float32)
    jb = {"tokens": jnp.asarray(tokens), "embeds": jnp.asarray(embeds)}
    P = cfg.frontend_tokens
    want_full, _ = jax.jit(model.forward)(jparams, jb)
    cache = model.init_cache(jparams, jb, max_len=VLM_TEXT + P + 8)
    want_pf, cache = jax.jit(model.prefill)(jparams, jb, cache)
    nxt = jnp.argmax(want_pf[:, 0], -1).astype(jnp.int32)[:, None]
    want_dec, _ = jax.jit(model.decode)(jparams, nxt, cache)

    port_cfg = replace(smoke_variant(get_config("internvl2_26b")),
                       **IMPLS[impl])
    params = lm_params_from_numpy(np_params, port_cfg, device="cpu")
    pm = Model(port_cfg)
    pb = {"tokens": torch.from_numpy(tokens),
          "embeds": torch.from_numpy(embeds)}
    full, _ = pm.forward(params, pb)
    pcache = pm.init_cache(params, pb, VLM_TEXT + P + 8)
    pf, pcache = pm.prefill(params, pb, pcache)
    dec, pcache = pm.decode(params, torch.from_numpy(np.array(nxt)), pcache)
    assert full.shape == (2, VLM_TEXT + P, port_cfg.vocab_padded)
    assert pcache["pos"] == VLM_TEXT + P + 1
    for got, want in ((full, want_full), (pf, want_pf), (dec, want_dec)):
        want = np.asarray(want, np.float64)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= VLM_RTOL, err
