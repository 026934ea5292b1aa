"""The SSD on uneven blocks of heads: mamba2's sharded train step, prefill
and decode where its SSD heads do not divide the model axis.

``shard_tree`` cuts ``wx`` / ``wz`` / ``conv_x_*`` / ``inner_norm`` /
``out_proj`` along ``d_inner`` (ceil-divided), as the JAX package's rules
do; at mamba2-130m's production cut (24 heads of 64 on a model axis of 16)
a participant holds 96 channels, 1.5 heads.  The port runs the SSD on
those channels, laid into whole-head slots with zeros in the channels it
does not own (``models/ssd.py``), and keeps the SSD state whole on every
participant (``cache_shardings`` replicates it where the heads do not
divide), all-gathering each participant's channels of the new state after
the prefill and each decode step.  Here, on the CPU at smoke size (P 8,
N 16, 2 layers) with the kernels' plain versions, one spawn of 4 gloo
ranks runs:

- ``six``: d 24, 6 SSD heads on (1, 4): 12 channels, 1.5 heads a
  participant, as in production; ``five``: d 20, 5 heads on (2, 2) and
  (2, 1, 2) (20 channels, 2.5 heads a participant, the batch over the
  data axes) and the fully-seq batch of 1 on (2, 2) (every row on every
  rank);
- each case's sharded loss, gathered gradients (and, as the control,
  the same without the sum over ``"model"`` of the partial leaves),
  forward logits (gathered over the vocabulary), and prefill and
  teacher-forced decode logits and gathered cache, against the unsharded
  port (1e-4 relative RMS, the chip run's float32 limit) and the logits
  against the JAX package's forward, prefill and decode on the same numpy
  parameters (``LOGIT_TOL``); a second control maps each block's channels
  to heads as if the block began at a head boundary (the offset ``c0 mod
  P`` dropped, so a straddled head reads the wrong ``dt``, ``A`` and
  ``D``): its gradients and its serving logits must leave the limit;
- the whole ``ssm`` state's bits are equal on every rank after the
  prefill and after the last step, and the model participants of a data
  group return the same logits;
- every rank's collectives in one train step, the prefill and one decode
  step equal those of the same calls on ``meta`` over ``MetaShards`` at
  its coordinate (the dry run's count), call for call;
- ``whole``: the smoke config's 16 heads on (1, 4), whole heads a
  participant: the sharded step, forward and serving give the bits of the
  head-block mixer that ran before the channel blocks (kept below as
  ``head_block_mixer`` / ``head_block_decode``) exactly.
"""
from __future__ import annotations

import hashlib
import itertools
import math
from contextlib import nullcontext
from dataclasses import replace
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import (
    gather_cache,
    lm_params_from_numpy,
    lm_params_to_numpy,
    lm_shard_from_numpy,
)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import init_ranks, make_mesh, run_ranks
from repro_torch.models import Model, lm, smoke_variant, ssd
from repro_torch.parallel.collectives import MetaShards, observe
from repro_torch.parallel.sharding import (
    gather_tree,
    param_shardings,
    shard_tree,
)
from repro_torch.parallel.tensor import (
    Participant,
    enter_model_region,
    leave_model_region_product,
)
from repro_torch.train import (
    AdamWConfig,
    abstract_state,
    adamw_init,
    make_train_step,
    state_shardings,
)
from repro_torch.train import step as train_step

ARCH = "mamba2_130m"
MESHES = {"1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
#: the variants' d_model: 6 SSD heads (P 8, expand 2), 5, and the smoke
#: config's own 16
VARIANTS = {"six": 24, "five": 20, "whole": 64}
#: (variant, mesh, batch): the uneven cases
CASES = (("six", "1x4", 4), ("five", "2x2", 4), ("five", "2x1x2", 4),
         ("five", "2x2", 1))
CASE_IDS = [f"{v}-{m}-b{b}" for v, m, b in CASES]
WHOLE = ("whole", "1x4", 4)
WORLD = 4
JOIN_S = 300.0
KERNEL_PATHS = dict(attention_impl="cuda", moe_impl="gmm", ssm_impl="cuda")
#: ``chip_smoke.py``'s float32 limits: the loss relative, every gathered
#: gradient leaf, logits and cache leaf relative RMS
LOSS_RTOL = 1e-6
REL_RMS = 1e-4
#: the JAX comparison's, as ``tests/test_torch_serve.py`` holds the
#: unsharded port
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SEQ, PROMPT, STEPS = 16, 16, 3
MAX_LEN = PROMPT + STEPS + 5
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)


def port_cfg(variant: str):
    return replace(smoke_variant(get_config(ARCH)), d_model=VARIANTS[variant],
                   **KERNEL_PATHS)


def meta_cfg(variant: str):
    """:func:`port_cfg` with the SSD form that takes ``meta`` tensors at
    smoke size (K4's wrapper checks its shapes on meta and takes P 64
    only); no collective depends on the form."""
    return replace(port_cfg(variant), ssm_impl="chunked")


def mesh_of(name: str):
    return make_mesh(*MESHES[name])


def rel_rms(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().reshape(-1)
                          .view(torch.uint8).numpy().tobytes()).hexdigest()


def np_params(variant: str) -> dict:
    """Seeded parameters as the JAX package holds them, norm scales, ``D``
    and conv biases perturbed so that they count."""
    out = lm_params_to_numpy(Model(port_cfg(variant)).init(
        torch.Generator().manual_seed(3), device="cpu"))
    rng = np.random.default_rng(3)
    for slot in out["blocks"].values():
        for name in ("norm_scale", "inner_norm", "D", "conv_x_b",
                     "conv_bc_b"):
            slot[name] = (slot[name] + rng.normal(
                0.0, 0.1, slot[name].shape)).astype(np.float32)
    return out


def np_batch(batch: int) -> dict:
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 256, (4, SEQ)).astype(np.int32)[:batch]
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


# -- the head-block mixer the channel blocks replaced -------------------------

def head_block_mixer(p, x, cfg, part, return_state: bool = False):
    """The sharded full-sequence mixer as it ran on a block of whole heads
    ``part.block(H)`` before the channel blocks (the bits a whole-head
    block must keep)."""
    B, S, _ = x.shape
    H, P, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
        cfg.ssm_state
    h0, h1 = part.block(H)
    rep = H // G
    g0, g1 = h0 // rep, (h1 - 1) // rep + 1
    x = enter_model_region(x, part)
    cdt = x.dtype
    z = x @ p["wz"].to(cdt)
    xr = x @ p["wx"].to(cdt)
    gn = G * N
    bc_cols = torch.cat([torch.arange(g0 * N, g1 * N),
                         gn + torch.arange(g0 * N, g1 * N)]).to(x.device)
    bc = x @ p["wbc"][:, bc_cols].to(cdt)
    dt = x @ p["wdt"][:, h0:h1].to(cdt)
    xc = F.silu(ssd.causal_conv1d(xr, p["conv_x_w"], p["conv_x_b"]))
    bcc = F.silu(ssd.causal_conv1d(bc, p["conv_bc_w"][:, bc_cols],
                                   p["conv_bc_b"][bc_cols]))
    gl = (g1 - g0) * N
    xs = xc.reshape(B, S, h1 - h0, P)
    Bm = bcc[..., :gl].reshape(B, S, g1 - g0, N)
    Cm = bcc[..., gl:].reshape(B, S, g1 - g0, N)
    dt = F.softplus(dt.float() + p["dt_bias"][h0:h1].float())
    A = -torch.exp(p["A_log"][h0:h1].float())
    chunked = (ops.ssd_chunked_cuda if cfg.ssm_impl == "cuda"
               else ssd.ssd_chunked)
    y, h_final = chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + p["D"][h0:h1].to(cdt)[None, None, :, None] * xs
    y = y.reshape(B, S, (h1 - h0) * P)
    y = ssd.sharded_rmsnorm(y * F.silu(z), p["inner_norm"], cfg.d_inner,
                            part, cfg.norm_eps)
    out = leave_model_region_product(torch.matmul, part, y,
                                     p["out_proj"].to(cdt))
    if not return_state:
        return out
    K = cfg.ssm_conv
    bc_all = bc if g1 - g0 == G else x[:, -(K - 1):] @ p["wbc"].to(cdt)
    return out, ssd.SsmState(conv_x=ssd._shift_reg(None, xr, K),
                             conv_bc=ssd._shift_reg(None, bc_all, K),
                             ssm=h_final)


def head_block_decode(p, x, cfg, state, part):
    """The sharded decode step as it ran on a block of whole heads."""
    B = x.shape[0]
    H, P, G, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
        cfg.ssm_state
    h0, h1 = part.block(H)
    rep_g = H // G
    g0, g1 = h0 // rep_g, (h1 - 1) // rep_g + 1
    x = enter_model_region(x, part)
    cdt = x.dtype
    z = x @ p["wz"].to(cdt)
    xr = x @ p["wx"].to(cdt)
    bc = x @ p["wbc"].to(cdt)
    dt = x @ p["wdt"][:, h0:h1].to(cdt)
    win_x = torch.cat([state.conv_x.to(cdt), xr], dim=1)
    win_bc = torch.cat([state.conv_bc.to(cdt), bc], dim=1)
    xc = F.silu(torch.einsum("bkc,kc->bc", win_x, p["conv_x_w"].to(cdt))
                + p["conv_x_b"].to(cdt))
    bcc = F.silu(torch.einsum("bkc,kc->bc", win_bc, p["conv_bc_w"].to(cdt))
                 + p["conv_bc_b"].to(cdt))
    gn = G * N
    xs = xc.reshape(B, h1 - h0, P)
    Bm = bcc[..., g0 * N:g1 * N].reshape(B, g1 - g0, N)
    Cm = bcc[..., gn + g0 * N:gn + g1 * N].reshape(B, g1 - g0, N)
    rep = (h1 - h0) // (g1 - g0)
    Bh = Bm.repeat_interleave(rep, dim=1).float()
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    dt = F.softplus(dt[:, 0, :].float() + p["dt_bias"][h0:h1].float())
    A = -torch.exp(p["A_log"][h0:h1].float())
    h = state.ssm.float()
    h = h * torch.exp(dt * A[None, :])[:, :, None, None] + (
        dt[:, :, None, None] * xs.float()[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhn,bhpn->bhp", Ch, h).to(cdt)
    y = y + p["D"][h0:h1].to(cdt)[None, :, None] * xs
    y = y.reshape(B, 1, (h1 - h0) * P)
    y = ssd.sharded_rmsnorm(y * F.silu(z), p["inner_norm"], cfg.d_inner,
                            part, cfg.norm_eps)
    out = leave_model_region_product(torch.matmul, part, y,
                                     p["out_proj"].to(cdt))
    return out, ssd.SsmState(conv_x=win_x[:, 1:, :],
                             conv_bc=win_bc[:, 1:, :], ssm=h)


def head_block_forms():
    """The mixer and its decode step patched to the head-block forms."""
    return (mock.patch.object(ssd, "_ssm_sharded", head_block_mixer),
            mock.patch.object(ssd, "_ssm_decode_sharded", head_block_decode))


def unoffset():
    """The control: each block's channels mapped to heads as if the block
    began at a head boundary."""
    return mock.patch.object(ssd, "slot_offset", lambda c0, P: 0)


# -- on this process -----------------------------------------------------------

@pytest.mark.parametrize("variant,mesh_name,batch", CASES, ids=CASE_IDS)
def test_the_cases_cut_heads_unevenly(variant, mesh_name, batch):
    """Each block of channels is the one ``shard_tree`` cuts from ``wx``,
    straddles a head on some participant, and the state is whole."""
    cfg = port_cfg(variant)
    mesh = mesh_of(mesh_name)
    m = mesh.shape["model"]
    assert cfg.ssm_heads % m and cfg.d_inner % m == 0
    assert cfg.ssm_heads / m in (1.5, 2.5)
    whole = Model(cfg).abstract_params()
    sh = param_shardings(whole, cfg, mesh)
    offsets = set()
    for c in itertools.product(*(range(n) for n in mesh.shape.values())):
        coord = dict(zip(mesh.axis_names, c))
        part = Participant(MetaShards(mesh, coord))
        c0, c1, h0, h1 = ssd.channel_block(cfg, part)
        wx = shard_tree(whole, sh, coord)["blocks"]["L0_ssm"]["wx"]
        assert wx.shape[-1] == c1 - c0 == cfg.d_inner // m
        assert h0 * cfg.ssm_head_dim <= c0 < c1 <= h1 * cfg.ssm_head_dim
        offsets.add(ssd.slot_offset(c0, cfg.ssm_head_dim))
        local = lm.init_cache(cfg, batch, MAX_LEN, "cpu", part=part)
        slot = local["slots"]["L0_ssm"]
        assert slot["ssm"].shape[2] == cfg.ssm_heads
        assert slot["conv_x"].shape[-1] == c1 - c0
    assert offsets - {0}


def test_an_empty_block_of_channels_raises():
    cfg = replace(port_cfg("six"), d_model=2)        # d_inner 4 over 8
    mesh = make_mesh((1, 8), ("data", "model"))
    part = Participant(MetaShards(mesh, {"data": 0, "model": 7}))
    with pytest.raises(NotImplementedError, match="empty block"):
        ssd.channel_block(cfg, part)


# -- four ranks ---------------------------------------------------------------

def _grads(part, cfg, params_np, batch, control: bool = False):
    model = Model(cfg)
    local = lm_shard_from_numpy(params_np, cfg, part.mesh, part.coord, "cpu")
    like = lm_params_from_numpy(params_np, cfg, "cpu")
    sh = param_shardings(like, cfg, part.mesh)
    with (unoffset() if control else nullcontext()):
        metrics, grads = train_step.sharded_grads(model, local,
                                                  torch_batch(batch), part)
    whole = train_step.psum_partial(
        grads, train_step.partial_grad_leaves(sh), part)
    out = {"loss": float(metrics["loss"]),
           "grads": gather_tree(whole, sh, part.shards, like)}
    if not control:
        out["unsummed"] = gather_tree(grads, sh, part.shards, like)
    return out


def _serve(part, cfg, params_np, batch, feed, control: bool = False):
    model = Model(cfg)
    local = lm_shard_from_numpy(params_np, cfg, part.mesh, part.coord, "cpu")
    tokens = torch.from_numpy(batch["tokens"])
    out = {"logits": [], "caches": [], "ssm_shas": []}
    with (unoffset() if control else nullcontext()):
        cache = model.init_cache(local, {"tokens": tokens}, MAX_LEN,
                                 shards=part)
        logits, cache = model.prefill(local, {"tokens": tokens}, cache,
                                      shards=part)
        out["logits"].append(logits)
        for step in range(STEPS + 1):
            out["ssm_shas"].append([sha(s["ssm"]) for s in
                                    cache["slots"].values()])
            if not control:
                out["caches"].append(gather_cache(
                    cache, cfg, part, tokens.shape[0])["slots"])
            if step == STEPS:
                break
            logits, cache = model.decode(local, torch.from_numpy(feed[step]),
                                         cache, shards=part)
            out["logits"].append(logits)
    return out


def _forward(part, cfg, params_np, batch):
    local = lm_shard_from_numpy(params_np, cfg, part.mesh, part.coord, "cpu")
    rows = train_step.batch_rows(torch_batch(batch), cfg, part)
    with torch.no_grad():
        logits, _ = Model(cfg).forward(local, {"tokens": rows["tokens"]},
                                       shards=part)
    return logits


def _records(part, cfg, params_np, batch) -> dict:
    """Each ``(kind, operand bytes)`` of one train step, the prefill and
    one decode step on this rank."""
    model = Model(cfg)
    params = lm_params_from_numpy(params_np, cfg, "cpu")
    sh = state_shardings(abstract_state(model, OPT), cfg, part.mesh)
    state = shard_tree({"params": params, "opt": adamw_init(params)}, sh,
                       part.coord)
    step = make_train_step(model, OPT, shards=part, shardings=sh)
    out = {"train": [], "prefill": [], "decode": []}
    with observe(lambda kind, n: out["train"].append((kind, n))):
        step(state, torch_batch(batch))
    local = lm_shard_from_numpy(params_np, cfg, part.mesh, part.coord, "cpu")
    tokens = torch.from_numpy(batch["tokens"])
    cache = model.init_cache(local, {"tokens": tokens}, MAX_LEN, shards=part)
    with observe(lambda kind, n: out["prefill"].append((kind, n))):
        _, cache = model.prefill(local, {"tokens": tokens}, cache,
                                 shards=part)
    with observe(lambda kind, n: out["decode"].append((kind, n))):
        model.decode(local, tokens[:, :1], cache, shards=part)
    return out


def _case(part, variant, refs, batch_size) -> dict:
    cfg = port_cfg(variant)
    ref = refs[variant, batch_size]
    batch = np_batch(batch_size)
    return {"coord": part.coord, "di": part.di, "dp": part.dp,
            "rows_split": lm.rows_part(part, batch_size).rows_split,
            "grads": _grads(part, cfg, ref["params"], batch),
            "grads_control": _grads(part, cfg, ref["params"], batch, True),
            "forward": _forward(part, cfg, ref["params"], batch),
            "serve": _serve(part, cfg, ref["params"], batch, ref["feed"]),
            "serve_control": _serve(part, cfg, ref["params"], batch,
                                    ref["feed"], True)["logits"],
            "records": _records(part, cfg, ref["params"], batch)}


def _whole_case(part, refs) -> dict:
    """The whole-head case in the channel-block form and in the head-block
    form: every output's hash."""
    cfg = port_cfg("whole")
    ref = refs["whole", 4]
    batch = np_batch(4)
    out = {}
    for form in ("channels", "heads"):
        patches = head_block_forms() if form == "heads" else ()
        for p in patches:
            p.start()
        try:
            g = _grads(part, cfg, ref["params"], batch)
            s = _serve(part, cfg, ref["params"], batch, ref["feed"])
            f = _forward(part, cfg, ref["params"], batch)
        finally:
            for p in patches:
                p.stop()
        out[form] = {
            "loss": g["loss"], "grads": [sha(t) for t in tree.leaves(
                g["grads"])],
            "logits": [sha(t) for t in s["logits"]] + [sha(f)],
            "caches": [sha(t) for c in s["caches"]
                       for t in tree.leaves(c)]}
    return out


def _rank_cases(rank: int, store: str, refs: dict) -> dict:
    torch.set_num_threads(1)
    dm = init_ranks(mesh_of("2x2"), rank, store)
    meshes = {name: dm if name == "2x2" else mesh_of(name).device_mesh()
              for name in MESHES}
    out = {(v, m, b): _case(Participant(meshes[m]), v, refs, b)
           for v, m, b in CASES}
    out[WHOLE] = _whole_case(Participant(meshes[WHOLE[1]]), refs)
    return out


def jax_run(variant: str, params: dict, batch_size: int):
    """The JAX package's forward, jitted prefill and greedy decode steps on
    ``params``: the forward's and each call's logits, and the tokens the
    steps fed.  (JAX is imported here: the rank processes import this
    module and need only the port.)"""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.models import Model as RefModel
    from repro.models import smoke_variant as ref_smoke

    model = RefModel(replace(ref_smoke(ref_config(ARCH)),
                             d_model=VARIANTS[variant]))
    params = jax.tree.map(jnp.asarray, params)
    tokens = jnp.asarray(np_batch(batch_size)["tokens"])
    forward = np.asarray(jax.jit(model.forward)(params,
                                                {"tokens": tokens})[0])
    batch = {"tokens": tokens}
    cache = model.init_cache(params, batch, MAX_LEN)
    logits, cache = jax.jit(model.prefill)(params, batch, cache)
    decode = jax.jit(model.decode)
    want, feed = [np.asarray(logits)], []
    for _ in range(STEPS):
        nxt = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:,
                                                                      None]
        feed.append(np.array(nxt))
        logits, cache = decode(params, nxt, cache)
        want.append(np.asarray(logits))
    return forward, want, feed


def port_run(variant: str, params_np: dict, batch_size: int, feed) -> dict:
    """The unsharded port: loss, gradients, forward logits, and the
    prefill and teacher-forced decode steps' logits and caches."""
    cfg = port_cfg(variant)
    model = Model(cfg)
    params = lm_params_from_numpy(params_np, cfg, "cpu")
    batch = torch_batch(np_batch(batch_size))
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    loss, _ = model.loss(tree.unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        forward, _ = model.forward(params, {"tokens": batch["tokens"]})
    cache = model.init_cache(params, batch, MAX_LEN)
    logits, cache = model.prefill(params, {"tokens": batch["tokens"]}, cache)
    out = {"loss": float(loss.detach()), "grads": list(grads),
           "forward": forward,
           "logits": [logits],
           "caches": [tree.map(torch.clone, cache["slots"])]}
    for tok in feed:
        logits, cache = model.decode(params, torch.from_numpy(tok), cache)
        out["logits"].append(logits)
        out["caches"].append(tree.map(torch.clone, cache["slots"]))
    return out


@pytest.fixture(scope="module")
def reference():
    out = {}
    for variant, batch in sorted({(v, b) for v, _, b in CASES}
                                 | {(WHOLE[0], WHOLE[2])}):
        params = np_params(variant)
        forward, want, feed = jax_run(variant, params, batch)
        out[variant, batch] = {"params": params, "feed": feed,
                               "jax_forward": forward, "jax": want,
                               "port": port_run(variant, params, batch,
                                                feed)}
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("uneven_ssd") / "store")
    refs = {k: {"params": r["params"], "feed": r["feed"]}
            for k, r in reference.items()}
    return run_ranks(_rank_cases, WORLD, store, refs, timeout_s=JOIN_S)


def rows(t, case: dict):
    if not case["rows_split"]:
        return t
    n = t.shape[0] // case["dp"]
    return t[case["di"] * n:(case["di"] + 1) * n]


cases = pytest.mark.parametrize("variant,mesh_name,batch", CASES,
                                ids=CASE_IDS)


@cases
def test_sharded_gradients_equal_the_unsharded_port(ranks, reference,
                                                    variant, mesh_name,
                                                    batch):
    want = reference[variant, batch]["port"]
    for r in ranks:
        got = r[variant, mesh_name, batch]["grads"]
        assert abs(got["loss"] - want["loss"]) / abs(want["loss"]) \
            <= LOSS_RTOL
        for g, w in zip(tree.leaves(got["grads"]), want["grads"],
                        strict=True):
            assert g.shape == w.shape
            assert rel_rms(g, w) <= REL_RMS


@cases
def test_the_controls_leave_the_gradient_limit(ranks, reference, variant,
                                               mesh_name, batch):
    """Without the sum over ``"model"`` of the partial leaves, and with the
    blocks' channels mapped to heads from a head boundary, some gradient
    leaf leaves the limit on every rank."""
    want = reference[variant, batch]["port"]["grads"]
    for r in ranks:
        case = r[variant, mesh_name, batch]
        for got in (case["grads"]["unsummed"],
                    case["grads_control"]["grads"]):
            worst = max(rel_rms(g, w) for g, w in
                        zip(tree.leaves(got), want, strict=True))
            assert worst > REL_RMS, (case["coord"], worst)


@cases
def test_sharded_forward_logits_equal_the_port_and_jax(ranks, reference,
                                                       variant, mesh_name,
                                                       batch):
    ref = reference[variant, batch]
    for r in ranks:
        case = r[variant, mesh_name, batch]
        got = case["forward"]
        assert got.shape[-1] == 256
        assert rel_rms(got, rows(ref["port"]["forward"], case)) <= REL_RMS
        np.testing.assert_allclose(got.numpy(),
                                   rows(ref["jax_forward"], case),
                                   **LOGIT_TOL)


@cases
def test_sharded_serving_equals_the_port_and_jax(ranks, reference, variant,
                                                 mesh_name, batch):
    ref = reference[variant, batch]
    for r in ranks:
        case = r[variant, mesh_name, batch]
        logits = case["serve"]["logits"]
        assert len(logits) == STEPS + 1
        for call, (g, w, j) in enumerate(zip(logits, ref["port"]["logits"],
                                             ref["jax"], strict=True)):
            assert rel_rms(g, rows(w, case)) <= REL_RMS, (case["coord"],
                                                          call)
            assert torch.equal(g[:, -1].argmax(-1),
                               rows(w, case)[:, -1].argmax(-1))
            np.testing.assert_allclose(g.numpy(), rows(j, case),
                                       **LOGIT_TOL)
        for got, want in zip(case["serve"]["caches"], ref["port"]["caches"],
                             strict=True):
            for g, w in zip(tree.leaves(got), tree.leaves(want),
                            strict=True):
                assert g.shape == w.shape
                assert rel_rms(g, w) <= REL_RMS


@cases
def test_the_unoffset_control_leaves_the_serving_limit(ranks, reference,
                                                       variant, mesh_name,
                                                       batch):
    want = reference[variant, batch]["port"]["logits"]
    for r in ranks:
        case = r[variant, mesh_name, batch]
        worst = max(rel_rms(g, rows(w, case)) for g, w in
                    zip(case["serve_control"], want, strict=True))
        assert worst > REL_RMS, (case["coord"], worst)


@cases
def test_the_whole_state_holds_the_same_bits_on_every_rank(ranks, variant,
                                                           mesh_name,
                                                           batch):
    """After the prefill and after every step the replicated ``ssm``
    state is one tree of bits on every rank of a data group (of every
    rank where the rows are whole), and so are the logits."""
    groups: dict = {}
    for r in ranks:
        case = r[variant, mesh_name, batch]
        key = case["di"] if case["rows_split"] else 0
        groups.setdefault(key, set()).add(
            (str(case["serve"]["ssm_shas"]),
             tuple(sha(t) for t in case["serve"]["logits"])))
    assert all(len(v) == 1 for v in groups.values())
    assert len(groups) == (math.prod(MESHES[mesh_name][0][:-1])
                           if batch % 2 == 0 else 1)


def meta_records(variant: str, mesh, coord: dict, batch_size: int) -> dict:
    """:func:`_records`' calls on ``meta`` over ``MetaShards`` at
    ``coord``."""
    cfg = meta_cfg(variant)
    model = Model(cfg)
    abstract = abstract_state(model, OPT)
    sh = state_shardings(abstract, cfg, mesh)
    part = Participant(MetaShards(mesh, coord))
    step = make_train_step(model, OPT, shards=part, shardings=sh)
    batch = {k: torch.empty((batch_size, SEQ), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    out = {"train": [], "prefill": [], "decode": []}
    with observe(lambda kind, n: out["train"].append((kind, n))):
        step(shard_tree(abstract, sh, coord), batch)
    params = shard_tree(abstract["params"], sh["params"], coord)
    tokens = {"tokens": batch["tokens"]}
    cache = model.init_cache(params, tokens, MAX_LEN, shards=part)
    with observe(lambda kind, n: out["prefill"].append((kind, n))):
        _, cache = model.prefill(params, tokens, cache, shards=part)
    with observe(lambda kind, n: out["decode"].append((kind, n))):
        model.decode(params, batch["tokens"][:, :1], cache, shards=part)
    return out


@cases
def test_the_meta_count_is_every_rank_record(ranks, variant, mesh_name,
                                             batch):
    """Call for call, in a train step, the prefill and a decode step; the
    serving calls all-gather the state over ``"model"``."""
    mesh = mesh_of(mesh_name)
    for r in ranks:
        case = r[variant, mesh_name, batch]
        want = meta_records(variant, mesh, case["coord"], batch)
        assert case["records"] == want, case["coord"]
        for call in ("prefill", "decode"):
            assert any(k == "all-gather" for k, _ in case["records"][call])


def test_a_whole_head_block_keeps_the_head_block_bits(ranks):
    """16 heads on (1, 4): the loss, every gathered gradient leaf, the
    forward and serving logits and the gathered caches are the head-block
    mixer's bits on every rank."""
    for r in ranks:
        got = r[WHOLE]
        assert got["channels"] == got["heads"]
        assert len(got["heads"]["grads"]) > 0
