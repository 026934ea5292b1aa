"""Sharded prefill and decode: ``Model.init_cache`` / ``prefill`` /
``decode`` with ``shards=`` against the unsharded port and the JAX
package's serving cells.

The JAX package jits ``prefill_step`` / ``decode_step`` with
``cache_shardings``; the port runs them one participant a process, on its
block of the weights and of the cache (``parallel/sharding.py``), with the
collectives written out.  Here, on the CPU with the kernels' plain
versions at smoke size (batch 4, a prompt of 16, 4 decode steps):

- the layouts fall as the smoke configs give them: granite-moe on (2, 2)
  and olmoe on (1, 4) head-sharded (kv 2 / 4), granite-moe on (1, 4),
  glm4 and jamba hd-sharded (kv 2 or 1, head_dim 16); mamba2 and jamba
  carry SSM slots; on the three-axis ``("pod", "data", "model")`` meshes,
  the batch over pod × data, granite-moe (2, 1, 2) and glm4 (2, 2, 1)
  head-sharded, mamba2 (2, 1, 2);
- ``init_cache(part=)`` allocates exactly what ``shard_tree`` cuts from
  the whole cache, for every decoder-only arch at both meshes;
- a (1, 1) mesh gives the unsharded logits and cache byte for byte;
- one spawn of 4 gloo ranks runs every case's sharded prefill and decode
  steps on seeded numpy parameters (both packages' form), teacher-forced
  with the JAX run's greedy tokens, the unsharded port's routing
  replayed: every
  call's logits, the greedy tokens and the gathered cache (after the
  prefill and after the last step) are held to the unsharded port at
  ``chip_smoke.py``'s float32 limit, and the logits to the JAX package's
  ``Model.prefill`` / ``Model.decode`` (jitted) as ``test_torch_serve.py``
  holds the unsharded port; every model participant of a data group
  returns the same bits; each case's controls (the hd layout's partial
  scores not summed over ``"model"``, the decode kernel read with an
  exclusive mask, ``inner_norm`` per block in the recurrent step) exceed
  the limit; a full cache raises ``IndexError`` on every rank;
- the fully-seq layout (a batch that does not divide over the data
  axes: every participant takes every row, its cache block is a block of
  the positions) in both forms: whole heads at a model axis of one
  (``"seq"``: granite-moe and jamba on (4, 1), batch 1 and 2, the decode
  kernel's statistics form over the block), ``head_dim`` blocks above it
  (``"seq_hd"``: granite-moe, whose kv heads divide the model axis, glm4
  and jamba on (2, 2), jamba's the layout of the JAX package's
  ``long_500k`` cell on both production meshes), and mamba2 on (2, 2)
  with its batch whole.  A cache of
  30 positions is cut into blocks of 8, 8, 8 and 6 on dp 4: the prompt of
  16 fills ranks 0 and 1, the steps write into rank 2's block and rank 3's
  stays empty; glm4 on (2, 2, 1), batch 1, divides neither pod nor data.
  Each case is held as above (every rank returns the same
  bits, the rows being replicated), with its controls: the block's
  ``cache_len`` not offset by its start, the blocks averaged with equal
  weights;
- every rank's collectives in the prefill and one decode step of
  granite-moe, glm4 and mamba2 on every mesh (batch 4, and batch 1 in the
  fully-seq layout), and of the other fully-seq cases (jamba's, granite's
  batch of 2), call for call, equal those of the same calls run on
  ``meta`` over ``MetaShards`` at the rank's coordinate (the dry run's
  count);
- each serving call of the encoder-decoder on a (1, 1) mesh is the
  unsharded one byte for byte (its multi-rank cases, the fully-seq
  layout among them, are ``tests/test_torch_sharded_encdec.py``), and so
  is ``moe_impl="ep"``'s,
  whose decode step at a model axis above one raises ``ValueError``
  (its multi-rank cases are ``tests/test_torch_sharded_ep.py``).

Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_sharded_serve.py``; on the card, ``python3 chip_smoke.py
--shard`` runs the sharded serving cases at full width (jamba's fully-seq
ones over a cache of 524 288 positions).
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

from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import (
    gather_cache,
    lm_params_from_numpy,
    lm_params_to_numpy,
    lm_shard_from_numpy,
)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import init_ranks, make_mesh, run_ranks
from repro_torch.models import Model, layers, lm, moe, smoke_variant, ssd
from repro_torch.parallel.collectives import MetaShards, observe
from repro_torch.parallel.sharding import (
    cache_layout,
    cache_shardings,
    cache_spec_for_kv,
    dp_axes,
    dp_size,
    param_shardings,
    shard_tree,
    spec,
)
from repro_torch.parallel.tensor import Participant

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
#: the archs whose collectives are recorded, at these batch sizes
RECORD_ARCHS = ("granite_moe_1b_a400m", "glm4_9b", "mamba2_130m")
RECORD_BATCHES = (4, 1)
WORLD = 4
JOIN_S = 300.0
KERNEL_PATHS = dict(attention_impl="cuda", moe_impl="gmm", ssm_impl="cuda")
#: ``chip_smoke.py``'s float32 limit (``serve_path.f32_variant``):
#: logits and each gathered cache leaf, relative RMS.
REL_RMS = 1e-4
#: the JAX comparison's, as ``tests/test_torch_serve.py`` holds the
#: unsharded port
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, PROMPT, STEPS = 4, 16, 4
MAX_LEN = PROMPT + STEPS + 8
#: (arch, mesh): the attention cache's layout (None: no attention).
CASES = {
    ("granite_moe_1b_a400m", "2x2"): "head",
    ("granite_moe_1b_a400m", "1x4"): "hd",
    ("olmoe_1b_7b", "1x4"): "head",
    ("glm4_9b", "1x4"): "hd",
    ("glm4_9b", "2x2"): "hd",
    ("jamba_v0_1_52b", "1x4"): "hd",
    ("mamba2_130m", "2x2"): None,
    ("mamba2_130m", "1x4"): None,
    ("granite_moe_1b_a400m", "2x1x2"): "head",
    ("glm4_9b", "2x2x1"): "head",
    ("mamba2_130m", "2x1x2"): None,
}
ARCHS = sorted({a for a, _ in CASES})
SSM_ARCHS = ("jamba_v0_1_52b", "mamba2_130m")
CASE_IDS = [f"{a}-{m}" for a, m in CASES]
#: a full cache is decoded into on these cases
FULL_CASES = (("granite_moe_1b_a400m", "2x2"), ("glm4_9b", "1x4"))
#: The fully-seq cases, (arch, mesh, batch): the attention cache's layout
#: (None: no attention), in a cache of ``FS_MAX_LEN`` positions.
FS_CASES = {
    ("granite_moe_1b_a400m", "4x1", 1): "seq",
    ("granite_moe_1b_a400m", "2x2", 1): "seq_hd",
    ("glm4_9b", "2x2", 1): "seq_hd",
    ("jamba_v0_1_52b", "4x1", 1): "seq",
    ("jamba_v0_1_52b", "2x2", 1): "seq_hd",
    ("mamba2_130m", "2x2", 1): None,
    ("granite_moe_1b_a400m", "4x1", 2): "seq",
    ("glm4_9b", "2x2x1", 1): "seq",
}
FS_IDS = [f"{a}-{m}-b{b}" for a, m, b in FS_CASES]
#: the fully-seq cases whose collectives the meta count holds here (the
#: others are ``RECORD_ARCHS`` at ``RECORD_BATCHES``, on every mesh)
FS_RECORD_CASES = [c for c in FS_CASES if c[0] not in RECORD_ARCHS
                   or c[2] not in RECORD_BATCHES]
FS_MAX_LEN = 30
FS_FULL_CASES = (("granite_moe_1b_a400m", "4x1", 1),)
#: each data participant's block of the cache's positions: blocks of 8, 8,
#: 8 and 6 on dp 4, two of 15 on dp 2; the positions a block holds after
#: the prefill and after the last step
FS_FILLED = {4: [(8, 8), (8, 8), (0, STEPS), (0, 0)],
             2: [(15, 15), (PROMPT - 15, PROMPT + STEPS - 15)]}


def port_cfg(arch: str):
    return replace(smoke_variant(get_config(arch)), **KERNEL_PATHS)


def meta_cfg(arch: str):
    """:func:`port_cfg` with the attention and SSD forms that take ``meta``
    tensors at smoke size (the kernels' wrappers check their shapes on
    meta, and take head_dim 64 / 128 only); no collective depends on the
    form."""
    return replace(port_cfg(arch), attention_impl="dense",
                   ssm_impl="chunked")


def mesh_of(name: str):
    return make_mesh(*MESHES[name])


def all_coords(mesh) -> list[dict]:
    names = mesh.axis_names
    return [dict(zip(names, c)) for c in itertools.product(
        *(range(mesh.shape[a]) for a in names))]


def zero_coord(mesh) -> dict:
    return {a: 0 for a in mesh.axis_names}


def model_size(mesh_name: str) -> int:
    return MESHES[mesh_name][0][-1]


def controls(arch: str, layout, m: int = 2) -> list[str]:
    """The controls of a case on a model axis of ``m``: each breaks one
    step of the sharded decode, so its logits must leave the limit (a
    norm per block is the norm where there is one block)."""
    out = []
    if layout == "hd":
        out.append("unsummed_scores")
    if layout == "head":
        out.append("exclusive_mask")
    if layout == "seq":
        out.append("unoffset_cache_len")
    if layout in ("seq", "seq_hd"):
        out.append("equal_block_weights")
    if arch in SSM_ARCHS and m > 1:
        out.append("per_block_norm")
    return out


def _exclusive(mha_decode):
    def call(q, k_cache, v_cache, cache_len):
        return mha_decode(q, k_cache, v_cache, cache_len - 1)
    return call


def control_patch(name: str):
    """The patch that makes control ``name`` (inside the decode steps)."""
    if name == "unsummed_scores":
        return mock.patch.object(layers, "sum_partial_scores",
                                 lambda scores, part: scores)
    if name == "exclusive_mask":
        return mock.patch.object(ops, "mha_decode",
                                 _exclusive(ops.mha_decode))
    if name == "unoffset_cache_len":
        block_len = layers.block_cache_len
        return mock.patch.object(layers, "block_cache_len",
                                 lambda c, s_lo, n: block_len(c, 0, n))
    if name == "equal_block_weights":
        return mock.patch.object(layers, "combine_blocks",
                                 lambda o, m, l: o.mean(dim=0))
    return mock.patch.object(
        ssd, "sharded_rmsnorm", lambda x, scale, n, part, eps=1e-5:
        layers.rmsnorm(x, scale, eps))


def rel_rms(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().reshape(-1).view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


# -- layouts and shapes -------------------------------------------------------

@pytest.mark.parametrize("arch,mesh_name", list(CASES), ids=CASE_IDS)
def test_smoke_layouts_fall_as_the_configs_give(arch, mesh_name):
    cfg = port_cfg(arch)
    mesh = mesh_of(mesh_name)
    layout = CASES[arch, mesh_name]
    kv = cache_spec_for_kv(cfg, mesh, BATCH)
    dp = dp_axes(mesh)
    if layout == "head":
        assert kv == spec(None, dp, None, "model", None)
    elif layout == "hd":
        assert kv == spec(None, dp, None, None, "model")
        assert cfg.n_kv_heads in (1, 2) and cfg.head_dim == 16
    kinds = {s.mixer for s in cfg.pattern()}
    assert ("attn" in kinds) == (layout is not None)
    assert ("ssm" in kinds) == (arch in SSM_ARCHS)


def decoder_archs() -> list[str]:
    return [a for a in ARCH_IDS if not get_config(a).enc_layers]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", decoder_archs())
def test_init_cache_allocates_what_shard_tree_cuts(arch, mesh_name):
    cfg = smoke_variant(get_config(arch))
    mesh = mesh_of(mesh_name)
    whole = lm.init_cache(cfg, BATCH, MAX_LEN, "cpu")
    sh = cache_shardings(cfg, mesh, whole["slots"], BATCH)
    for coord in all_coords(mesh):
        part = Participant(MetaShards(mesh, coord))
        local = lm.init_cache(cfg, BATCH, MAX_LEN, "cpu", part=part)
        want = shard_tree(whole["slots"], sh, coord)
        for got, cut in zip(tree.leaves(local["slots"]), tree.leaves(want),
                            strict=True):
            assert got.shape == cut.shape and got.dtype == cut.dtype
            assert not got.any()
        assert local["pos"] == 0 and int(local["len"]) == 0
        assert local["len"].shape == ()


@pytest.mark.parametrize("form", ["plain", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_one_by_one_mesh_is_the_unsharded_serving_byte_for_byte(arch,
                                                                   form):
    cfg = smoke_variant(get_config(arch))
    if form == "kernels":
        cfg = replace(cfg, **KERNEL_PATHS)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.from_numpy(prompts())}
    runs = []
    for shards in (None, make_mesh((1, 1), ("data", "model"))):
        cache = model.init_cache(params, batch, MAX_LEN, shards=shards)
        logits, cache = model.prefill(params, batch, cache, shards=shards)
        out = [logits]
        for _ in range(STEPS):
            nxt = out[-1][:, -1].argmax(-1)[:, None].to(torch.int32)
            logits, cache = model.decode(params, nxt, cache, shards=shards)
            out.append(logits)
        runs.append((out, cache))
    (want, want_cache), (got, got_cache) = runs
    assert all(sha(g) == sha(w) for g, w in zip(got, want, strict=True))
    for g, w in zip(tree.leaves(got_cache["slots"]),
                    tree.leaves(want_cache["slots"]), strict=True):
        assert sha(g) == sha(w)
    assert got_cache["pos"] == want_cache["pos"] == PROMPT + STEPS
    assert int(got_cache["len"]) == int(want_cache["len"])


# -- what does not run sharded ------------------------------------------------

@pytest.mark.parametrize("arch,mesh_name,batch", list(FS_CASES),
                         ids=FS_IDS)
def test_fully_seq_layouts_fall_as_the_configs_give(arch, mesh_name, batch):
    cfg = port_cfg(arch)
    mesh = mesh_of(mesh_name)
    layout = FS_CASES[arch, mesh_name, batch]
    assert batch % math.prod(mesh.shape[a] for a in dp_axes(mesh)) != 0
    assert cache_spec_for_kv(cfg, mesh, batch)[1:3] == (
        None, spec(dp_axes(mesh))[0])
    if layout:
        assert cache_layout(cfg, mesh, batch) == layout
    part = Participant(MetaShards(mesh, zero_coord(mesh)))
    assert lm.serve_layout(cfg, part, batch) == layout
    if arch == "granite_moe_1b_a400m" and mesh_name == "2x2":
        # the kv heads divide the model axis, and the cache is hd-sharded
        assert cfg.n_kv_heads % 2 == 0 and layout == "seq_hd"
    whole = lm.init_cache(cfg, batch, FS_MAX_LEN, "meta")
    for path, sh in tree.leaves_with_path(cache_shardings(
            cfg, mesh, whole["slots"], batch)):
        if str(path[-1]) in ("conv_x", "conv_bc", "ssm"):
            assert sh.spec[1] is None          # the batch is whole


@pytest.mark.parametrize("mesh_name", ["4x1", "2x2", "2x2x1", "2x1x2"])
@pytest.mark.parametrize("arch", decoder_archs())
def test_fully_seq_init_cache_allocates_what_shard_tree_cuts(arch,
                                                             mesh_name):
    cfg = smoke_variant(get_config(arch))
    mesh = mesh_of(mesh_name)
    whole = lm.init_cache(cfg, 1, FS_MAX_LEN, "cpu")
    sh = cache_shardings(cfg, mesh, whole["slots"], 1)
    attn = any(s.mixer == "attn" for s in cfg.pattern())
    dp = dp_size(mesh)
    for coord in all_coords(mesh):
        part = Participant(MetaShards(mesh, coord))
        local = lm.init_cache(cfg, 1, FS_MAX_LEN, "cpu", part=part)
        want = shard_tree(whole["slots"], sh, coord)
        for got, cut in zip(tree.leaves(local["slots"]), tree.leaves(want),
                            strict=True):
            assert got.shape == cut.shape and got.dtype == cut.dtype
        assert local["max_len"] == FS_MAX_LEN
        assert lm.cache_size(local) == FS_MAX_LEN
        if attn:
            lo, hi = part.dp_block(FS_MAX_LEN)
            slot = next(s for s in local["slots"].values() if "k" in s)
            assert slot["k"].shape[:3] == (cfg.n_blocks, 1, hi - lo)
            assert hi - lo == {4: [8, 8, 8, 6], 2: [15, 15]}[dp][part.di]


def test_a_cache_that_leaves_a_sequence_block_empty_raises():
    cfg = port_cfg("granite_moe_1b_a400m")
    mesh = make_mesh((4, 1), ("data", "model"))
    part = Participant(MetaShards(mesh, {"data": 0, "model": 0}))
    with pytest.raises(ValueError, match="empty"):
        lm.init_cache(cfg, 1, 5, "cpu", part=part)
    lm.init_cache(cfg, 1, 7, "cpu", part=part)


def test_a_batch_that_does_not_divide_over_dp_is_taken_whole():
    mesh = make_mesh((2, 2), ("data", "model"))
    part = Participant(MetaShards(mesh, {"data": 1, "model": 0}))
    t = torch.arange(3 * PROMPT, dtype=torch.int32).reshape(3, PROMPT)
    assert torch.equal(lm.batch_block(t, lm.rows_part(part, 3)), t)
    assert lm.rows_part(part, 3).rows_split is False
    assert lm.rows_part(part, 4) is part
    assert torch.equal(lm.batch_block(torch.cat([t, t[:1]]),
                                      lm.rows_part(part, 4)),
                       torch.cat([t, t[:1]])[2:])


def test_a_model_axis_of_one_keeps_every_parameter_whole():
    """``lm_shard_from_numpy`` at (4, 1): every participant holds every
    leaf of the JAX package's tree, whole and equal."""
    arch = "jamba_v0_1_52b"
    cfg = port_cfg(arch)
    params = np_params(arch)
    whole = lm_params_from_numpy(params, cfg, "cpu")
    mesh = make_mesh((4, 1), ("data", "model"))
    for d in range(4):
        got = lm_shard_from_numpy(params, cfg, mesh, {"data": d, "model": 0},
                                  "cpu")
        for g, w in zip(tree.leaves(got), tree.leaves(whole), strict=True):
            assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("call", ["init_cache", "prefill", "decode"])
def test_the_encoder_decoder_serves_sharded_on_one_shard(call):
    """Each serving call of the encoder-decoder runs with ``shards=`` (it
    raised before ``models/encdec.py`` took a participant): on a (1, 1)
    mesh, the call's cache and logits are the unsharded ones byte for
    byte (the multi-rank cases are
    ``tests/test_torch_sharded_encdec.py``)."""
    cfg = replace(smoke_variant(get_config("seamless_m4t_medium")),
                  **KERNEL_PATHS)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    enc = torch.randn((BATCH, 8, cfg.d_model),
                      generator=torch.Generator().manual_seed(1))
    batch = {"tokens": torch.from_numpy(prompts()), "enc_embeds": enc}
    runs = []
    for shards in (None, make_mesh((1, 1), ("data", "model"))):
        kw = {"shards": shards if call == "init_cache" else None}
        cache = model.init_cache(params, batch, MAX_LEN, **kw)
        out = []
        if call != "init_cache":
            kw = {"shards": shards if call == "prefill" else None}
            logits, cache = model.prefill(params, batch, cache, **kw)
            out.append(logits)
        if call == "decode":
            logits, cache = model.decode(params, batch["tokens"][:, :1],
                                         cache, shards=shards)
            out.append(logits)
        runs.append((out, cache))
    (want, want_cache), (got, got_cache) = runs
    assert all(sha(g) == sha(w) for g, w in zip(got, want, strict=True))
    for name in ("self", "cross"):
        for k in ("k", "v"):
            assert sha(got_cache[name][k]) == sha(want_cache[name][k])
    assert got_cache["pos"] == want_cache["pos"]
    assert int(got_cache["cross_len"]) == int(want_cache["cross_len"])


@pytest.mark.parametrize("call", ["prefill", "decode"])
def test_ep_moe_does_not_serve_sharded(call):
    """``moe_impl="ep"`` serves sharded (its multi-rank cases are
    ``tests/test_torch_sharded_ep.py``): on a (1, 1) mesh the unsharded ep
    calls' bits; a decode step at a model axis above one (one position
    per row) is refused with ``ValueError`` before any collective, as the
    reference's ``shard_map`` asserts."""
    from repro_torch.parallel import ep_moe

    cfg = replace(smoke_variant(get_config("granite_moe_1b_a400m")),
                  moe_impl="ep")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    mesh = make_mesh((1, 1), ("data", "model"))
    batch = {"tokens": torch.from_numpy(prompts())}
    ep_moe.set_mesh(mesh)
    try:
        want_cache = model.init_cache(params, batch, MAX_LEN)
        want, want_cache = model.prefill(params, batch, want_cache)
        if call == "decode":
            want, want_cache = model.decode(params, batch["tokens"][:, :1],
                                            want_cache)
    finally:
        ep_moe.set_mesh(None)
    cache = model.init_cache(params, batch, MAX_LEN, shards=mesh)
    got, cache = model.prefill(params, batch, cache, shards=mesh)
    if call == "decode":
        got, cache = model.decode(params, batch["tokens"][:, :1], cache,
                                  shards=mesh)
    assert sha(got) == sha(want)
    for a, b in zip(tree.leaves(cache["slots"]),
                    tree.leaves(want_cache["slots"]), strict=True):
        assert sha(a) == sha(b)
    if call == "decode":
        two = make_mesh((1, 2), ("data", "model"))
        part = Participant(MetaShards(two, {"data": 0, "model": 0}))
        meta = {"tokens": torch.empty((BATCH, PROMPT), dtype=torch.int32,
                                      device="meta")}
        local = shard_tree(model.abstract_params(), param_shardings(
            model.abstract_params(), cfg, two), {"data": 0, "model": 0})
        meta_cache = model.init_cache(local, meta, MAX_LEN, shards=part)
        seen = []
        with observe(lambda kind, n: seen.append(kind)), \
                pytest.raises(ValueError, match="expert parallelism"):
            model.decode(local, meta["tokens"][:, :1], meta_cache,
                         shards=part)
        assert seen == []


# -- four ranks ---------------------------------------------------------------

def prompts(batch: int = BATCH) -> np.ndarray:
    return np.random.default_rng(2).integers(
        0, 256, (BATCH, PROMPT)).astype(np.int32)[:batch]


def np_params(arch: str) -> dict:
    """Seeded smoke parameters as the JAX package holds them (nested dicts
    of numpy arrays), norm scales, SSD ``D`` and conv biases perturbed so
    that they count."""
    out = lm_params_to_numpy(Model(smoke_variant(get_config(arch))).init(
        torch.Generator().manual_seed(1), device="cpu"))
    rng = np.random.default_rng(1)
    for slot in out["blocks"].values():
        for name in list(slot):
            if name in ("norm_scale", "inner_norm", "D", "conv_x_b",
                        "conv_bc_b"):
                slot[name] = (slot[name] + rng.normal(
                    0.0, 0.1, slot[name].shape)).astype(np.float32)
    return out


def jax_run(arch: str, params: dict, batch_size: int = BATCH,
            max_len: int = MAX_LEN):
    """The JAX package's jitted prefill and greedy decode steps on
    ``params`` (the first ``batch_size`` prompts, a cache of ``max_len``):
    each call's logits and the tokens the steps fed.  (JAX is imported
    here, not with the module: the rank processes import this module and
    need only the port.)"""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.models import Model as RefModel
    from repro.models import smoke_variant as ref_smoke

    model = RefModel(ref_smoke(ref_config(arch)))
    params = jax.tree.map(jnp.asarray, params)
    batch = {"tokens": jnp.asarray(prompts(batch_size))}
    cache = model.init_cache(params, batch, max_len)
    logits, cache = jax.jit(model.prefill)(params, batch, cache)
    decode = jax.jit(model.decode)
    want, feed = [np.asarray(logits)], []
    for _ in range(STEPS):
        nxt = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:,
                                                                      None]
        feed.append(np.array(nxt))
        logits, cache = decode(params, nxt, cache)
        want.append(np.asarray(logits))
    return want, feed


def port_run(arch: str, np_params, feed, batch_size: int = BATCH,
             max_len: int = MAX_LEN):
    """The unsharded port on the same parameters, teacher-forced with
    ``feed``: every call's logits, the cache after the prefill and after
    the last step, and the routing it recorded."""
    cfg = port_cfg(arch)
    model = Model(cfg)
    params = lm_params_from_numpy(np_params, cfg, "cpu")
    batch = {"tokens": torch.from_numpy(prompts(batch_size))}
    recorded = []

    def keep(probs, experts):
        recorded.append(experts.clone())
        return experts
    with moe.routing_hook(keep):
        cache = model.init_cache(params, batch, max_len)
        logits, cache = model.prefill(params, batch, cache)
        out = [logits]
        caches = [tree.map(torch.clone, cache["slots"])]
        for tok in feed:
            logits, cache = model.decode(params, torch.from_numpy(tok), cache)
            out.append(logits)
        caches.append(cache["slots"])
    return {"logits": out, "caches": caches, "routing": recorded,
            "len": int(cache["len"]), "pos": cache["pos"]}


def _replayer(recorded: list, part, batch_size: int):
    """Replays ``recorded`` (the unsharded run's experts, in call order)
    on this participant's rows: its data block of each call's slots, or
    every slot where the batch does not divide over the data axes."""
    calls = iter(recorded)

    def hook(probs, experts):
        rec = next(calls)
        if not lm.rows_part(part, batch_size).rows_split:
            return rec
        return rec.reshape(part.dp, -1, experts.shape[-1])[part.di]
    return hook


def _filled(cache: dict) -> int | None:
    """The positions of this participant's block of the first attention
    slot that hold a k (None: no attention slot)."""
    slot = next((s for s in cache["slots"].values() if "k" in s), None)
    if slot is None:
        return None
    return int(slot["k"].ne(0).flatten(3).any(-1).any(0).any(0).sum())


def _serve(part, arch: str, np_params, feed, routing, control=None,
           gathered: bool = True, batch_size: int = BATCH,
           max_len: int = MAX_LEN) -> dict:
    """Prefill and teacher-forced decode steps of ``arch`` on this
    participant, ``control`` patched into the steps; the steps' calls of
    the decode kernel's statistics form counted."""
    cfg = port_cfg(arch)
    model = Model(cfg)
    params = lm_shard_from_numpy(np_params, cfg, part.mesh, part.coord,
                                 "cpu")
    batch = {"tokens": torch.from_numpy(prompts(batch_size))}
    caches, filled = [], []
    stats = mock.patch.object(ops, "mha_decode_stats",
                              wraps=ops.mha_decode_stats)
    with moe.routing_hook(_replayer(routing, part, batch_size)):
        cache = model.init_cache(params, batch, max_len, shards=part)
        logits, cache = model.prefill(params, batch, cache, shards=part)
        out = [logits]
        filled.append(_filled(cache))
        if gathered:
            caches.append(gather_cache(cache, cfg, part,
                                       batch_size)["slots"])
        with (control_patch(control) if control else nullcontext()), \
                stats as stats_calls:
            for tok in feed:
                logits, cache = model.decode(params, torch.from_numpy(tok),
                                             cache, shards=part)
                out.append(logits)
    filled.append(_filled(cache))
    if gathered:
        caches.append(gather_cache(cache, cfg, part, batch_size)["slots"])
    return {"logits": out, "caches": caches, "len": int(cache["len"]),
            "pos": cache["pos"], "shas": [sha(t) for t in out],
            "filled": filled, "stats_calls": stats_calls.call_count,
            "cache": cache, "model": model, "params": params}


def _full_cache(run: dict, part, batch_size: int = BATCH,
                max_len: int = MAX_LEN) -> str | None:
    """Decode into the case's cache until it is full; the error raised
    by the step past it."""
    model, params, cache = run["model"], run["params"], run["cache"]
    tok = torch.zeros((batch_size, 1), dtype=torch.int32)
    while cache["pos"] < max_len:
        _, cache = model.decode(params, tok, cache, shards=part)
    try:
        model.decode(params, tok, cache, shards=part)
    except IndexError as e:
        return f"IndexError: {e}"
    return None


def _record_case(part, arch: str, np_params, batch_size: int) -> dict:
    """Each ``(kind, operand bytes)`` this rank's collectives report in the
    prefill and in one decode step of ``arch`` (a batch of
    ``batch_size``)."""
    cfg = port_cfg(arch)
    model = Model(cfg)
    params = lm_shard_from_numpy(np_params, cfg, part.mesh, part.coord,
                                 "cpu")
    batch = {"tokens": torch.from_numpy(prompts(batch_size))}
    cache = model.init_cache(params, batch, MAX_LEN, shards=part)
    out = {"prefill": [], "decode": []}
    with observe(lambda kind, n: out["prefill"].append((kind, n))):
        _, cache = model.prefill(params, batch, cache, shards=part)
    with observe(lambda kind, n: out["decode"].append((kind, n))):
        model.decode(params, batch["tokens"][:, :1], cache, shards=part)
    return out


def _rank_cases(rank: int, store: str, refs: dict) -> dict:
    torch.set_num_threads(1)
    dm = init_ranks(mesh_of("2x2"), rank, store)
    meshes = {name: dm if name == "2x2" else mesh_of(name).device_mesh()
              for name in MESHES}
    out = {"records": {}, "coords": {}}
    for name, mesh in meshes.items():
        part = Participant(mesh)
        out["coords"][name] = part.coord
        for arch in RECORD_ARCHS:
            for b in RECORD_BATCHES:
                out["records"][name, arch, b] = _record_case(
                    part, arch, refs[arch]["params"], b)
    for (arch, mesh_name), layout in CASES.items():
        part = Participant(meshes[mesh_name])
        ref = refs[arch]
        run = _serve(part, arch, ref["params"], ref["feed"], ref["routing"])
        case = {k: run[k] for k in ("logits", "caches", "len", "pos",
                                    "shas")}
        case.update(coord=part.coord, di=part.di, dp=part.dp)
        if (arch, mesh_name) in FULL_CASES:
            case["full"] = _full_cache(run, part)
        case["controls"] = {
            name: _serve(part, arch, ref["params"], ref["feed"],
                         ref["routing"], name, gathered=False)["logits"]
            for name in controls(arch, layout, part.m)}
        out[arch, mesh_name] = case
    for (arch, mesh_name, batch), layout in FS_CASES.items():
        part = Participant(meshes[mesh_name])
        ref = refs[arch, batch]
        kw = dict(batch_size=batch, max_len=FS_MAX_LEN)
        run = _serve(part, arch, ref["params"], ref["feed"], ref["routing"],
                     **kw)
        case = {k: run[k] for k in ("logits", "caches", "len", "pos",
                                    "shas", "filled", "stats_calls")}
        case.update(coord=part.coord, di=part.di, dp=part.dp)
        if (arch, mesh_name, batch) in FS_FULL_CASES:
            case["full"] = _full_cache(run, part, **kw)
        if (arch, mesh_name, batch) in FS_RECORD_CASES:
            case["records"] = _record_case(part, arch, ref["params"], batch)
        case["controls"] = {
            name: _serve(part, arch, ref["params"], ref["feed"],
                         ref["routing"], name, gathered=False,
                         **kw)["logits"]
            for name in controls(arch, layout, part.m)}
        out[arch, mesh_name, batch] = case
    return out


@pytest.fixture(scope="module")
def reference():
    """Keyed by arch (``CASES``' batch and cache) and by (arch, batch)
    (``FS_CASES``' cache)."""
    out = {}
    for arch in ARCHS:
        params = np_params(arch)
        want, feed = jax_run(arch, params)
        out[arch] = {"params": params, "jax": want, "feed": feed,
                     "port": port_run(arch, params, feed)}
    for arch, batch in sorted({(a, b) for a, _, b in FS_CASES}):
        params = out[arch]["params"] if arch in out else np_params(arch)
        want, feed = jax_run(arch, params, batch, FS_MAX_LEN)
        out[arch, batch] = {"params": params, "jax": want, "feed": feed,
                            "port": port_run(arch, params, feed, batch,
                                             FS_MAX_LEN)}
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("sharded_serve") / "store")
    refs = {a: {"params": r["params"], "feed": r["feed"],
                "routing": r["port"]["routing"]}
            for a, r in reference.items()}
    return run_ranks(_rank_cases, WORLD, store, refs, timeout_s=JOIN_S)


def rows(t, case: dict):
    n = BATCH // case["dp"]
    return t[case["di"] * n:(case["di"] + 1) * n]


@pytest.mark.parametrize("arch,mesh_name", list(CASES), ids=CASE_IDS)
def test_sharded_logits_equal_the_unsharded_port(ranks, reference, arch,
                                                 mesh_name):
    want = reference[arch]["port"]["logits"]
    for r in ranks:
        case = r[arch, mesh_name]
        assert len(case["logits"]) == STEPS + 1
        for call, (g, w) in enumerate(zip(case["logits"], want,
                                          strict=True)):
            assert g.shape == (BATCH // case["dp"], 1, 256)
            assert rel_rms(g, rows(w, case)) <= REL_RMS, (case["coord"],
                                                          call)


@pytest.mark.parametrize("arch,mesh_name", list(CASES), ids=CASE_IDS)
def test_sharded_greedy_tokens_equal_the_unsharded_port(ranks, reference,
                                                        arch, mesh_name):
    want = reference[arch]["port"]["logits"]
    for r in ranks:
        case = r[arch, mesh_name]
        for g, w in zip(case["logits"], want, strict=True):
            assert torch.equal(g[:, -1].argmax(-1),
                               rows(w, case)[:, -1].argmax(-1))


@pytest.mark.parametrize("arch,mesh_name", list(CASES), ids=CASE_IDS)
def test_gathered_cache_equals_the_unsharded_cache(ranks, reference, arch,
                                                   mesh_name):
    port = reference[arch]["port"]
    for r in ranks:
        case = r[arch, mesh_name]
        assert case["len"] == port["len"] == PROMPT + STEPS
        assert case["pos"] == port["pos"]
        for got, want in zip(case["caches"], port["caches"], strict=True):
            for g, w in zip(tree.leaves(got), tree.leaves(want),
                            strict=True):
                assert g.shape == w.shape
                assert rel_rms(g, w) <= REL_RMS, case["coord"]


@pytest.mark.parametrize("arch,mesh_name", list(CASES), ids=CASE_IDS)
def test_sharded_logits_match_jax(ranks, reference, arch, mesh_name):
    want = reference[arch]["jax"]
    for r in ranks:
        case = r[arch, mesh_name]
        for call, (g, w) in enumerate(zip(case["logits"], want,
                                          strict=True)):
            np.testing.assert_allclose(
                g.numpy(), rows(w, case), **LOGIT_TOL,
                err_msg=f"{arch} {mesh_name} {case['coord']} call {call}")


@pytest.mark.parametrize("arch,mesh_name", list(CASES), ids=CASE_IDS)
def test_each_control_leaves_the_limit(ranks, reference, arch, mesh_name):
    names = controls(arch, CASES[arch, mesh_name], model_size(mesh_name))
    assert names
    want = reference[arch]["port"]["logits"]
    for r in ranks:
        case = r[arch, mesh_name]
        assert sorted(case["controls"]) == sorted(names)
        for name, logits in case["controls"].items():
            assert rel_rms(logits[0], rows(want[0], case)) <= REL_RMS
            worst = max(rel_rms(g, rows(w, case))
                        for g, w in zip(logits[1:], want[1:], strict=True))
            assert worst > REL_RMS, (name, case["coord"], worst)


@pytest.mark.parametrize("arch,mesh_name", list(CASES), ids=CASE_IDS)
def test_model_participants_of_a_data_group_return_the_same_bits(
        ranks, arch, mesh_name):
    groups: dict = {}
    for r in ranks:
        case = r[arch, mesh_name]
        groups.setdefault(case["di"], set()).add(
            (tuple(case["shas"]), case["len"], case["pos"]))
    assert len(groups) == math.prod(MESHES[mesh_name][0][:-1])
    assert all(len(v) == 1 for v in groups.values())


@pytest.mark.parametrize("case", FULL_CASES, ids=lambda c: "-".join(c))
def test_a_full_cache_raises_index_error_on_every_rank(ranks, case):
    for r in ranks:
        assert r[case]["full"] is not None
        assert r[case]["full"].startswith("IndexError")


# -- the fully-seq layout on four ranks ---------------------------------------

fs_cases = pytest.mark.parametrize("arch,mesh_name,batch", list(FS_CASES),
                                   ids=FS_IDS)


@fs_cases
def test_fully_seq_logits_equal_the_unsharded_port(ranks, reference, arch,
                                                   mesh_name, batch):
    want = reference[arch, batch]["port"]["logits"]
    for r in ranks:
        case = r[arch, mesh_name, batch]
        assert len(case["logits"]) == STEPS + 1
        for call, (g, w) in enumerate(zip(case["logits"], want,
                                          strict=True)):
            assert g.shape == (batch, 1, 256)
            assert rel_rms(g, w) <= REL_RMS, (case["coord"], call)
            assert torch.equal(g[:, -1].argmax(-1), w[:, -1].argmax(-1))


@fs_cases
def test_fully_seq_gathered_cache_equals_the_unsharded_cache(
        ranks, reference, arch, mesh_name, batch):
    port = reference[arch, batch]["port"]
    for r in ranks:
        case = r[arch, mesh_name, batch]
        assert case["len"] == port["len"] == PROMPT + STEPS
        assert case["pos"] == port["pos"]
        for got, want in zip(case["caches"], port["caches"], strict=True):
            for g, w in zip(tree.leaves(got), tree.leaves(want),
                            strict=True):
                assert g.shape == w.shape
                assert rel_rms(g, w) <= REL_RMS, case["coord"]


@fs_cases
def test_fully_seq_logits_match_jax(ranks, reference, arch, mesh_name,
                                    batch):
    want = reference[arch, batch]["jax"]
    for r in ranks:
        case = r[arch, mesh_name, batch]
        for call, (g, w) in enumerate(zip(case["logits"], want,
                                          strict=True)):
            np.testing.assert_allclose(
                g.numpy(), w, **LOGIT_TOL,
                err_msg=f"{arch} {mesh_name} {case['coord']} call {call}")


@fs_cases
def test_fully_seq_each_control_leaves_the_limit(ranks, reference, arch,
                                                 mesh_name, batch):
    names = controls(arch, FS_CASES[arch, mesh_name, batch],
                     model_size(mesh_name))
    assert names
    want = reference[arch, batch]["port"]["logits"]
    for r in ranks:
        case = r[arch, mesh_name, batch]
        assert sorted(case["controls"]) == sorted(names)
        for name, logits in case["controls"].items():
            assert rel_rms(logits[0], want[0]) <= REL_RMS
            worst = max(rel_rms(g, w)
                        for g, w in zip(logits[1:], want[1:], strict=True))
            assert worst > REL_RMS, (name, case["coord"], worst)


@fs_cases
def test_fully_seq_every_rank_returns_the_same_bits(ranks, arch, mesh_name,
                                                    batch):
    got = {(tuple(r[arch, mesh_name, batch]["shas"]),
            r[arch, mesh_name, batch]["len"],
            r[arch, mesh_name, batch]["pos"]) for r in ranks}
    assert len(got) == 1


@fs_cases
def test_fully_seq_blocks_hold_their_positions(ranks, arch, mesh_name,
                                               batch):
    """Each data participant's block holds the prompt's positions that
    fall in it after the prefill and the steps' after the last step (rank
    2's block empty at the prefill, rank 3's throughout on dp 4); the
    statistics form runs once per attention layer and step on every rank
    in the whole-head form, its empty blocks too, and never in the
    ``head_dim`` one."""
    layout = FS_CASES[arch, mesh_name, batch]
    cfg = port_cfg(arch)
    n_attn = sum(s.mixer == "attn" for s in cfg.pattern()) * cfg.n_blocks
    for r in ranks:
        case = r[arch, mesh_name, batch]
        if layout is None:
            assert case["filled"] == [None, None]
        else:
            assert tuple(case["filled"]) == FS_FILLED[case["dp"]][
                case["di"]], case["coord"]
        want = STEPS * n_attn if layout == "seq" else 0
        assert case["stats_calls"] == want, case["coord"]


@pytest.mark.parametrize("case", FS_FULL_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_fully_seq_full_cache_raises_index_error_on_every_rank(ranks, case):
    for r in ranks:
        assert (r[case]["full"] or "").startswith("IndexError")


# -- the collectives on meta: the dry run's count -----------------------------

def meta_record(arch: str, mesh, coord: dict, batch_size: int) -> dict:
    """Each ``(kind, operand bytes)`` of the prefill and of one decode
    step of ``arch`` run on ``meta`` over ``MetaShards`` at ``coord``."""
    cfg = meta_cfg(arch)
    model = Model(cfg)
    whole = model.abstract_params()
    params = shard_tree(whole, param_shardings(whole, cfg, mesh), coord)
    part = Participant(MetaShards(mesh, coord))
    batch = {"tokens": torch.empty((batch_size, PROMPT), dtype=torch.int32,
                                   device="meta")}
    cache = model.init_cache(params, batch, MAX_LEN, shards=part)
    out = {"prefill": [], "decode": []}
    with observe(lambda kind, n: out["prefill"].append((kind, n))):
        _, cache = model.prefill(params, batch, cache, shards=part)
    with observe(lambda kind, n: out["decode"].append((kind, n))):
        logits, _ = model.decode(params, batch["tokens"][:, :1], cache,
                                 shards=part)
    assert logits.device.type == "meta"
    return out


@pytest.mark.parametrize("batch", RECORD_BATCHES)
@pytest.mark.parametrize("arch", RECORD_ARCHS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_the_meta_count_is_every_rank_record(ranks, mesh_name, arch, batch):
    """Call for call: kind, order and one participant's operand bytes, in
    the prefill and in a decode step."""
    mesh = mesh_of(mesh_name)
    # a step moves something where the model axis splits the layers, the
    # blocks of the positions are combined across the data axes, or the
    # MoE load is averaged over them
    cfg, dp = port_cfg(arch), dp_size(mesh)
    split = batch % dp == 0
    attends = any(s.mixer == "attn" for s in cfg.pattern())
    moves = model_size(mesh_name) > 1 or dp > 1 and (
        (not split and attends) or (split and cfg.moe_experts > 0))
    for r in ranks:
        got = r["records"][mesh_name, arch, batch]
        want = meta_record(arch, mesh, r["coords"][mesh_name], batch)
        assert bool(got["decode"]) == moves
        assert got == want, (mesh_name, r["coords"][mesh_name])


@pytest.mark.parametrize("arch,mesh_name,batch", FS_RECORD_CASES,
                         ids=[f"{a}-{m}-b{b}" for a, m, b in FS_RECORD_CASES])
def test_the_fully_seq_meta_count_is_every_rank_record(ranks, arch,
                                                        mesh_name, batch):
    """The fully-seq cases outside ``RECORD_ARCHS`` / ``RECORD_BATCHES``
    (jamba's attention and SSM slots on both meshes, granite's batch of
    2), call for call."""
    mesh = mesh_of(mesh_name)
    for r in ranks:
        case = r[arch, mesh_name, batch]
        want = meta_record(arch, mesh, case["coord"], batch)
        assert case["records"] == want, (mesh_name, case["coord"])
        assert want["decode"]
