"""The encoder-decoder sharded: seamless-m4t's train step, forward,
``init_cache``, prefill and decode with ``shards=``, one participant a
rank.

The JAX package shards the encoder-decoder by its rules (every leaf by
name; ``batch_specs(..., encdec=True)`` splits ``enc_embeds`` over the
data axes; the cache's ``k`` / ``v``, self and cross alike, take the
attention layout's spec).  The port runs it one participant a process
(``models/encdec.py``): the encoder's non-causal self-attention and the
decoder's causal one on the participant's heads, cross-attention on its
query heads with k / v projected from the encoder's output on the kv
heads they read, the vocabulary-parallel embedding, head and loss.  Here,
on the CPU at smoke size (2 + 2 layers, d 64, 4 heads of 16) with the
kernels' plain versions, one spawn of 4 gloo ranks runs seamless on
(2, 2), (1, 4) and (2, 1, 2) (4 kv heads: the head-sharded cache) and a
2-kv-head variant on (1, 4) (the ``head_dim``-sharded cache):

- the sharded loss and gathered gradients (the controls: the encoder's
  output read by the cross-attention outside the model region, so that
  its gradient is not summed over ``"model"``; and, where ``wk`` / ``wv``
  are replicated, the partial leaves not summed), the forward's logits,
  and the prefill's and teacher-forced decode steps' logits and the
  gathered self and cross caches, against the unsharded port (1e-4
  relative RMS, the chip run's float32 limit), and the logits against the
  JAX package's forward, prefill and decode on the same numpy parameters
  (``LOGIT_TOL``);
- a serving control, which must leave the limit: in the head-sharded
  layout every participant's cross K/V projected from participant 0's
  kv heads (its block of ``wk`` / ``wv`` in every participant's place), in
  the ``head_dim``-sharded one the partial scores not summed over
  ``"model"``;
- the model participants of a data group return the same bits, and a
  full self cache raises ``IndexError`` on every rank;
- every rank's collectives in one train step, the prefill and one decode
  step equal those of the same calls on ``meta`` over ``MetaShards`` at
  its coordinate (the dry run's count: the cache is built outside the
  count), call for call;
- a batch that no data axis divides (the fully-seq layout: every rank
  takes every row, and the self cache's positions and the cross cache's
  encoder positions split over the data axes) serves in both forms: kv4
  on (4, 1) (``"seq"``, whole heads, the decode kernel's statistics form
  over each block) at batch 1 and 2, kv4 and kv2 on (2, 2) (``"seq_hd"``,
  ``head_dim`` blocks) at batch 1, into a self cache of ``FS_MAX_LEN``
  (blocks of 8, 8, 8 and 6 on dp 4: the prompt fills ranks 0 and 1, the
  steps write into rank 2's block, rank 3's stays empty) over ``FRAMES``
  encoder positions (blocks of 2 on dp 4, 4 on dp 2).  Each case is held
  as above (logits, greedy tokens and the gathered self and cross caches
  against the unsharded port, logits against the JAX package, the meta
  count), every rank returns the same bits, and each control leaves the
  limit: the self block's ``cache_len`` not offset by its start
  (``"seq"``), the blocks averaged with equal weights, and the cross
  cache cut at encoder position 0 on every rank (a step's cross offset
  alone cannot show: every encoder position is valid); a length that
  leaves a block of either cache empty raises ``ValueError`` on every
  rank before any collective.

Run: ``PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q
tests/test_torch_sharded_encdec.py``; on the card, ``python3
chip_smoke.py --shard`` runs seamless's sharded cases at full width.
"""
from __future__ import annotations

import hashlib
import math
from contextlib import nullcontext
from dataclasses import replace
from unittest import mock

import numpy as np
import pytest
import torch

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
from repro_torch.models import Model, encdec, layers, smoke_variant
from repro_torch.parallel.collectives import MetaShards, observe, unobserved
from repro_torch.parallel.sharding import (
    cache_layout,
    gather_tree,
    param_shardings,
    shard_tree,
)
from repro_torch.parallel.tensor import Participant
from repro_torch.train import (
    AdamWConfig,
    abstract_state,
    adamw_init,
    make_train_step,
    state_shardings,
)
from repro_torch.train import step as train_step

ARCH = "seamless_m4t_medium"
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
#: the variants' kv heads: the smoke config's 4, and 2 (``head_dim``
#: blocks on a model axis of 4)
VARIANTS = {"kv4": 4, "kv2": 2}
#: (variant, mesh): the cache layout the case takes
CASES = {("kv4", "2x2"): "head", ("kv4", "1x4"): "head",
         ("kv4", "2x1x2"): "head", ("kv2", "1x4"): "hd"}
CASE_IDS = [f"{v}-{m}" for v, m in CASES]
#: The fully-seq cases, (variant, mesh, batch): the caches' layout, in a
#: self cache of ``FS_MAX_LEN`` positions.
FS_CASES = {("kv4", "4x1", 1): "seq", ("kv4", "4x1", 2): "seq",
            ("kv4", "2x2", 1): "seq_hd", ("kv2", "2x2", 1): "seq_hd"}
FS_IDS = [f"{v}-{m}-b{b}" for v, m, b in FS_CASES]
FS_MAX_LEN = 30
WORLD = 4
JOIN_S = 300.0
KERNEL_PATHS = dict(attention_impl="cuda", moe_impl="gmm", ssm_impl="cuda",
                    remat=True)
#: ``chip_smoke.py``'s float32 limits
LOSS_RTOL = 1e-6
REL_RMS = 1e-4
#: the JAX comparison's, as ``tests/test_torch_serve.py`` holds the
#: unsharded port
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, SEQ, FRAMES, STEPS = 4, 16, 8, 3
MAX_LEN = SEQ + STEPS + 1
#: each data participant's block of the fully-seq self cache: the
#: positions it holds after the prefill and after the last step, by dp
FS_FILLED = {4: [(8, 8), (8, 8), (0, STEPS), (0, 0)],
             2: [(15, 15), (SEQ - 15, SEQ - 15 + STEPS)]}
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)


def port_cfg(variant: str):
    return replace(smoke_variant(get_config(ARCH)),
                   n_kv_heads=VARIANTS[variant], **KERNEL_PATHS)


def meta_cfg(variant: str):
    """:func:`port_cfg` with the attention form that takes ``meta``
    tensors at smoke size (K2 / K3's wrappers check their shapes on meta
    and take head_dim 64 / 128 only); no collective depends on it."""
    return replace(port_cfg(variant), attention_impl="dense")


def mesh_of(name: str):
    return make_mesh(*MESHES[name])


def rel_rms(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().reshape(-1)
                          .view(torch.uint8).numpy().tobytes()).hexdigest()


def np_params(variant: str) -> dict:
    """Seeded parameters as the JAX package holds them, the norm scales
    perturbed so that they count."""
    out = lm_params_to_numpy(Model(port_cfg(variant)).init(
        torch.Generator().manual_seed(5), device="cpu"))
    rng = np.random.default_rng(5)
    for blocks in ("enc_blocks", "dec_blocks"):
        for slot in out[blocks].values():
            slot["norm_scale"] = (slot["norm_scale"] + rng.normal(
                0.0, 0.1, slot["norm_scale"].shape)).astype(np.float32)
    for name in ("enc_final_norm", "final_norm"):
        out[name] = (out[name] + rng.normal(0.0, 0.1, out[name].shape)
                     ).astype(np.float32)
    return out


def np_batch(batch: int = BATCH) -> dict:
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :5] = -1
    frames = rng.normal(0.0, 1.0, (BATCH, FRAMES, 64)).astype(np.float32)
    return {"tokens": tokens[:batch], "labels": labels[:batch],
            "enc_embeds": frames[:batch]}


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


# -- on this process -----------------------------------------------------------

LAYOUT_CASES = [(v, m, BATCH, layout) for (v, m), layout in CASES.items()]
LAYOUT_CASES += [(v, m, b, layout) for (v, m, b), layout in FS_CASES.items()]


@pytest.mark.parametrize("variant,mesh_name,batch,layout", LAYOUT_CASES,
                         ids=[f"{v}-{m}-b{b}" for v, m, b, _ in LAYOUT_CASES])
def test_the_cases_take_their_layouts(variant, mesh_name, batch, layout):
    assert cache_layout(port_cfg(variant), mesh_of(mesh_name),
                        batch) == layout


# -- four ranks ---------------------------------------------------------------

def unentered_encoder_output():
    """The training control: the encoder's output read by the decoder's
    cross-attention without entering the model region, so its gradient
    (and every encoder leaf's) is not summed over ``"model"``."""
    return mock.patch.object(encdec, "enter_model_region",
                             lambda x, part: x)


def _grads(part, cfg, params_np, batch, control: bool = False) -> dict:
    model = Model(cfg)
    local = lm_shard_from_numpy(params_np, cfg, part.mesh, part.coord, "cpu")
    like = lm_params_from_numpy(params_np, cfg, "cpu")
    sh = param_shardings(like, cfg, part.mesh)
    partial = train_step.partial_grad_leaves(sh)
    with (unentered_encoder_output() if control else nullcontext()):
        metrics, grads = train_step.sharded_grads(model, local,
                                                  torch_batch(batch), part)
    whole = train_step.psum_partial(grads, partial, part)
    out = {"loss": float(metrics["loss"]),
           "grads": gather_tree(whole, sh, part.shards, like),
           "partial_leaves": sum(partial)}
    if not control:
        out["unsummed"] = gather_tree(grads, sh, part.shards, like)
    return out


def _forward(part, cfg, params_np, batch) -> torch.Tensor:
    local = lm_shard_from_numpy(params_np, cfg, part.mesh, part.coord, "cpu")
    rows = train_step.batch_rows(torch_batch(batch), cfg, part)
    with torch.no_grad():
        logits, _ = Model(cfg).forward(local, rows, shards=part)
    return logits


def cross_from_participant_0(local, cfg, params_np, mesh):
    """The control's parameters: ``local`` with every layer's cross
    ``wk`` / ``wv`` replaced by participant 0's block of them."""
    first = lm_shard_from_numpy(params_np, cfg, mesh,
                                {a: 0 for a in mesh.axis_names}, "cpu")
    out = tree.map(lambda t: t, local)
    for name in ("wk", "wv"):
        out["dec_blocks"]["cross_attn"][name] = \
            first["dec_blocks"]["cross_attn"][name]
    return out


def _serve(part, cfg, params_np, feed, control: str | None = None,
           full: bool = False) -> dict:
    model = Model(cfg)
    local = lm_shard_from_numpy(params_np, cfg, part.mesh, part.coord, "cpu")
    if control == "cross_from_participant_0":
        local = cross_from_participant_0(local, cfg, params_np, part.mesh)
    patch = (mock.patch.object(layers, "sum_partial_scores",
                               lambda scores, p: scores)
             if control == "unsummed_scores" else nullcontext())
    b = torch_batch(np_batch())
    batch = {"tokens": b["tokens"], "enc_embeds": b["enc_embeds"]}
    out = {"logits": [], "caches": []}
    with patch:
        cache = model.init_cache(local, batch, MAX_LEN, shards=part)
        logits, cache = model.prefill(local, batch, cache, shards=part)
        out["logits"].append(logits)
        out["caches"].append(_gathered(cache, cfg, part))
        for tok in feed:
            logits, cache = model.decode(local, torch.from_numpy(tok), cache,
                                         shards=part)
            out["logits"].append(logits)
    out["caches"].append(_gathered(cache, cfg, part))
    out["len"], out["pos"] = int(cache["len"]), cache["pos"]
    if full:
        tok = torch.zeros((BATCH, 1), dtype=torch.int32)
        while cache["pos"] < MAX_LEN:
            _, cache = model.decode(local, tok, cache, shards=part)
        try:
            model.decode(local, tok, cache, shards=part)
            out["full"] = None
        except IndexError as e:
            out["full"] = f"IndexError: {e}"
    return out


def _gathered(cache, cfg, part) -> dict:
    g = gather_cache(cache, cfg, part, BATCH)
    return {"self": g["self"], "cross": g["cross"],
            "cross_len": int(g["cross_len"])}


def _records(part, cfg, params_np) -> dict:
    """Each ``(kind, operand bytes)`` of one train step, the prefill and
    one decode step on this rank (the cache built outside the count)."""
    model = Model(cfg)
    params = lm_params_from_numpy(params_np, cfg, "cpu")
    sh = state_shardings(abstract_state(model, OPT), cfg, part.mesh)
    state = shard_tree({"params": params, "opt": adamw_init(params)}, sh,
                       part.coord)
    step = make_train_step(model, OPT, shards=part, shardings=sh)
    out = {"train": [], "prefill": [], "decode": []}
    b = torch_batch(np_batch())
    with observe(lambda kind, n: out["train"].append((kind, n))):
        step(state, b)
    local = lm_shard_from_numpy(params_np, cfg, part.mesh, part.coord, "cpu")
    batch = {"tokens": b["tokens"], "enc_embeds": b["enc_embeds"]}
    _serve_records(model, local, batch, part, out)
    return out


def _serve_records(model, params, batch, part, out: dict,
                   max_len: int = MAX_LEN) -> None:
    with observe(lambda kind, n: out.setdefault("init", []).append(
            (kind, n))), unobserved():
        cache = model.init_cache(params, batch, max_len, shards=part)
    with observe(lambda kind, n: out["prefill"].append((kind, n))):
        _, cache = model.prefill(params, batch, cache, shards=part)
    with observe(lambda kind, n: out["decode"].append((kind, n))):
        model.decode(params, batch["tokens"][:, :1], cache, shards=part)


def _case(part, variant, refs, mesh_name) -> dict:
    cfg = port_cfg(variant)
    ref = refs[variant]
    control = ("cross_from_participant_0"
               if CASES[variant, mesh_name] == "head" else "unsummed_scores")
    return {"coord": part.coord, "di": part.di, "dp": part.dp,
            "grads": _grads(part, cfg, ref["params"], np_batch()),
            "grads_control": _grads(part, cfg, ref["params"], np_batch(),
                                    True)["grads"],
            "forward": _forward(part, cfg, ref["params"], np_batch()),
            "serve": _serve(part, cfg, ref["params"], ref["feed"],
                            full=mesh_name == "2x2"),
            "control": control,
            "serve_control": _serve(part, cfg, ref["params"], ref["feed"],
                                    control)["logits"],
            "records": _records(part, cfg, ref["params"])}


def fs_controls(layout: str) -> list[str]:
    """A fully-seq case's controls: each breaks one step of the sharded
    serving, so its logits must leave the limit."""
    return (["unoffset_cache_len"] if layout == "seq" else []) + [
        "equal_block_weights", "cross_cut_at_0"]


def fs_control(name: str):
    """The patch that makes fully-seq control ``name``, around every
    serving call: the self block's ``cache_len`` not offset by its start,
    the blocks' softmax averaged with equal weights, or every
    participant's cross cache cut at encoder position 0 (its block's
    length, the offset dropped: a step's cross offset alone changes
    nothing, since every encoder position is valid)."""
    if name == "unoffset_cache_len":
        block_len = layers.block_cache_len
        return mock.patch.object(layers, "block_cache_len",
                                 lambda c, s_lo, n: block_len(c, 0, n))
    if name == "equal_block_weights":
        return mock.patch.object(layers, "combine_blocks",
                                 lambda o, m, l: o.mean(dim=0))
    block = encdec.cross_block

    def at_0(part, frames):
        lo, hi = block(part, frames)
        return 0, hi - lo
    return mock.patch.object(encdec, "cross_block", at_0)


def _filled(cache: dict) -> int:
    """The positions of this participant's self block that hold a k."""
    return int(cache["self"]["k"].ne(0).flatten(3).any(-1).any(0).any(0)
               .sum())


def _serve_fs(part, cfg, params_np, feed, batch: int,
              control: str | None = None) -> dict:
    """The prefill and teacher-forced steps of a batch of ``batch`` into a
    cache of ``FS_MAX_LEN``, ``control`` patched around every call; the
    decode kernel's statistics-form calls counted."""
    model = Model(cfg)
    local = lm_shard_from_numpy(params_np, cfg, part.mesh, part.coord, "cpu")
    b = torch_batch(np_batch(batch))
    whole = {"tokens": b["tokens"], "enc_embeds": b["enc_embeds"]}
    stats = mock.patch.object(ops, "mha_decode_stats",
                              wraps=ops.mha_decode_stats)
    out = {"logits": [], "caches": [], "filled": []}
    with (fs_control(control) if control else nullcontext()), \
            stats as stats_calls:
        cache = model.init_cache(local, whole, FS_MAX_LEN, shards=part)
        logits, cache = model.prefill(local, whole, cache, shards=part)
        out["logits"].append(logits)
        out["filled"].append(_filled(cache))
        if control is None:
            out["caches"].append(gather_cache(cache, cfg, part, batch))
        for tok in feed:
            logits, cache = model.decode(local, torch.from_numpy(tok), cache,
                                         shards=part)
            out["logits"].append(logits)
    out["filled"].append(_filled(cache))
    if control is None:
        out["caches"].append(gather_cache(cache, cfg, part, batch))
    out.update(len=int(cache["len"]), pos=cache["pos"],
               shas=[sha(t) for t in out["logits"]],
               stats_calls=stats_calls.call_count)
    return out


def _fs_case(part, variant: str, ref: dict, batch: int, layout: str) -> dict:
    cfg = port_cfg(variant)
    run = _serve_fs(part, cfg, ref["params"], ref["feed"], batch)
    run["caches"] = [{"self": c["self"], "cross": c["cross"],
                      "cross_len": int(c["cross_len"])}
                     for c in run["caches"]]
    records = {"prefill": [], "decode": []}
    b = torch_batch(np_batch(batch))
    _serve_records(Model(cfg), lm_shard_from_numpy(
        ref["params"], cfg, part.mesh, part.coord, "cpu"),
        {"tokens": b["tokens"], "enc_embeds": b["enc_embeds"]}, part,
        records, FS_MAX_LEN)
    return {**run, "coord": part.coord, "di": part.di, "dp": part.dp,
            "layout": cache_layout(cfg, part.mesh, batch),
            "controls": {name: _serve_fs(part, cfg, ref["params"],
                                         ref["feed"], batch, name)["logits"]
                         for name in fs_controls(layout)},
            "records": records}


#: (which cache, frames, self cache length): a length that leaves a block
#: of that cache empty on dp 4 and on dp 2
EMPTY_BLOCKS = {"self": (FRAMES, {4: 5, 2: 1}),
                "cross": ({4: 3, 2: 1}, FS_MAX_LEN)}


def _empty_blocks(part, params_np) -> dict:
    """Each ``init_cache`` that leaves a block empty on ``part``'s mesh: the
    error it raised and the collectives observed before it."""
    cfg = port_cfg("kv4")
    model = Model(cfg)
    local = lm_shard_from_numpy(params_np, cfg, part.mesh, part.coord, "cpu")
    out = {}
    for which, (frames, max_len) in EMPTY_BLOCKS.items():
        frames = frames[part.dp] if isinstance(frames, dict) else frames
        max_len = max_len[part.dp] if isinstance(max_len, dict) else max_len
        b = torch_batch(np_batch(1))
        batch = {"tokens": b["tokens"],
                 "enc_embeds": b["enc_embeds"][:, :frames]}
        seen: list = []
        try:
            with observe(lambda kind, n: seen.append(kind)):
                model.init_cache(local, batch, max_len, shards=part)
            out[which] = (None, seen)
        except ValueError as e:
            out[which] = (str(e), seen)
    return out


def _rank_cases(rank: int, store: str, refs: dict) -> dict:
    torch.set_num_threads(1)
    dm = init_ranks(mesh_of("2x2"), rank, store)
    meshes = {name: dm if name == "2x2" else mesh_of(name).device_mesh()
              for name in MESHES}
    out = {(v, m): _case(Participant(meshes[m]), v, refs, m)
           for v, m in CASES}
    for (v, m, b), layout in FS_CASES.items():
        out[v, m, b] = _fs_case(Participant(meshes[m]), v, refs[v, b], b,
                                layout)
    out["empty"] = {m: _empty_blocks(Participant(meshes[m]),
                                     refs["kv4"]["params"])
                    for m in ("4x1", "2x2")}
    return out


def jax_run(variant: str, params: dict, batch: int = BATCH,
            max_len: int = MAX_LEN, forward: bool = True):
    """The JAX package's forward (None without ``forward``), jitted
    prefill and greedy decode steps on ``params``, a batch of ``batch``
    into a cache of ``max_len``: the forward's and each call's logits,
    and the tokens the steps fed.  (JAX is imported here: the rank
    processes import this module and need only the port.)"""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config
    from repro.models import Model as RefModel
    from repro.models import smoke_variant as ref_smoke

    model = RefModel(replace(ref_smoke(ref_config(ARCH)),
                             n_kv_heads=VARIANTS[variant]))
    params = jax.tree.map(jnp.asarray, params)
    b = {k: jnp.asarray(v) for k, v in np_batch(batch).items()}
    if forward:
        forward = np.asarray(jax.jit(model.forward)(params, b)[0])
    cache = model.init_cache(params, b, max_len)
    logits, cache = jax.jit(model.prefill)(params, b, cache)
    decode = jax.jit(model.decode)
    want, feed = [np.asarray(logits)], []
    for _ in range(STEPS):
        nxt = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:,
                                                                      None]
        feed.append(np.array(nxt))
        logits, cache = decode(params, nxt, cache)
        want.append(np.asarray(logits))
    return forward, want, feed


def port_run(variant: str, params_np: dict, feed) -> dict:
    cfg = port_cfg(variant)
    model = Model(cfg)
    params = lm_params_from_numpy(params_np, cfg, "cpu")
    b = torch_batch(np_batch())
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    loss, _ = model.loss(tree.unflatten(params, leaves), b)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        forward, _ = model.forward(params, b)
    return {"loss": float(loss.detach()), "grads": list(grads),
            "forward": forward, **port_serve(variant, params_np, feed)}


def port_serve(variant: str, params_np: dict, feed, batch: int = BATCH,
               max_len: int = MAX_LEN) -> dict:
    """The unsharded port's prefill and teacher-forced steps: each call's
    logits and the cache after the prefill and after the last step."""
    cfg = port_cfg(variant)
    model = Model(cfg)
    params = lm_params_from_numpy(params_np, cfg, "cpu")
    b = torch_batch(np_batch(batch))
    batch_ = {"tokens": b["tokens"], "enc_embeds": b["enc_embeds"]}
    cache = model.init_cache(params, batch_, max_len)
    logits, cache = model.prefill(params, batch_, cache)

    def caches(c):
        return {"self": tree.map(torch.clone, c["self"]),
                "cross": tree.map(torch.clone, c["cross"]),
                "cross_len": int(c["cross_len"])}
    out = {"logits": [logits], "caches": [caches(cache)]}
    for tok in feed:
        logits, cache = model.decode(params, torch.from_numpy(tok), cache)
        out["logits"].append(logits)
    out["caches"].append(caches(cache))
    out["len"], out["pos"] = int(cache["len"]), cache["pos"]
    return out


@pytest.fixture(scope="module")
def reference():
    out = {}
    for variant in sorted({v for v, _ in CASES}):
        params = np_params(variant)
        forward, want, feed = jax_run(variant, params)
        out[variant] = {"params": params, "feed": feed,
                        "jax_forward": forward, "jax": want,
                        "port": port_run(variant, params, feed)}
    for variant, batch in sorted({(v, b) for v, _, b in FS_CASES}):
        params = out[variant]["params"]
        _, want, feed = jax_run(variant, params, batch, FS_MAX_LEN,
                                forward=False)
        out[variant, batch] = {
            "params": params, "feed": feed, "jax": want,
            "port": port_serve(variant, params, feed, batch, FS_MAX_LEN)}
    return out


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("sharded_encdec") / "store")
    refs = {k: {"params": r["params"], "feed": r["feed"]}
            for k, r in reference.items()}
    return run_ranks(_rank_cases, WORLD, store, refs, timeout_s=JOIN_S)


def rows(t, case: dict):
    n = t.shape[0] // case["dp"]
    return t[case["di"] * n:(case["di"] + 1) * n]


cases = pytest.mark.parametrize("variant,mesh_name", list(CASES),
                                ids=CASE_IDS)


@cases
def test_sharded_gradients_equal_the_unsharded_port(ranks, reference,
                                                    variant, mesh_name):
    want = reference[variant]["port"]
    for r in ranks:
        got = r[variant, mesh_name]["grads"]
        assert abs(got["loss"] - want["loss"]) / abs(want["loss"]) \
            <= LOSS_RTOL
        for g, w in zip(tree.leaves(got["grads"]), want["grads"],
                        strict=True):
            assert g.shape == w.shape
            assert rel_rms(g, w) <= REL_RMS


@cases
def test_without_the_model_sums_the_gradients_leave_the_limit(
        ranks, reference, variant, mesh_name):
    """The encoder's output not entering the model region breaks every
    case; the partial leaves (the cross and self ``wk`` / ``wv``,
    replicated where the kv heads do not divide the model axis) not summed
    over ``"model"`` break the cases that have them (none where the kv
    heads shard: every leaf read in a region is then sharded)."""
    want = reference[variant]["port"]["grads"]
    for r in ranks:
        case = r[variant, mesh_name]
        controls = [case["grads_control"]]
        if case["grads"]["partial_leaves"]:
            controls.append(case["grads"]["unsummed"])
        assert bool(case["grads"]["partial_leaves"]) == (variant == "kv2")
        for got in controls:
            worst = max(rel_rms(g, w) for g, w in zip(
                tree.leaves(got), want, strict=True))
            assert worst > REL_RMS, (case["coord"], worst)


@cases
def test_sharded_forward_logits_equal_the_port_and_jax(ranks, reference,
                                                       variant, mesh_name):
    ref = reference[variant]
    for r in ranks:
        case = r[variant, mesh_name]
        got = case["forward"]
        assert got.shape == (BATCH // case["dp"], SEQ, 256)
        assert rel_rms(got, rows(ref["port"]["forward"], case)) <= REL_RMS
        np.testing.assert_allclose(got.numpy(),
                                   rows(ref["jax_forward"], case),
                                   **LOGIT_TOL)


@cases
def test_sharded_serving_equals_the_port_and_jax(ranks, reference, variant,
                                                 mesh_name):
    ref = reference[variant]
    for r in ranks:
        case = r[variant, mesh_name]
        serve = case["serve"]
        assert len(serve["logits"]) == STEPS + 1
        for call, (g, w, j) in enumerate(zip(serve["logits"],
                                             ref["port"]["logits"],
                                             ref["jax"], strict=True)):
            assert g.shape == (BATCH // case["dp"], 1, 256)
            assert rel_rms(g, rows(w, case)) <= REL_RMS, (case["coord"],
                                                          call)
            assert torch.equal(g[:, -1].argmax(-1),
                               rows(w, case)[:, -1].argmax(-1))
            np.testing.assert_allclose(g.numpy(), rows(j, case),
                                       **LOGIT_TOL)
        assert serve["len"] == ref["port"]["len"] == SEQ + STEPS
        assert serve["pos"] == ref["port"]["pos"]
        for got, want in zip(serve["caches"], ref["port"]["caches"],
                             strict=True):
            assert got["cross_len"] == want["cross_len"] == FRAMES - 1
            for name in ("self", "cross"):
                for k in ("k", "v"):
                    assert got[name][k].shape == want[name][k].shape
                    assert rel_rms(got[name][k], want[name][k]) <= REL_RMS


@cases
def test_the_serving_control_leaves_the_limit(ranks, reference, variant,
                                              mesh_name):
    want = reference[variant]["port"]["logits"]
    for r in ranks:
        case = r[variant, mesh_name]
        worst = max(rel_rms(g, rows(w, case)) for g, w in
                    zip(case["serve_control"], want, strict=True))
        assert worst > REL_RMS, (case["control"], case["coord"], worst)


@cases
def test_model_participants_of_a_data_group_return_the_same_bits(
        ranks, variant, mesh_name):
    groups: dict = {}
    for r in ranks:
        case = r[variant, mesh_name]
        groups.setdefault(case["di"], set()).add(
            (tuple(sha(t) for t in case["serve"]["logits"]),
             sha(case["forward"]), case["grads"]["loss"]))
    assert len(groups) == math.prod(MESHES[mesh_name][0][:-1])
    assert all(len(v) == 1 for v in groups.values())


def test_a_full_self_cache_raises_index_error_on_every_rank(ranks):
    for r in ranks:
        assert (r["kv4", "2x2"]["serve"]["full"] or "").startswith(
            "IndexError")


def meta_records(variant: str, mesh, coord: dict) -> dict:
    """:func:`_records`' calls on ``meta`` over ``MetaShards`` at
    ``coord``."""
    cfg = meta_cfg(variant)
    model = Model(cfg)
    abstract = abstract_state(model, OPT)
    sh = state_shardings(abstract, cfg, mesh)
    part = Participant(MetaShards(mesh, coord))
    step = make_train_step(model, OPT, shards=part, shardings=sh)
    b = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                        device="meta") for k, v in np_batch().items()}
    out = {"train": [], "prefill": [], "decode": []}
    with observe(lambda kind, n: out["train"].append((kind, n))):
        step(shard_tree(abstract, sh, coord), b)
    params = shard_tree(abstract["params"], sh["params"], coord)
    _serve_records(model, params, {"tokens": b["tokens"],
                                   "enc_embeds": b["enc_embeds"]}, part, out)
    return out


@cases
def test_the_meta_count_is_every_rank_record(ranks, variant, mesh_name):
    """Call for call, in a train step, the prefill and a decode step;
    nothing is counted while the cache is built."""
    mesh = mesh_of(mesh_name)
    for r in ranks:
        case = r[variant, mesh_name]
        want = meta_records(variant, mesh, case["coord"])
        assert case["records"] == want, case["coord"]
        assert "init" not in want
        assert all(want[k] for k in ("train", "prefill", "decode"))


# -- the fully-seq layout on four ranks ---------------------------------------

fs_cases = pytest.mark.parametrize("variant,mesh_name,batch", list(FS_CASES),
                                   ids=FS_IDS)


@fs_cases
def test_fully_seq_logits_equal_the_port_and_jax(ranks, reference, variant,
                                                 mesh_name, batch):
    ref = reference[variant, batch]
    for r in ranks:
        case = r[variant, mesh_name, batch]
        assert case["layout"] == FS_CASES[variant, mesh_name, batch]
        assert len(case["logits"]) == STEPS + 1
        for call, (g, w, j) in enumerate(zip(case["logits"],
                                             ref["port"]["logits"],
                                             ref["jax"], strict=True)):
            assert g.shape == (batch, 1, 256)
            assert rel_rms(g, w) <= REL_RMS, (case["coord"], call)
            assert torch.equal(g[:, -1].argmax(-1), w[:, -1].argmax(-1))
            np.testing.assert_allclose(g.numpy(), j, **LOGIT_TOL)


@fs_cases
def test_fully_seq_gathered_caches_equal_the_unsharded_caches(
        ranks, reference, variant, mesh_name, batch):
    port = reference[variant, batch]["port"]
    for r in ranks:
        case = r[variant, mesh_name, batch]
        assert case["len"] == port["len"] == SEQ + STEPS
        assert case["pos"] == port["pos"]
        for got, want in zip(case["caches"], port["caches"], strict=True):
            assert got["cross_len"] == want["cross_len"] == FRAMES - 1
            for name in ("self", "cross"):
                for k in ("k", "v"):
                    assert got[name][k].shape == want[name][k].shape
                    assert rel_rms(got[name][k], want[name][k]) <= REL_RMS


@fs_cases
def test_fully_seq_each_control_leaves_the_limit(ranks, reference, variant,
                                                 mesh_name, batch):
    want = reference[variant, batch]["port"]["logits"]
    names = fs_controls(FS_CASES[variant, mesh_name, batch])
    for r in ranks:
        case = r[variant, mesh_name, batch]
        assert sorted(case["controls"]) == sorted(names)
        for name, logits in case["controls"].items():
            worst = max(rel_rms(g, w) for g, w in zip(logits, want,
                                                      strict=True))
            assert worst > REL_RMS, (name, case["coord"], worst)


@fs_cases
def test_fully_seq_every_rank_returns_the_same_bits(ranks, variant,
                                                    mesh_name, batch):
    got = {(tuple(r[variant, mesh_name, batch]["shas"]),
            r[variant, mesh_name, batch]["len"]) for r in ranks}
    assert len(got) == 1


@fs_cases
def test_fully_seq_blocks_hold_their_positions(ranks, variant, mesh_name,
                                               batch):
    """Each data participant's self block holds the prompt positions that
    fall in it after the prefill and the steps' after the last step; the
    statistics form runs twice per layer and step (self and cross) on
    every rank in ``"seq"``, its empty self blocks too, and never in
    ``"seq_hd"``."""
    layout = FS_CASES[variant, mesh_name, batch]
    n_layers = port_cfg(variant).n_layers
    for r in ranks:
        case = r[variant, mesh_name, batch]
        assert tuple(case["filled"]) == FS_FILLED[case["dp"]][case["di"]]
        want = 2 * n_layers * STEPS if layout == "seq" else 0
        assert case["stats_calls"] == want, case["coord"]


@fs_cases
def test_fully_seq_meta_count_is_every_rank_record(ranks, variant,
                                                   mesh_name, batch):
    """Call for call, in the prefill and a decode step; the blocks'
    statistics gathered over the data axes in every step."""
    mesh = mesh_of(mesh_name)
    for r in ranks:
        case = r[variant, mesh_name, batch]
        cfg = meta_cfg(variant)
        model = Model(cfg)
        whole = model.abstract_params()
        coord = case["coord"]
        params = shard_tree(whole, param_shardings(whole, cfg, mesh), coord)
        b = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                            device="meta")
             for k, v in np_batch(batch).items()}
        want = {"prefill": [], "decode": []}
        _serve_records(model, params, {"tokens": b["tokens"],
                                       "enc_embeds": b["enc_embeds"]},
                       Participant(MetaShards(mesh, coord)), want,
                       FS_MAX_LEN)
        assert case["records"] == want, coord
        assert want["decode"]


@pytest.mark.parametrize("which", list(EMPTY_BLOCKS))
@pytest.mark.parametrize("mesh_name", ["4x1", "2x2"])
def test_a_length_that_leaves_a_block_empty_raises_on_every_rank(
        ranks, mesh_name, which):
    for r in ranks:
        error, seen = r["empty"][mesh_name][which]
        assert error and f"a {which} cache" in error and "empty" in error
        assert seen == []
