"""The sharded train step: ``make_train_step(..., shards=, shardings=)``
against the unsharded step and the JAX package's gradient.

The JAX package jits its train step with ``in_shardings`` from
``state_shardings`` on a ``("data", "model")`` mesh; the port runs the
step one participant a process, on its block of the state
(``parallel/sharding.py`` ``shard_tree``), with the collectives written
out (``parallel/tensor.py``).  Here, on the CPU with the kernels' plain
versions at smoke size:

- ``shard_tree`` / ``gather_tree`` round-trip every leaf of every arch's
  smoke train state (ZeRO-1 moments included) at meshes (2, 2), (1, 4)
  and the three-axis ``("pod", "data", "model")`` (2, 1, 2) and
  (2, 2, 1), and a tree of uneven leaves; no leaf of the ten configs at
  their published size is uneven at a model axis of 4;
- a (1, 1) mesh gives the unsharded step's state and metrics byte for
  byte, and the encoder-decoder's loss and gradients (its multi-rank
  cases are ``tests/test_torch_sharded_encdec.py``);
- one spawn of 4 gloo ranks (a ``FileStore`` under the test's temporary
  directory) runs granite-moe (kv heads sharded), glm4 (smoke kv 1,
  replicated), mamba2 and jamba on every mesh above (the batch over pod
  × data on the three-axis ones), the same numpy parameters and batch:
  the loss, the metrics
  and every gathered gradient leaf are held to the unsharded port
  (``LOSS_RTOL`` relative, ``GRAD_REL_RMS`` relative RMS, the chip run's
  float32 limits) and to ``jax.value_and_grad`` of the reference's loss;
  a control, the same gradients without the sum over ``"model"`` of the
  partial ones, must exceed them; the sharded ``inner_norm`` equals the
  unsharded one and a per-block norm does not; two steps on (2, 2) with
  ``accum=2``, ZeRO-1 and without: moments equal the unsharded step's,
  ZeRO-1's slices and parameters equal the others' bit for bit, and
  every participant holding a block holds its bits; a routing recorded
  unsharded replays in the sharded run;
- every rank's collectives in one train step (with and without ZeRO-1) of
  granite-moe, glm4 and mamba2 on every mesh, call for call (kind, order,
  operand bytes), equal those of the same step run on ``meta`` over
  ``MetaShards`` at the rank's coordinate (the dry run's count); the
  MoE's row-count stand-in on meta changes no record;
- a bf16 region end with a model axis of 2 or 4 is the float32 sum of the
  participants' float32 partials in shard order, rounded once;
- ``compress=True``: ``ef_compress_sharded`` on every participant's block
  is ``ef_compress`` of the whole leaves cut to it, byte for byte, at
  model 2 and 4, cuts on the first and a later dim and sizes off the
  256-element blocks; three sharded compressed steps of mamba2
  (``accum=2``) on (2, 2) and (2, 1, 2), each from the unsharded port's
  state before it: the compressed gradient of every step byte-equal to
  ``ef_compress`` of the gathered one (scales taken per shard, without
  the max over ``"model"``, break it), and the state after each held to
  the unsharded port's and to the JAX package's step from the same state
  by the ≥ 99 % rule of ``tests/test_torch_train.py``.  (Chained, the
  sharded steps leave that rule from the second step on: a gradient that
  sums in another order rounds an element to the neighbouring int8 value
  in the first step, and the second step's gradients all move with it.)
"""
from __future__ import annotations

import hashlib
import itertools
from dataclasses import replace
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from conftest import requires_grad_through_barrier

import repro.models.lm as ref_lm
from repro.configs import get_config as ref_config
from repro.models import smoke_variant as ref_smoke
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import (
    lm_params_from_numpy,
    lm_params_to_numpy,
    lm_shard_from_numpy,
)
from repro_torch.launch.mesh import init_ranks, make_mesh, run_ranks
from repro_torch.models import Model, lm, moe, smoke_variant
from repro_torch.models.layers import rmsnorm
from repro_torch.models.ssd import sharded_rmsnorm
from repro_torch.parallel import compress as port_compress
from repro_torch.parallel.collectives import ListShards, MetaShards, observe
from repro_torch.parallel.sharding import (
    NamedSharding,
    entry_axes,
    gather_tree,
    param_shardings,
    shard_shape,
    shard_slices,
    shard_tree,
    spec,
)
from repro_torch.parallel.tensor import Participant, leave_model_region_product
from repro_torch.train import (
    AdamWConfig,
    abstract_state,
    adamw_init,
    init_state,
    make_train_step,
    state_shardings,
)
from repro_torch.train import step as train_step

ARCHS = ("granite_moe_1b_a400m", "glm4_9b", "mamba2_130m", "jamba_v0_1_52b")
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
#: the archs whose collectives are recorded (``RECORD_ARCHS``) and the
#: meshes of the sharded compressed steps
RECORD_ARCHS = ("granite_moe_1b_a400m", "glm4_9b", "mamba2_130m")
#: the meshes whose model axis splits anything
MODEL_MESHES = [n for n, (shape, _) in MESHES.items() if shape[-1] > 1]
COMPRESS_ARCH = "mamba2_130m"
COMPRESS_MESHES = ("2x2", "2x1x2")
COMPRESS_STEPS = 3
WORLD = 4
JOIN_S = 300.0
KERNEL_PATHS = dict(attention_impl="cuda", moe_impl="gmm", ssm_impl="cuda",
                    remat=True)
#: ``chip_smoke.py``'s float32 limits (``train_path``'s ``grad_f32``).
LOSS_RTOL = 1e-6
GRAD_REL_RMS = 1e-4
#: The JAX comparison's, as ``tests/test_torch_train.py`` holds the
#: unsharded port: loss relative, each leaf's largest difference over its
#: largest magnitude.
JAX_LOSS_RTOL = 1e-5
JAX_GRAD_TOL = 1e-4
BATCH, SEQ = 4, 16
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)


def port_cfg(arch: str):
    """The smoke config on its kernel paths (their plain versions on CPU
    tensors), under remat."""
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


def np_batch(vocab: int, seed: int) -> dict:
    """Next-token rows whose last label is ignored; the first row ignores
    five more, so the data participants hold unequal valid counts."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :5] = -1
    return {"tokens": tokens, "labels": labels}


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def rel_rms(got, want) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().reshape(-1).view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


# -- shard_tree and gather_tree -----------------------------------------------

def smoke_state(arch: str):
    cfg = smoke_variant(get_config(arch))
    model = Model(cfg)
    state = init_state(model, torch.Generator().manual_seed(1), OPT,
                       device="cpu")
    gen = torch.Generator().manual_seed(2)
    state["opt"] = state["opt"]._replace(
        m=tree.map(lambda t: torch.randn(t.shape, generator=gen),
                   state["opt"].m))
    return cfg, model, state


def round_trip(tree_, shardings, mesh) -> None:
    sh = ListShards(mesh)
    parts = [shard_tree(tree_, shardings, c) for c in sh.coords]
    for part in parts:
        for leaf, s, block in zip(tree.leaves(tree_), tree.leaves(shardings),
                                  tree.leaves(part)):
            assert all(b <= c for b, c in zip(block.shape,
                                               shard_shape(leaf.shape, s)))
    back = gather_tree(parts, shardings, sh, tree_)
    for got, want in zip(tree.leaves(back), tree.leaves(tree_), strict=True):
        assert same(got, want)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_and_gather_round_trip_every_leaf(arch, mesh_name):
    cfg, model, state = smoke_state(arch)
    mesh = mesh_of(mesh_name)
    shardings = state_shardings(abstract_state(model, OPT), cfg, mesh,
                                zero_opt=True)
    round_trip(state, shardings, mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_uneven_leaves_round_trip_with_the_last_blocks_shorter(mesh_name):
    mesh = mesh_of(mesh_name)
    gen = torch.Generator().manual_seed(3)
    shapes = {"a": ((5, 3), spec("model", None)),
              "b": ((7,), spec(("data", "model"))),
              "c": ((3, 9), spec("data", "model")),
              "d": ((2, 6), spec(None, "model"))}
    tree_ = {k: torch.randn(s, generator=gen) for k, (s, _) in shapes.items()}
    shardings = {k: NamedSharding(mesh, p) for k, (_, p) in shapes.items()}
    round_trip(tree_, shardings, mesh)
    last = shard_tree(tree_, shardings, {a: n - 1
                                         for a, n in mesh.shape.items()})
    n = mesh.shape["data"] * mesh.shape["model"]
    assert last["b"].numel() < -(-7 // n)          # the last block shorter


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_no_leaf_of_the_published_configs_is_uneven_at_model_4(arch):
    """At a model axis of 4 every parameter leaf of the ten configs at
    their published size divides evenly (the uneven case is the tree
    above)."""
    cfg = get_config(arch)
    mesh = make_mesh((1, 4), ("data", "model"))
    abstract = Model(cfg).abstract_params()
    uneven = [path for (path, leaf), sh in zip(
        tree.leaves_with_path(abstract),
        tree.leaves(param_shardings(abstract, cfg, mesh)))
        if any(d % int(np.prod([mesh.shape[a] for a in entry_axes(e)]))
               for d, e in zip(leaf.shape, sh.spec))]
    assert uneven == []


def test_layers_refuse_a_model_axis_that_splits_heads():
    """Attention heads and experts must divide the model axis; the SSD's
    heads need not (a participant runs its block of ``d_inner``:
    mamba2-130m's 24 heads on 16 are 1.5 a participant), its channels
    must."""
    lm.check_shardable(smoke_variant(get_config("glm4_9b")), 4)
    with pytest.raises(NotImplementedError, match="n_heads"):
        lm.check_shardable(smoke_variant(get_config("glm4_9b")), 8)
    with pytest.raises(NotImplementedError, match="moe_experts"):
        lm.check_shardable(smoke_variant(
            get_config("granite_moe_1b_a400m")), 8)
    cfg = get_config("mamba2_130m")
    assert cfg.ssm_heads % 16 and cfg.d_inner % 16 == 0
    lm.check_shardable(cfg, 16)
    with pytest.raises(NotImplementedError, match="d_inner"):
        lm.check_shardable(replace(smoke_variant(cfg), d_model=20), 16)


# -- one shard: the unsharded bits --------------------------------------------

@pytest.mark.parametrize("form", ["plain", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_one_by_one_mesh_is_the_unsharded_step_byte_for_byte(arch, form):
    cfg = smoke_variant(get_config(arch))
    if form == "kernels":
        cfg = replace(cfg, **KERNEL_PATHS)
    model = Model(cfg)
    state = init_state(model, torch.Generator().manual_seed(0), OPT,
                       device="cpu")
    batch = torch_batch(np_batch(cfg.vocab, 0))
    mesh = make_mesh((1, 1), ("data", "model"))
    shardings = state_shardings(abstract_state(model, OPT), cfg, mesh,
                                zero_opt=True)
    for accum in (1, 2):
        want_state, want = make_train_step(model, OPT, accum)(state, batch)
        got_state, got = make_train_step(
            model, OPT, accum, shards=mesh, shardings=shardings)(
            shard_tree(state, shardings, {"data": 0, "model": 0}), batch)
        assert got.keys() == want.keys()
        assert all(same(got[k], want[k]) for k in want), accum
        for a, b in zip(tree.leaves(got_state), tree.leaves(want_state),
                        strict=True):
            assert same(a, b), accum


# -- four ranks ---------------------------------------------------------------

def np_params(arch: str):
    """Seeded smoke parameters as the JAX package holds them (nested dicts
    of numpy arrays), for both packages."""
    return lm_params_to_numpy(Model(smoke_variant(get_config(arch))).init(
        torch.Generator().manual_seed(0), device="cpu"))


def _grads_case(part, arch, np_params, batch, routing=None):
    """Loss, metrics and the gathered gradients with and without the sum
    over ``"model"`` of the partial leaves, of ``arch`` on this rank."""
    cfg = port_cfg(arch)
    model = Model(cfg)
    local = lm_shard_from_numpy(np_params, cfg, part.mesh, part.coord, "cpu")
    like = lm_params_from_numpy(np_params, cfg, "cpu")
    sh = param_shardings(like, cfg, part.mesh)
    hook = (moe.routing_hook(_replayer(routing, part)) if routing is not None
            else _nothing())
    with hook:
        metrics, grads = train_step.sharded_grads(
            model, local, torch_batch(batch), part)
    whole = train_step.psum_partial(
        grads, train_step.partial_grad_leaves(sh), part)
    return {"metrics": {k: v.clone() for k, v in metrics.items()},
            "grads": gather_tree(whole, sh, part.shards, like),
            "control": gather_tree(grads, sh, part.shards, like)}


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _replayer(recorded: list, part):
    """Replays ``recorded`` (the unsharded run's experts, in call order)
    on this participant's rows (its data block of the tokens)."""
    calls = iter(recorded)

    def hook(probs, experts):
        rec = next(calls)
        n = rec.shape[0] // part.dp
        return rec[part.di * n:(part.di + 1) * n]
    return hook


def _norm_case(part):
    """The sharded ``inner_norm`` on this rank's block of seeded inputs:
    its block of the output and of the input's gradient, and a per-block
    norm's output."""
    gen = torch.Generator().manual_seed(7)
    n = 32
    x = torch.randn((2, 3, n), generator=gen)
    scale = torch.rand(n, generator=gen) + 0.5
    w = torch.randn((2, 3, n), generator=gen)
    lo, hi = part.block(n)
    xb = x[..., lo:hi].clone().requires_grad_()
    out = sharded_rmsnorm(xb, scale[lo:hi], n, part)
    (gx,) = torch.autograd.grad((out * w[..., lo:hi]).sum(), xb)
    return {"block": (lo, hi), "out": out.detach(), "grad": gx,
            "per_block": rmsnorm(x[..., lo:hi], scale[lo:hi])}


def _step_case(part, np_params, batches):
    """Two sharded steps of granite-moe on (2, 2), ``accum=2``, with and
    without ZeRO-1: each step's metrics, the local moments and
    parameters, every leaf's hash, and the gathered moments of step 1
    without ZeRO-1."""
    arch = "granite_moe_1b_a400m"
    cfg = port_cfg(arch)
    model = Model(cfg)
    params = lm_params_from_numpy(np_params, cfg, "cpu")
    full = {"params": params, "opt": adamw_init(params)}
    out = {}
    for zero in (False, True):
        sh = state_shardings(abstract_state(model, OPT), cfg, part.mesh,
                             zero_opt=zero)
        state = shard_tree(full, sh, part.coord)
        step = make_train_step(model, OPT, 2, shards=part, shardings=sh)
        runs = []
        for b in batches:
            state, metrics = step(state, torch_batch(b))
            runs.append({"metrics": dict(metrics), "state": state,
                         "hashes": [sha(t) for t in tree.leaves(state)]})
        if not zero:
            runs[0]["gathered_opt"] = gather_tree(
                runs[0]["state"]["opt"], sh["opt"], part.shards,
                full["opt"])
        out[zero] = {"runs": runs, "specs": [s.spec for s in
                                             tree.leaves(sh)],
                     "m_specs": [s.spec for s in tree.leaves(sh["opt"].m)]}
    return out


def _record_case(part, arch: str, np_params, batch) -> dict:
    """Each ``(kind, operand bytes)`` this rank's collectives report in
    one sharded train step of ``arch``, without and with ZeRO-1."""
    cfg = port_cfg(arch)
    model = Model(cfg)
    params = lm_params_from_numpy(np_params, cfg, "cpu")
    full = {"params": params, "opt": adamw_init(params)}
    out = {}
    for zero in (False, True):
        sh = state_shardings(abstract_state(model, OPT), cfg, part.mesh,
                             zero_opt=zero)
        step = make_train_step(model, OPT, shards=part, shardings=sh)
        state = shard_tree(full, sh, part.coord)
        record: list = []
        with observe(lambda kind, n: record.append((kind, n))):
            step(state, torch_batch(batch))
        out[zero] = record
    return out


def _fault1_case(part) -> dict:
    """A bf16 region end of a product on this rank's block of seeded
    operands: ``a [2, 3, 24]`` cut along its last dim, ``w [24, 5]`` by
    rows."""
    gen = torch.Generator().manual_seed(11)
    a = torch.randn((2, 3, 24), generator=gen).to(torch.bfloat16)
    w = torch.randn((24, 5), generator=gen).to(torch.bfloat16)
    lo, hi = part.block(24)
    out = leave_model_region_product(torch.matmul, part, a[..., lo:hi],
                                     w[lo:hi])
    return {"out": out, "m": part.m, "a": a, "w": w}


class _Captured:
    """``ef_compress_sharded`` as the step calls it, its inputs and
    outputs kept."""

    def __init__(self) -> None:
        self.calls: list = []
        self.fn = port_compress.ef_compress_sharded

    def __call__(self, grads, residual, shardings, like, part):
        out = self.fn(grads, residual, shardings, like, part)
        self.calls.append((grads, residual, shardings, like, out))
        return out


class _PerShard(Participant):
    """A participant whose max over ``"model"`` is its own: the scales
    taken per shard (the control)."""

    def max_model(self, x):
        return x


def _compress_case(part, states: list, batches: list) -> dict:
    """A sharded compressed step of ``COMPRESS_ARCH`` (``accum=2``) from
    this participant's block of each of ``states`` on the batch of the
    same index: after each its metrics and the gathered state; the
    compressed gradient and residual gathered, the gathered inputs they
    were computed from, and the same with the scales taken per shard."""
    cfg = port_cfg(COMPRESS_ARCH)
    model = Model(cfg)
    sh = state_shardings(abstract_state(model, OPT, compress=True), cfg,
                         part.mesh)
    step = make_train_step(model, OPT, 2, compress=True, shards=part,
                           shardings=sh)
    cap = _Captured()
    control = _PerShard(part.shards)
    runs = []
    with mock.patch.object(train_step, "ef_compress_sharded", cap):
        for state, b in zip(states, batches, strict=True):
            local, metrics = step(shard_tree(state, sh, part.coord),
                                  torch_batch(b))
            grads, residual, g_sh, like, (deq, res) = cap.calls[-1]
            c_deq, c_res = port_compress.ef_compress_sharded(
                grads, residual, g_sh, like, control)

            def whole(t):
                return gather_tree(t, g_sh, part.shards, like)
            runs.append({"metrics": dict(metrics),
                         "state": gather_tree(local, sh, part.shards,
                                              state),
                         "grads": whole(grads), "residual": whole(residual),
                         "deq": whole(deq), "res": whole(res),
                         "control": whole(c_deq)})
    # ZeRO-1 cuts the moments after the compression: the same bits
    zsh = state_shardings(abstract_state(model, OPT, compress=True), cfg,
                          part.mesh, zero_opt=True)
    zstep = make_train_step(model, OPT, 2, compress=True, shards=part,
                            shardings=zsh)
    zero = [gather_tree(zstep(shard_tree(state, zsh, part.coord),
                              torch_batch(b))[0], zsh, part.shards, state)
            for state, b in zip(states, batches, strict=True)]
    return {"runs": runs, "calls": len(cap.calls), "zero1": zero,
            "zero1_cut": [s_.spec for s_ in tree.leaves(zsh["opt"].m)]
            != [s_.spec for s_ in tree.leaves(sh["opt"].m)]}


def _rank_cases(rank: int, store: str, np_params: dict, batches: list,
                routing: list, compress_states: list) -> dict:
    torch.set_num_threads(1)
    dm = init_ranks(mesh_of("2x2"), rank, store)
    meshes = {name: dm if name == "2x2" else mesh_of(name).device_mesh()
              for name in MESHES}
    out = {"rank": rank, "grads": {}, "norm": {}, "records": {},
           "fault1": {}, "compress": {}, "coords": {}}
    for name, mesh in meshes.items():
        part = Participant(mesh)
        out["coords"][name] = part.coord
        out["norm"][name] = _norm_case(part)
        out["fault1"][name] = _fault1_case(part)
        for arch in RECORD_ARCHS:
            out["records"][name, arch] = _record_case(
                part, arch, np_params[arch], batches[0])
        if name in COMPRESS_MESHES:
            out["compress"][name] = _compress_case(
                part, compress_states, batches + [batches[0]])
        for arch in ARCHS:
            out["grads"][name, arch] = _grads_case(part, arch,
                                                   np_params[arch],
                                                   batches[0])
        cfg = port_cfg("jamba_v0_1_52b")
        with torch.no_grad():
            logits, aux = Model(cfg).forward(
                lm_shard_from_numpy(np_params["jamba_v0_1_52b"], cfg,
                                    part.mesh, part.coord, "cpu"),
                train_step.batch_rows(torch_batch(batches[0]), cfg, part),
                shards=part)
        out.setdefault("forward", {})[name] = {
            "logits": logits, "load": aux.expert_load, "di": part.di,
            "dp": part.dp}
    part = Participant(dm)
    out["coord"] = part.coord
    out["replay"] = _grads_case(part, "granite_moe_1b_a400m",
                                np_params["granite_moe_1b_a400m"],
                                batches[0], routing)
    out["step"] = _step_case(part, np_params["granite_moe_1b_a400m"],
                             batches)
    return out


def unsharded(arch: str, np_params, batch: dict, hook=None):
    cfg = port_cfg(arch)
    params = lm_params_from_numpy(np_params, cfg, "cpu")
    leaves = [p.requires_grad_() for p in tree.leaves(params)]
    with moe.routing_hook(hook) if hook else _nothing():
        loss, metrics = Model(cfg).loss(tree.unflatten(params, leaves),
                                        torch_batch(batch))
        grads = torch.autograd.grad(loss, leaves)
    return {k: v.detach() for k, v in metrics.items()}, grads


def _moved_routing(np_params, batch):
    """The unsharded run's routing with every expert moved to the next
    one (another routing than the router's own)."""
    recorded = []

    def keep(probs, experts):
        recorded.append((experts + 1) % probs.shape[-1])
        return recorded[-1]
    metrics, grads = unsharded("granite_moe_1b_a400m", np_params, batch,
                               keep)
    return recorded, metrics, grads


@pytest.fixture(scope="module")
def reference():
    params = {arch: np_params(arch) for arch in ARCHS}
    vocab = smoke_variant(get_config(ARCHS[0])).vocab
    batches = [np_batch(vocab, 0), np_batch(vocab, 1)]
    routing, moved_metrics, moved_grads = _moved_routing(
        params["granite_moe_1b_a400m"], batches[0])
    return {"params": params, "batches": batches, "routing": routing,
            "compress": compress_chain(batches + [batches[0]]),
            "moved": (moved_metrics, moved_grads),
            "unsharded": {arch: unsharded(arch, params[arch], batches[0])
                          for arch in ARCHS}}


def compress_chain(batches: list) -> dict:
    """The unsharded port's compressed steps (``accum=2``) over
    ``batches`` from a seeded state (JAX package numpy parameters, zero
    moments, a random residual so that the first step's correction
    counts): every state, the first included, and each step's
    metrics."""
    cfg = port_cfg(COMPRESS_ARCH)
    params = lm_params_from_numpy(np_params(COMPRESS_ARCH), cfg, "cpu")
    gen = torch.Generator().manual_seed(5)
    state = {"params": params, "opt": adamw_init(params),
             "ef": tree.map(lambda p: 1e-3 * torch.randn(
                 p.shape, generator=gen), params)}
    step = make_train_step(Model(cfg), OPT, 2, compress=True)
    states, metrics = [state], []
    for b in batches:
        state, m = step(state, torch_batch(b))
        states.append(state)
        metrics.append(m)
    return {"states": states, "metrics": metrics}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("sharded") / "store")
    return run_ranks(_rank_cases, WORLD, store, reference["params"],
                     reference["batches"], reference["routing"],
                     reference["compress"]["states"][:COMPRESS_STEPS],
                     timeout_s=JOIN_S)


def errors(got: dict, want) -> dict:
    """Loss and metric relative errors, each leaf's relative RMS."""
    metrics, grads = want
    return {"metrics": max(abs(float(got["metrics"][k]) - float(v))
                           / max(abs(float(v)), 1e-30)
                           for k, v in metrics.items()),
            "leaves": [rel_rms(g, w) for g, w in zip(
                tree.leaves(got["grads"]), grads, strict=True)],
            "control": [rel_rms(g, w) for g, w in zip(
                tree.leaves(got["control"]), grads, strict=True)]}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_gradients_equal_the_unsharded_step(ranks, reference, arch,
                                                    mesh_name):
    for r in ranks:
        got = r["grads"][mesh_name, arch]
        e = errors(got, reference["unsharded"][arch])
        assert e["metrics"] <= LOSS_RTOL, (r["rank"], e["metrics"])
        assert max(e["leaves"]) <= GRAD_REL_RMS, (r["rank"], e["leaves"])
        assert got["metrics"].keys() == reference["unsharded"][arch][0].keys()


@pytest.mark.parametrize("mesh_name", MODEL_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_without_the_model_sum_of_partial_gradients_the_step_fails(
        ranks, reference, arch, mesh_name):
    """The control: the partial leaves' gradients unsummed exceed the
    limit, and exactly the leaves ``partial_grad_leaves`` names differ
    (the norm scales ahead of a region come whole)."""
    cfg = port_cfg(arch)
    partial = train_step.partial_grad_leaves(param_shardings(
        Model(cfg).abstract_params(), cfg, mesh_of(mesh_name)))
    assert any(partial)
    for r in ranks:
        e = errors(r["grads"][mesh_name, arch], reference["unsharded"][arch])
        assert max(e["control"]) > GRAD_REL_RMS
        for flagged, err in zip(partial, e["control"], strict=True):
            assert (err > GRAD_REL_RMS) == flagged, (r["rank"], err)


@requires_grad_through_barrier
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_gradients_equal_jax_value_and_grad(ranks, reference, arch):
    rcfg = ref_smoke(ref_config(arch))
    params, batch = reference["params"][arch], reference["batches"][0]
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_lm.loss_fn(p, rcfg, b), has_aux=True))(params, batch)
    want = jax.tree.leaves(jax.tree.map(np.asarray, grads))
    for r in ranks:
        for mesh_name in MESHES:
            got = r["grads"][mesh_name, arch]
            assert float(got["metrics"]["loss"]) == pytest.approx(
                float(loss), rel=JAX_LOSS_RTOL)
            for k, v in metrics.items():
                assert float(got["metrics"][k]) == pytest.approx(
                    float(v), rel=JAX_LOSS_RTOL, abs=1e-7), k
            errs = [float(np.abs(g.numpy() - w).max()
                          / max(np.abs(w).max(), 1e-30))
                    for g, w in zip(tree.leaves(got["grads"]), want,
                                    strict=True)]
            assert max(errs) <= JAX_GRAD_TOL, (mesh_name, errs)


@pytest.mark.parametrize("mesh_name", MODEL_MESHES)
def test_sharded_inner_norm_is_the_whole_norm(ranks, mesh_name):
    gen = torch.Generator().manual_seed(7)
    n = 32
    x = torch.randn((2, 3, n), generator=gen)
    scale = torch.rand(n, generator=gen) + 0.5
    w = torch.randn((2, 3, n), generator=gen)
    xg = x.clone().requires_grad_()
    want = rmsnorm(xg, scale)
    (want_g,) = torch.autograd.grad((want * w).sum(), xg)
    for r in ranks:
        got = r["norm"][mesh_name]
        lo, hi = got["block"]
        assert hi - lo < n
        torch.testing.assert_close(got["out"], want[..., lo:hi].detach(),
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got["grad"], want_g[..., lo:hi],
                                   rtol=1e-5, atol=1e-6)
        assert rel_rms(got["per_block"], want[..., lo:hi].detach()) > 1e-2


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_forward_gathers_the_unsharded_logits(ranks, reference,
                                                      mesh_name):
    cfg = port_cfg("jamba_v0_1_52b")
    params = lm_params_from_numpy(reference["params"]["jamba_v0_1_52b"],
                                  cfg, "cpu")
    with torch.no_grad():
        want, aux = Model(cfg).forward(params,
                                       torch_batch(reference["batches"][0]))
    for r in ranks:
        got = r["forward"][mesh_name]
        rows = BATCH // got["dp"]
        assert got["logits"].shape == (rows, SEQ, cfg.vocab_padded)
        assert rel_rms(got["logits"], want[got["di"] * rows:
                                           (got["di"] + 1) * rows]) <= 1e-5
        torch.testing.assert_close(got["load"], aux.expert_load)


def test_the_encoder_decoder_runs_sharded_on_one_shard():
    """``Model.loss`` with ``shards=`` runs the encoder-decoder sharded (it
    raised before ``models/encdec.py`` took a participant): on a (1, 1)
    mesh its loss, metrics and gradients are the unsharded ones byte for
    byte (the multi-rank cases are ``tests/test_torch_sharded_encdec.py``)."""
    cfg = replace(smoke_variant(get_config("seamless_m4t_medium")),
                  **KERNEL_PATHS)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {**torch_batch(np_batch(cfg.vocab, 0)),
             "enc_embeds": torch.randn((BATCH, 4, cfg.d_model),
                                       generator=gen)}
    runs = []
    for shards in (None, make_mesh((1, 1), ("data", "model"))):
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        loss, metrics = model.loss(tree.unflatten(params, leaves), batch,
                                   shards=shards)
        runs.append((loss, metrics, torch.autograd.grad(loss, leaves)))
    (want, want_m, want_g), (got, got_m, got_g) = runs
    assert same(got.detach(), want.detach())
    assert got_m.keys() == want_m.keys()
    assert all(same(got_m[k].detach(), want_m[k].detach()) for k in want_m)
    assert all(same(g, w) for g, w in zip(got_g, want_g, strict=True))


def test_a_recorded_routing_replays_in_the_sharded_run(ranks, reference):
    metrics, grads = reference["moved"]
    own = reference["unsharded"]["granite_moe_1b_a400m"][0]
    assert abs(float(metrics["loss"]) - float(own["loss"])) > 1e-4
    for r in ranks:
        e = errors(r["replay"], (metrics, grads))
        assert e["metrics"] <= LOSS_RTOL
        assert max(e["leaves"]) <= GRAD_REL_RMS


def test_two_sharded_steps_keep_the_unsharded_moments(ranks, reference):
    cfg = port_cfg("granite_moe_1b_a400m")
    model = Model(cfg)
    params = lm_params_from_numpy(
        reference["params"]["granite_moe_1b_a400m"], cfg, "cpu")
    state = {"params": params, "opt": adamw_init(params)}
    step = make_train_step(model, OPT, 2)
    for i, b in enumerate(reference["batches"]):
        state, metrics = step(state, torch_batch(b))
        for r in ranks:
            got = r["step"][False]["runs"][i]["metrics"]
            for k in ("loss", "ce", "lb_loss", "z_loss"):
                assert float(got[k]) == pytest.approx(
                    float(metrics[k]), rel=LOSS_RTOL), (i, k)
            assert float(got["grad_norm"]) == pytest.approx(
                float(metrics["grad_norm"]), rel=GRAD_REL_RMS)
            assert float(got["lr"]) == float(metrics["lr"])
        if i == 0:
            for r in ranks:
                opt = r["step"][False]["runs"][0]["gathered_opt"]
                for got, want in ((opt.m, state["opt"].m),
                                  (opt.v, state["opt"].v)):
                    errs = [rel_rms(g, w) for g, w in zip(
                        tree.leaves(got), tree.leaves(want)) if w.norm() > 0]
                    assert max(errs) <= GRAD_REL_RMS


def test_zero1_slices_equal_the_unzeroed_step_bit_for_bit(ranks):
    for r in ranks:
        plain, zero = r["step"][False], r["step"][True]
        n_cut = 0
        for a, b in zip(plain["runs"], zero["runs"]):
            for p, z, sp, sz in zip(tree.leaves(a["state"]["opt"].m),
                                    tree.leaves(b["state"]["opt"].m),
                                    plain["m_specs"], zero["m_specs"],
                                    strict=True):
                if sp == sz:
                    assert same(p, z)
                    continue
                d = next(i for i, (x, y) in enumerate(zip(
                    list(sp) + [None] * len(sz), sz)) if x != y)
                n = p.shape[d] // z.shape[d]
                i = r["coord"]["data"]
                assert n == 2 and same(p.narrow(d, i * z.shape[d],
                                                z.shape[d]), z)
                n_cut += 1
            for p, z in zip(tree.leaves(a["state"]["params"]),
                            tree.leaves(b["state"]["params"])):
                assert same(p, z)
        assert n_cut > 0


@pytest.mark.parametrize("zero", [False, True], ids=["plain", "zero1"])
def test_participants_of_a_block_hold_the_same_bits(ranks, zero):
    """After each step, every leaf's block is the same bytes on every
    participant that holds that block (the replicated leaves on every
    model participant, all of them across the data axis but ZeRO-1's
    moments)."""
    specs = ranks[0]["step"][zero]["specs"]
    for step in range(2):
        held: dict = {}
        for r in ranks:
            for i, (s, h) in enumerate(zip(
                    specs, r["step"][zero]["runs"][step]["hashes"])):
                axes = {a for e in s for a in entry_axes(e)}
                key = (i, tuple(r["coord"][a] for a in sorted(axes)))
                held.setdefault(key, set()).add(h)
        assert all(len(v) == 1 for v in held.values())
        assert len(held) > len(specs)


# -- the collectives on meta: the dry run's count -----------------------------

def meta_record(arch: str, mesh, coord: dict, zero: bool) -> list:
    """Each ``(kind, operand bytes)`` of one sharded train step of
    ``arch`` run on ``meta`` over ``MetaShards`` at ``coord``."""
    cfg = meta_cfg(arch)
    model = Model(cfg)
    abstract = abstract_state(model, OPT)
    sh = state_shardings(abstract, cfg, mesh, zero_opt=zero)
    part = Participant(MetaShards(mesh, coord))
    step = make_train_step(model, OPT, shards=part, shardings=sh)
    batch = {k: torch.empty((BATCH, SEQ), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    record: list = []
    with observe(lambda kind, n: record.append((kind, n))):
        step(shard_tree(abstract, sh, coord), batch)
    return record


@pytest.mark.parametrize("zero", [False, True], ids=["plain", "zero1"])
@pytest.mark.parametrize("arch", RECORD_ARCHS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_the_meta_count_is_every_rank_record(ranks, mesh_name, arch, zero):
    """Call for call: kind, order and one participant's operand bytes."""
    mesh = mesh_of(mesh_name)
    for r in ranks:
        got = r["records"][mesh_name, arch][zero]
        assert {k for k, _ in got} >= {"all-reduce"}
        assert got == meta_record(arch, mesh, r["coords"][mesh_name],
                                  zero), (r["rank"], mesh_name)


@pytest.mark.parametrize("mesh_name", ["2x2", "2x1x2"])
def test_the_moe_row_stand_in_changes_no_record(mesh_name):
    """On meta a participant's experts take their even share of the
    ``T·k`` slots; every other count gives the same collectives (the
    region end sums ``[T, d]``)."""
    assert moe.local_rows(torch.empty(8, device="meta"), 64, 8, 32) == 16
    assert moe.local_rows(torch.empty(8, device="meta"), 65, 8, 32) == 17
    assert moe.local_rows(torch.tensor([True, False, True]), 3, 1, 2) == 2
    mesh = mesh_of(mesh_name)
    coord = {a: 0 for a in mesh.axis_names}
    arch = "granite_moe_1b_a400m"
    even = meta_record(arch, mesh, coord, False)
    seen = []

    def every_slot(mine, slots, local_experts, experts):
        seen.append(slots)
        return slots
    with mock.patch.object(moe, "local_rows", every_slot):
        assert meta_record(arch, mesh, coord, False) == even
    assert seen and all(n == BATCH // 2 * SEQ * port_cfg(arch).moe_top_k
                        for n in seen)


# -- a region end in float32 --------------------------------------------------

@pytest.mark.parametrize("mesh_name", MODEL_MESHES)
def test_a_bf16_region_end_rounds_the_float32_sum_once(ranks, mesh_name):
    """With a model axis of more than one, each participant's partial is
    formed in float32, the partials summed in shard order and the sum
    rounded once to bf16; the reference's bf16 sum of partials each
    rounded first gives other bits."""
    for r in ranks:
        case = r["fault1"][mesh_name]
        m, a, w = case["m"], case["a"], case["w"]
        c = -(-a.shape[-1] // m)
        parts = [a[..., i * c:(i + 1) * c].float() @ w[i * c:(i + 1) * c]
                 .float() for i in range(m)]
        want = torch.stack(parts).sum(dim=0).to(torch.bfloat16)
        assert case["out"].dtype == torch.bfloat16 and same(case["out"],
                                                            want)
        rounded = torch.stack([p.to(torch.bfloat16) for p in parts]).sum(
            dim=0)
        assert not torch.equal(rounded, want)


# -- compress=True ------------------------------------------------------------

class _Gathered:
    """A participant of a list of every participant's block: its max over
    ``"model"`` is the largest of the maxima the list has reported (every
    participant runs once to report, then again to use them)."""

    def __init__(self, coord: dict, maxima: list, report: bool) -> None:
        self.coord, self.maxima, self.report = coord, maxima, report

    def max_model(self, x):
        if self.report:
            self.maxima.append(x)
            return x
        return torch.stack(self.maxima).amax(0)


@pytest.mark.parametrize("m", [2, 4])
def test_sharded_ef_compress_is_the_whole_leaves_byte_for_byte(m):
    mesh = make_mesh((1, m), ("data", "model"))
    gen = torch.Generator().manual_seed(4)
    shapes = {"first": ((37, 300), spec("model", None)),
              "last": ((3, 5, 333), spec(None, None, "model")),
              "flat": ((1000,), spec("model")),
              "cols": ((9, 70), spec(None, "model")),
              "whole": ((4, 257), spec())}
    grads = {k: torch.randn(s, generator=gen) * 10.0 ** torch.randn(
        s, generator=gen) for k, (s, _) in shapes.items()}
    residual = {k: 1e-2 * torch.randn(s, generator=gen)
                for k, (s, _) in shapes.items()}
    sh = {k: NamedSharding(mesh, p) for k, (_, p) in shapes.items()}
    assert all(math_prod(s) % 256 for s, _ in shapes.values())
    want_d, want_r = port_compress.ef_compress(grads, residual)
    coords = all_coords(mesh)
    maxima: list = []
    for c in coords:
        port_compress.ef_compress_sharded(
            shard_tree(grads, sh, c), shard_tree(residual, sh, c), sh, grads,
            _Gathered(c, maxima, True))
    for c in coords:
        got_d, got_r = port_compress.ef_compress_sharded(
            shard_tree(grads, sh, c), shard_tree(residual, sh, c), sh, grads,
            _Gathered(c, maxima, False))
        for got, want in ((got_d, want_d), (got_r, want_r)):
            cut = shard_tree(want, sh, c)
            for k in shapes:
                assert same(got[k], cut[k]), (m, k, c)


def test_block_runs_are_the_positions_a_block_holds():
    shape = (3, 4, 5)
    whole = torch.arange(60).reshape(shape)
    for sl in ((slice(0, 3), slice(1, 3), slice(0, 5)),
               (slice(1, 2), slice(0, 4), slice(2, 4)),
               (slice(0, 3), slice(0, 4), slice(0, 5))):
        offsets, length = port_compress.block_runs(shape, sl)
        got = torch.cat([torch.arange(o, o + length) for o in offsets])
        assert torch.equal(got, whole[sl].reshape(-1))


def math_prod(shape) -> int:
    return int(np.prod(shape))


def straddling(like, shardings, coords) -> set:
    """The leaves (flatten order) whose 256-element blocks hold elements of
    more than one participant."""
    out = set()
    for i, (leaf, sh) in enumerate(zip(tree.leaves(like),
                                       tree.leaves(shardings))):
        n = leaf.numel()
        for c in coords:
            offsets, length = port_compress.block_runs(
                tuple(leaf.shape), shard_slices(tuple(leaf.shape), sh, c))
            if length == n or length == 0:
                continue
            if any(o % 256 or ((o + length) % 256 and o + length != n)
                   for o in offsets):
                out.add(i)
    return out


@pytest.mark.parametrize("mesh_name", COMPRESS_MESHES)
def test_the_step_compresses_the_whole_leaves_byte_for_byte(ranks,
                                                            mesh_name):
    """In every step, on every rank, the compressed gradient and residual
    are ``ef_compress`` of the gathered gradient and residual; the scales
    taken per shard break it on leaves whose blocks straddle a shard
    boundary, and only there."""
    cfg = port_cfg(COMPRESS_ARCH)
    mesh = mesh_of(mesh_name)
    like = Model(cfg).abstract_params()
    across = straddling(like, param_shardings(like, cfg, mesh),
                        all_coords(mesh))
    assert across
    for r in ranks:
        case = r["compress"][mesh_name]
        assert case["calls"] == COMPRESS_STEPS
        broken = set()
        for run in case["runs"]:
            want_d, want_r = port_compress.ef_compress(run["grads"],
                                                       run["residual"])
            for got, want in ((run["deq"], want_d), (run["res"], want_r)):
                for g, w in zip(tree.leaves(got), tree.leaves(want),
                                strict=True):
                    assert same(g, w)
            broken |= {i for i, (g, w) in enumerate(zip(
                tree.leaves(run["control"]), tree.leaves(want_d)))
                if not same(g, w)}
        assert broken and broken <= across, (broken, across)


@pytest.mark.parametrize("mesh_name", COMPRESS_MESHES)
def test_zero1_cuts_the_moments_after_the_compression(ranks, mesh_name):
    """The sharded compressed step under ZeRO-1 gives the same state bit
    for bit: the compression sees the whole gradient block either way."""
    for r in ranks:
        case = r["compress"][mesh_name]
        assert case["zero1_cut"]
        for run, zero in zip(case["runs"], case["zero1"], strict=True):
            for a, b in zip(tree.leaves(run["state"]), tree.leaves(zero),
                            strict=True):
                assert same(a, b)


#: ``tests/test_torch_train.py``'s three-step rule: 1e-5 of each leaf's
#: scale on all but 1 % of the elements (the residual on its gradient's
#: scale, 127 × its own), and the metrics to 1e-5 relative.
STEP_TOL = 1e-5
STEP_OUTLIER_SHARE = 0.01


def outliers(got, want, factor: float = 1.0) -> tuple[int, int]:
    off = total = 0
    for g, w in zip(got, want, strict=True):
        g, w = np.asarray(g, dtype=np.float64), np.asarray(w,
                                                           dtype=np.float64)
        scale = factor * max(float(np.abs(w).max()), 1e-30)
        off += int((np.abs(g - w) > STEP_TOL * scale).sum())
        total += w.size
    return off, total


def state_parts(state) -> dict:
    """Params, moments and residual of a port state, each as the JAX
    package's numpy leaves."""
    return {"params": state["params"], "m": state["opt"].m,
            "v": state["opt"].v, "ef": state["ef"]}


def hold_three_steps(runs, want_states, want_metrics) -> None:
    for i, (run, want, wm) in enumerate(zip(runs, want_states, want_metrics,
                                            strict=True)):
        for k, v in wm.items():
            assert float(run["metrics"][k]) == pytest.approx(
                float(v), rel=STEP_TOL, abs=1e-8), (i, k)
        got = state_parts(run["state"])
        for name, factor in (("params", 1.0), ("m", 1.0), ("v", 1.0),
                             ("ef", 127.0)):
            off, total = outliers(
                jax.tree.leaves(lm_params_to_numpy(got[name])),
                want[name], factor)
            assert off <= STEP_OUTLIER_SHARE * total, (i, name, off, total)


def compress_batches(reference) -> list:
    b = reference["batches"]
    return b + [b[0]]


def numpy_parts(state) -> dict:
    return {k: jax.tree.leaves(lm_params_to_numpy(v))
            for k, v in state_parts(state).items()}


@pytest.mark.parametrize("mesh_name", COMPRESS_MESHES)
def test_sharded_compressed_steps_keep_the_unsharded_port(ranks, reference,
                                                          mesh_name):
    chain = reference["compress"]
    want = [numpy_parts(s) for s in chain["states"][1:]]
    for r in ranks:
        hold_three_steps(r["compress"][mesh_name]["runs"], want,
                         chain["metrics"])


@requires_grad_through_barrier
@pytest.mark.parametrize("mesh_name", COMPRESS_MESHES)
def test_sharded_compressed_steps_keep_the_jax_steps(ranks, reference,
                                                     mesh_name):
    """Each sharded step against the JAX package's compressed step from
    the same state, on the same batch."""
    import jax.numpy as jnp

    import repro.train as ref_train
    from repro.models import Model as RefModel

    rcfg = ref_smoke(ref_config(COMPRESS_ARCH))
    opt_kw = dict(lr=OPT.lr, warmup_steps=OPT.warmup_steps,
                  total_steps=OPT.total_steps)
    ref_step = jax.jit(ref_train.make_train_step(
        RefModel(rcfg), ref_train.AdamWConfig(**opt_kw), accum=2,
        compress=True))

    def jax_tree(t):
        return jax.tree.map(jnp.asarray, lm_params_to_numpy(t))
    states, metrics = [], []
    for start, b in zip(reference["compress"]["states"],
                        compress_batches(reference)):
        ref_state = {"params": jax_tree(start["params"]),
                     "opt": ref_train.AdamWState(
                         m=jax_tree(start["opt"].m),
                         v=jax_tree(start["opt"].v),
                         step=jnp.asarray(int(start["opt"].step),
                                          jnp.int32)),
                     "ef": jax_tree(start["ef"])}
        ref_state, m = ref_step(ref_state, jax.tree.map(jnp.asarray, b))
        states.append({
            "params": jax.tree.leaves(ref_state["params"]),
            "m": jax.tree.leaves(ref_state["opt"].m),
            "v": jax.tree.leaves(ref_state["opt"].v),
            "ef": jax.tree.leaves(ref_state["ef"])})
        metrics.append(m)
    for r in ranks:
        hold_three_steps(r["compress"][mesh_name]["runs"], states, metrics)
