"""The sharded train step: ``make_train_step(..., shards=, shardings=)``
against the unsharded step and the JAX package's gradient.

The JAX package jits its train step with ``in_shardings`` from
``state_shardings`` on a ``("data", "model")`` mesh; the port runs the
step one participant a process, on its block of the state
(``parallel/sharding.py`` ``shard_tree``), with the collectives written
out (``parallel/tensor.py``).  Here, on the CPU with the kernels' plain
versions at smoke size:

- ``shard_tree`` / ``gather_tree`` round-trip every leaf of every arch's
  smoke train state (ZeRO-1 moments included) at meshes (2, 2) and
  (1, 4), and a tree of uneven leaves; no leaf of the ten configs at
  their published size is uneven at a model axis of 4;
- a (1, 1) mesh gives the unsharded step's state and metrics byte for
  byte;
- one spawn of 4 gloo ranks (a ``FileStore`` under the test's temporary
  directory) runs granite-moe (kv heads sharded), glm4 (smoke kv 1,
  replicated), mamba2 and jamba on (2, 2) and (1, 4), the same numpy
  parameters and batch: the loss, the metrics
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
- ``compress=True`` raises.
"""
from __future__ import annotations

import hashlib
from dataclasses import replace

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
from repro_torch.parallel.collectives import ListShards
from repro_torch.parallel.sharding import (
    NamedSharding,
    entry_axes,
    gather_tree,
    param_shardings,
    shard_shape,
    shard_tree,
    spec,
)
from repro_torch.parallel.tensor import Participant
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
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
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


def round_trip(tree_, shardings, mesh_shape) -> None:
    sh = ListShards(make_mesh(mesh_shape, ("data", "model")))
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
    mesh = make_mesh(MESHES[mesh_name], ("data", "model"))
    shardings = state_shardings(abstract_state(model, OPT), cfg, mesh,
                                zero_opt=True)
    round_trip(state, shardings, MESHES[mesh_name])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_uneven_leaves_round_trip_with_the_last_blocks_shorter(mesh_name):
    mesh = make_mesh(MESHES[mesh_name], ("data", "model"))
    gen = torch.Generator().manual_seed(3)
    shapes = {"a": ((5, 3), spec("model", None)),
              "b": ((7,), spec(("data", "model"))),
              "c": ((3, 9), spec("data", "model")),
              "d": ((2, 6), spec(None, "model"))}
    tree_ = {k: torch.randn(s, generator=gen) for k, (s, _) in shapes.items()}
    shardings = {k: NamedSharding(mesh, p) for k, (_, p) in shapes.items()}
    round_trip(tree_, shardings, MESHES[mesh_name])
    last = shard_tree(tree_, shardings, {"data": MESHES[mesh_name][0] - 1,
                                         "model": MESHES[mesh_name][1] - 1})
    assert last["b"].numel() < -(-7 // 4)          # the last block shorter


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
    lm.check_shardable(smoke_variant(get_config("glm4_9b")), 4)
    with pytest.raises(NotImplementedError, match="n_heads"):
        lm.check_shardable(smoke_variant(get_config("glm4_9b")), 8)
    with pytest.raises(NotImplementedError, match="moe_experts"):
        lm.check_shardable(smoke_variant(
            get_config("granite_moe_1b_a400m")), 8)


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


def test_compress_raises_under_sharding():
    cfg = smoke_variant(get_config("granite_moe_1b_a400m"))
    model = Model(cfg)
    mesh = make_mesh((1, 1), ("data", "model"))
    shardings = state_shardings(abstract_state(model, OPT, compress=True),
                                cfg, mesh)
    with pytest.raises(NotImplementedError, match="compress=True"):
        make_train_step(model, OPT, compress=True, shards=mesh,
                        shardings=shardings)


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


def _rank_cases(rank: int, store: str, np_params: dict, batches: list,
                routing: list) -> dict:
    torch.set_num_threads(1)
    dm = init_ranks(make_mesh(MESHES["2x2"], ("data", "model")), rank,
                    store)
    meshes = {"2x2": dm, "1x4": make_mesh(MESHES["1x4"], ("data", "model"))
              .device_mesh()}
    out = {"rank": rank, "grads": {}, "norm": {}}
    for name, mesh in meshes.items():
        part = Participant(mesh)
        out["norm"][name] = _norm_case(part)
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
            "moved": (moved_metrics, moved_grads),
            "unsharded": {arch: unsharded(arch, params[arch], batches[0])
                          for arch in ARCHS}}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("sharded") / "store")
    return run_ranks(_rank_cases, WORLD, store, reference["params"],
                     reference["batches"], reference["routing"],
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


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_without_the_model_sum_of_partial_gradients_the_step_fails(
        ranks, reference, arch, mesh_name):
    """The control: the partial leaves' gradients unsummed exceed the
    limit, and exactly the leaves ``partial_grad_leaves`` names differ
    (the norm scales ahead of a region come whole)."""
    cfg = port_cfg(arch)
    partial = train_step.partial_grad_leaves(param_shardings(
        Model(cfg).abstract_params(), cfg,
        make_mesh(MESHES[mesh_name], ("data", "model"))))
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


@pytest.mark.parametrize("mesh_name", list(MESHES))
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


def test_the_encoder_decoder_does_not_run_sharded():
    model = Model(smoke_variant(get_config("seamless_m4t_medium")))
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        model.loss({}, {}, shards=make_mesh((1, 1), ("data", "model")))


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
