"""``repro_torch.parallel`` and ``launch.mesh`` against the JAX package.

Given a bare ``Mesh`` the port runs the reference's ``shard_map`` bodies
over a list of per-shard tensors on one device (``parallel/collectives.py``,
the list form, held here); ``tests/test_torch_dist.py`` holds its rank form,
one shard a ``torch.distributed`` rank, to the list form.  The reference's pipeline and expert-parallel
MoE run on a virtual CPU mesh of 4 devices in a subprocess
(``--xla_force_host_platform_device_count``, as ``tests/test_parallel.py``
does), on the same numpy inputs.  Limits: the pipeline 1e-6 (largest
difference over the largest magnitude), the ep MoE output 1e-5 relative
with its dropped slots exactly equal and ``MoeAux`` 1e-6; the int8
all-reduce 1e-7 relative to the reference's quantize / dequantize mean
composed without ``shard_map`` (the reference's own ``shard_map`` test
fails on this jax), its payloads and scales byte-identical; the sharding
specs equal entry for entry for every arch on both production meshes.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.parallel.compress as ref_compress
import repro.parallel.sharding as ref_sharding
import repro.train as ref_train
from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.models import lm as ref_lm
from repro.models import smoke_variant as ref_smoke
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh
from repro_torch.models import Model, encdec, lm, moe, smoke_variant
from repro_torch.parallel import (
    collectives,
    compress,
    ep_moe,
    pipeline,
    sharding,
)
from repro_torch.train import AdamWConfig, abstract_state, state_shardings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPE_TOL = 1e-6
EP_RTOL = 1e-5
AUX_TOL = 1e-6
ALLREDUCE_RTOL = 1e-7
#: Capacity factor of the ep cases: low enough that slots drop.
EP_CF = 0.5


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the mesh -----------------------------------------------------------------

def test_production_meshes_describe_the_reference_shapes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.axis_names == ("data", "model")
    assert dict(single.shape) == {"data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model")
    assert list(multi.shape.values()) == [2, 16, 16] and multi.size == 512
    mesh = make_mesh((1, 4), ("data", "model"))
    assert mesh.shape["model"] == 4 and mesh.size == 4
    with pytest.raises(ValueError):
        Mesh((2, 2), ("data",))


# -- the collectives ----------------------------------------------------------

def test_collectives_move_what_the_reference_collectives_move():
    xs = [torch.full((2,), float(i)) for i in range(4)]
    assert torch.equal(collectives.all_gather(xs), torch.stack(xs))
    blocks = [[f"{i}->{j}" for j in range(3)] for i in range(3)]
    out = collectives.all_to_all(blocks)
    assert out[2] == ["0->2", "1->2", "2->2"]
    shifted = collectives.ppermute_next(xs)
    assert torch.equal(shifted[0], torch.zeros(2))
    assert all(torch.equal(shifted[i], xs[i - 1]) for i in range(1, 4))
    assert torch.equal(collectives.psum(xs), torch.full((2,), 6.0))
    assert torch.equal(collectives.pmean(xs), torch.full((2,), 1.5))
    with pytest.raises(ValueError):
        collectives.all_to_all([[1, 2], [3]])


# -- sharding -----------------------------------------------------------------

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _paths(jax_tree):
    return [(tuple(str(k.key) if hasattr(k, "key") else
                   k.name if hasattr(k, "name") else str(k) for k in path),
             leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jax_tree)[0]]


def _port_at(port_tree, path):
    node = port_tree
    for key in path:
        node = getattr(node, key) if isinstance(key, str) and hasattr(
            node, "_fields") else node[key]
    return node


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference_entry_for_entry(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    ref_mesh, mesh = AbstractMesh(shape, axes), Mesh(shape, axes)
    rcfg, cfg = ref_config(arch), get_config(arch)
    ref_params = RefModel(rcfg).abstract_params()
    params = Model(cfg).abstract_params()
    want = ref_sharding.param_shardings(ref_params, rcfg, ref_mesh)
    got = sharding.param_shardings(params, cfg, mesh)
    pairs = _paths(want)
    assert len(pairs) == len(tree.leaves(got))
    for path, w in pairs:
        g = _port_at(got, path)
        assert g.spec == tuple(w.spec), (path, g.spec, w.spec)
        leaf = _port_at(params, path)
        assert g.spec == sharding.param_spec(list(path), leaf.dim(), cfg,
                                             mesh)

    for batch in (256, 3):
        kw = dict(has_embeds=bool(cfg.frontend_tokens),
                  encdec=bool(cfg.enc_layers))
        w = ref_sharding.batch_specs(rcfg, ref_mesh, batch, **kw)
        g = sharding.batch_specs(cfg, mesh, batch, **kw)
        assert g == {k: tuple(v) for k, v in w.items()}
        assert sharding.logits_spec(cfg, mesh, batch) == tuple(
            ref_sharding.logits_spec(rcfg, ref_mesh, batch))
        assert sharding.cache_spec_for_kv(cfg, mesh, batch) == tuple(
            ref_sharding.cache_spec_for_kv(rcfg, ref_mesh, batch))
        if cfg.enc_layers:
            continue
        ref_cache = jax.eval_shape(lambda: ref_lm.init_cache(rcfg, batch, 64))
        cache = lm.init_cache(cfg, batch, 64, "meta")
        want_c = ref_sharding.cache_shardings(rcfg, ref_mesh, ref_cache, batch)
        got_c = sharding.cache_shardings(cfg, mesh, cache, batch)
        for path, w in _paths(want_c):
            assert _port_at(got_c, path).spec == tuple(w.spec), path


def test_encdec_cache_shardings_follow_the_kv_rule():
    cfg = get_config("seamless_m4t_medium")
    mesh = make_production_mesh()
    cache = encdec.init_cache(
        encdec.abstract_params(replace(cfg, attention_impl="dense")),
        replace(cfg, attention_impl="dense"),
        torch.empty((16, 8, cfg.d_model), device="meta"), 32)
    got = sharding.cache_shardings(cfg, mesh, cache, 16)
    kv = sharding.cache_spec_for_kv(cfg, mesh, 16)
    assert kv == (None, "data", None, "model", None)    # 16 kv heads
    for part in ("self", "cross"):
        assert got[part]["k"].spec == got[part]["v"].spec == kv
    assert got["len"].spec == ()


@pytest.mark.parametrize("zero_opt", [False, True])
@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m",
                                  "seamless_m4t_medium"])
def test_state_shardings_equal_the_reference(arch, zero_opt):
    shape, axes = MESHES["16x16"]
    rcfg, cfg = ref_config(arch), get_config(arch)
    want = ref_train.state_shardings(
        ref_train.abstract_state(RefModel(rcfg), ref_train.AdamWConfig(),
                                 compress=True), rcfg,
        AbstractMesh(shape, axes), zero_opt=zero_opt)
    got = state_shardings(abstract_state(Model(cfg), AdamWConfig(),
                                         compress=True), cfg,
                          Mesh(shape, axes), zero_opt=zero_opt)
    pairs = _paths(want)
    assert len(pairs) == len(tree.leaves(got))
    for path, w in pairs:
        assert _port_at(got, path).spec == tuple(w.spec), path


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_placements_on_a_world_size_one_device_mesh():
    """One process (one card, or here the CPU) is a gloo group of world
    size 1; the placements of a spec shard a DTensor as the spec says."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        dm = Mesh((1, 1), ("data", "model")).device_mesh("cpu")
        assert dm.mesh_dim_names == ("data", "model")
        assert sharding.placements(("data", "model"), dm) == [Shard(0),
                                                               Shard(1)]
        assert sharding.placements((None, ("data", "model")), dm) == [
            Shard(1), Shard(1)]
        assert sharding.placements((None, None), dm) == [Replicate(),
                                                         Replicate()]
        ns = sharding.NamedSharding(make_production_mesh(), ("model", None))
        assert ns.placements(dm) == [Replicate(), Shard(0)]
        with pytest.raises(ValueError):
            sharding.placements(("pod", None), dm)
        t = torch.arange(12.0).reshape(3, 4)
        d = distribute_tensor(t, dm, sharding.placements((None, "model"), dm))
        assert torch.equal(d.full_tensor(), t)
    finally:
        dist.destroy_process_group()


# -- compressed all-reduce ----------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 64), (3, 300), (1000,)])
def test_compressed_allreduce_mean_matches_the_reference(shape):
    rng = np.random.default_rng(sum(shape))
    xs = [rng.normal(0, 1 + i, shape).astype(np.float32) for i in range(4)]
    want = np.mean([np.asarray(ref_compress.dequantize(
        ref_compress.quantize(jnp.asarray(x)), x.shape)) for x in xs],
        axis=0)
    got = compress.compressed_allreduce_mean([torch.from_numpy(x)
                                              for x in xs])
    assert got.shape == shape and got.dtype == torch.float32
    assert rel(got.numpy(), want) <= ALLREDUCE_RTOL
    for x in xs:
        q, r = compress.quantize(torch.from_numpy(x)), ref_compress.quantize(
            jnp.asarray(x))
        assert q.q.numpy().tobytes() == np.asarray(r.q).tobytes()
        assert q.scale.numpy().tobytes() == np.asarray(r.scale).tobytes()
    # the mean of the exact values, to the int8 format's error
    assert rel(got.numpy(), np.mean(xs, axis=0)) < 0.05


# -- the reference on a virtual mesh ------------------------------------------

REF_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from dataclasses import replace
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models import smoke_variant
from repro.parallel import ep_moe
from repro.parallel.pipeline import pipeline_apply

inp = np.load(sys.argv[1])
out = {}
devs = np.array(jax.devices())

mesh = Mesh(devs[:4].reshape(4), ("pipe",))
ws = jnp.asarray(inp["pipe_ws"])
out["pipe"] = np.asarray(pipeline_apply(
    lambda w, x: jnp.tanh(x @ w), ws, jnp.asarray(inp["pipe_x"]), mesh,
    axis="pipe"))

cfg = smoke_variant(get_config("granite_moe_1b_a400m"))
p = {k[4:]: jnp.asarray(v) for k, v in inp.items() if k.startswith("moe_")}
x = jnp.asarray(inp["ep_x"])
E, k = cfg.moe_experts, cfg.moe_top_k
B, S, d = x.shape
for M in (2, 4):
    mesh = Mesh(devs[:M].reshape(1, M), ("data", "model"))
    ep_moe.set_mesh(mesh)
    y, aux = ep_moe.ep_moe_apply(p, x, cfg, capacity_factor=CF)
    out[f"ep{M}_y"] = np.asarray(y)
    for name, v in zip(("lb", "z", "load"), aux):
        out[f"ep{M}_{name}"] = np.asarray(v)
    # each shard's kept slots, by the reference's own lines (router, top-k,
    # argsort / searchsorted, the scatter of valid flags)
    e_local = E // M
    kept = []
    for m in range(M):
        xt = x[:, m * S // M:(m + 1) * S // M].reshape(-1, d)
        logits = (xt @ p["router"].astype(xt.dtype)).astype(jnp.float32)
        _, experts = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
        t_loc = xt.shape[0]
        cap = int((t_loc * k) / M * CF + 0.999)
        dest = experts.reshape(-1) // e_local
        order = jnp.argsort(dest)
        dest_s = dest[order]
        pos = jnp.arange(t_loc * k) - jnp.searchsorted(dest_s, dest_s,
                                                       side="left")
        keep = pos < cap
        slot = dest_s * cap + jnp.where(keep, pos, 0)
        valid = jnp.zeros((M * cap,), jnp.bool_).at[slot].set(keep,
                                                               mode="drop")
        eff = keep & valid[slot]
        kept.append(np.asarray(jnp.zeros((t_loc * k,), jnp.bool_)
                               .at[order].set(eff)))
    out[f"ep{M}_kept"] = np.stack(kept)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The inputs, and the reference's outputs on a 4-device virtual mesh."""
    tmp = tmp_path_factory.mktemp("virtual_mesh")
    rng = np.random.default_rng(0)
    n_stages, n_micro, mb, d = 4, 8, 2, 16
    inputs = {"pipe_ws": (rng.normal(0, 0.3, (n_stages, d, d))
                          .astype(np.float32)),
              "pipe_x": rng.normal(0, 1, (n_micro, mb, d)).astype(np.float32)}
    cfg = ref_smoke(ref_config("granite_moe_1b_a400m"))
    params = jax.tree.map(np.asarray, jax.jit(RefModel(cfg).init)(
        jax.random.key(0)))
    moe_p = {k: v[0] for k, v in params["blocks"]["L0_moe"].items()}
    inputs.update({f"moe_{k}": v for k, v in moe_p.items()})
    inputs["ep_x"] = rng.normal(0, 1, (2, 8, cfg.d_model)).astype(np.float32)
    np.savez(tmp / "in.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    script = REF_SCRIPT.replace("CF", repr(EP_CF))
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(script),
                          str(tmp / "in.npz"), str(tmp / "out.npz")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    out = dict(np.load(tmp / "out.npz"))
    return inputs, moe_p, out


def test_pipeline_matches_the_reference(reference_runs):
    inputs, _, out = reference_runs
    ws, x = (torch.from_numpy(inputs[k]) for k in ("pipe_ws", "pipe_x"))
    got = pipeline.pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, x,
                                  make_mesh((4,), ("pipe",)), axis="pipe")
    assert got.shape == x.shape
    assert rel(got.numpy(), out["pipe"]) <= PIPE_TOL
    seq = x
    for w in ws:
        seq = torch.tanh(seq @ w)
    assert rel(got.numpy(), seq.numpy()) <= PIPE_TOL


def test_pipeline_schedule_and_split():
    assert pipeline.stage_split(10, 4) == [3, 3, 2, 2]
    calls = []

    def stage(w, h):
        calls.append(float(w))
        return h + w
    ws = torch.arange(1.0, 4.0)                   # 3 stages
    x = torch.zeros(6, 2)
    got = pipeline.pipeline_apply(stage, ws, x, make_mesh((3,), ("pipe",)))
    assert torch.equal(got, torch.full((6, 2), 6.0))
    assert len(calls) == 3 * (6 + 3 - 1)          # every stage, every tick
    with pytest.raises(ValueError):
        pipeline.pipeline_apply(stage, ws, torch.zeros(4, 2),
                                make_mesh((3,), ("pipe",)))


@pytest.fixture()
def ep_mesh():
    yield lambda m: ep_moe.set_mesh(make_mesh((1, m), ("data", "model")))
    ep_moe.set_mesh(None)


@pytest.mark.parametrize("impl", ["gmm", "ragged"])
@pytest.mark.parametrize("M", [2, 4])
def test_ep_moe_matches_the_reference(reference_runs, ep_mesh, M, impl):
    """The output, the dropped slots and the aux terms of the reference's
    ``shard_map`` run, with slots dropped (capacity factor 0.5).  The
    experts run through K5's wrapper (``gmm``: its plain version on CPU
    tensors) or the plain per-expert products."""
    inputs, moe_p, out = reference_runs
    cfg = replace(smoke_variant(get_config("granite_moe_1b_a400m")),
                  moe_impl="ep")
    p = {k: torch.from_numpy(np.array(v)) for k, v in moe_p.items()}
    ep_mesh(M)
    kept = []
    ffn = moe._gmm_ffn if impl == "gmm" else moe._ragged_ffn
    orig, moe._gmm_ffn = moe._gmm_ffn, ffn
    try:
        with ep_moe.dispatch_hook(kept.append):
            y, aux = ep_moe.ep_moe_apply(p, torch.from_numpy(inputs["ep_x"]),
                                         cfg, capacity_factor=EP_CF)
    finally:
        moe._gmm_ffn = orig
    assert rel(y.numpy(), out[f"ep{M}_y"]) <= EP_RTOL
    got_kept = torch.stack(kept).numpy()
    assert np.array_equal(got_kept, out[f"ep{M}_kept"])
    assert not got_kept.all()                       # slots did drop
    for name, v in zip(("lb", "z", "load"), aux):
        np.testing.assert_allclose(v.numpy(), out[f"ep{M}_{name}"],
                                   rtol=AUX_TOL, atol=AUX_TOL)


def test_dispatch_plan_drops_an_overflowing_destinations_first_slot():
    """Four slots to shard 0 with room for two: the reference keeps
    positions 0 and 1, then its scatter of the dropped ones (at slot 0)
    leaves slot 0 invalid — only position 1 arrives."""
    experts = torch.tensor([[0], [0], [1], [0], [0]])
    order, keep, slot = ep_moe.dispatch_plan(experts, 1, 2, 2)
    assert order.tolist() == [0, 1, 3, 4, 2]
    assert keep.tolist() == [False, True, False, False, True]
    assert slot[keep].tolist() == [1, 2]


def test_ep_without_drops_is_the_token_sorted_moe(ep_mesh):
    """With room for every slot (capacity factor M) expert parallelism
    computes the reference's ragged MoE, through the model's prefill."""
    cfg = smoke_variant(get_config("granite_moe_1b_a400m"))
    params = Model(cfg).init(device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    ep_mesh(2)
    layer = {k: v[0] for k, v in params["blocks"]["L0_moe"].items()}
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    y, aux = ep_moe.ep_moe_apply(layer, x, replace(cfg, moe_impl="ep"),
                                 capacity_factor=2.0)
    y0, aux0 = moe.moe_apply_ragged(layer, x, cfg)
    assert rel(y.numpy(), y0.numpy()) <= EP_RTOL
    for a, b in zip(aux, aux0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=AUX_TOL,
                                   atol=AUX_TOL)
    calls = []
    with moe.routing_hook(lambda probs, e: calls.append(e.shape) or e):
        logits, _ = Model(replace(cfg, moe_impl="ep")).forward(
            params, {"tokens": tokens})
    assert len(calls) == 2 * cfg.n_blocks            # one per shard a layer
    assert calls[0] == (8, cfg.moe_top_k)
    assert torch.isfinite(logits).all()


def test_ep_raises_where_the_reference_asserts(ep_mesh):
    cfg = replace(smoke_variant(get_config("granite_moe_1b_a400m")),
                  moe_impl="ep")
    model = Model(cfg)
    params = model.init(device="cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError):
        model.forward(params, {"tokens": tokens})          # no mesh set
    ep_mesh(4)
    cache = model.init_cache(params, {"tokens": tokens}, 16)
    _, cache = model.prefill(params, {"tokens": tokens}, cache)
    with pytest.raises(ValueError):                        # S = 1 over M = 4
        model.decode(params, tokens[:, :1], cache)
    ep_mesh(3)
    with pytest.raises(ValueError):                        # E = 4 over M = 3
        model.forward(params, {"tokens": torch.zeros((2, 9),
                                                      dtype=torch.int32)})


def test_ep_over_data_and_model_shards(ep_mesh):
    """A (data 2, model 2) mesh: the batch halves run their own all_to_all,
    the aux terms are reduced over all four shards."""
    cfg = replace(smoke_variant(get_config("granite_moe_1b_a400m")),
                  moe_impl="ep")
    layer = {k: v[0] for k, v in Model(cfg).init(device="cpu")["blocks"]
             ["L0_moe"].items()}
    x = torch.randn(4, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    ep_moe.set_mesh(make_mesh((2, 2), ("data", "model")))
    y, aux = ep_moe.ep_moe_apply(layer, x, cfg, capacity_factor=2.0)
    y0, aux0 = moe.moe_apply_ragged(layer, x, replace(cfg, moe_impl="ragged"))
    assert rel(y.numpy(), y0.numpy()) <= EP_RTOL
    np.testing.assert_allclose(aux.expert_load.numpy(),
                               aux0.expert_load.numpy(), rtol=AUX_TOL)
    with pytest.raises(ValueError):                        # B = 3 over dp 2
        ep_moe.ep_moe_apply(layer, x[:3], cfg)


def test_lm_abstract_params_are_meta_with_the_real_dtypes():
    cfg = get_config("jamba_v0_1_52b")
    meta = lm.abstract_params(cfg)
    ref = RefModel(ref_config("jamba_v0_1_52b")).abstract_params()
    got = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for t in tree.leaves(meta)]
    assert got == [(tuple(s.shape), str(s.dtype))
                   for s in jax.tree.leaves(ref)]
    assert all(t.device.type == "meta" for t in tree.leaves(meta))


def test_params_carry_for_the_ep_config():
    cfg = ref_smoke(ref_config("granite_moe_1b_a400m"))
    params = jax.tree.map(np.asarray, jax.jit(RefModel(cfg).init)(
        jax.random.key(0)))
    port_cfg = replace(smoke_variant(get_config("granite_moe_1b_a400m")),
                       moe_impl="ep")
    port = lm_params_from_numpy(params, port_cfg, "cpu")
    assert json.dumps(sorted(port["blocks"])) == json.dumps(
        sorted(params["blocks"]))
