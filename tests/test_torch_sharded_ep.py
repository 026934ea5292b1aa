"""``moe_impl="ep"`` inside the sharded model: ``make_train_step(...,
shards=)``, ``Model.loss`` / ``forward`` / ``init_cache`` / ``prefill``
with ``shards=`` run the reference's expert-parallel ``shard_map`` body on
each participant, one participant a ``torch.distributed`` rank.

The JAX package runs its ep MoE inside the GSPMD-sharded program: the
``shard_map(in_specs=P(dp, "model", None))`` hands each participant a
sequence block of its data block of rows, and its all_to_alls exchange
the routed rows over ``"model"``.  Here, on the CPU with the kernels'
plain versions at smoke size (granite-moe with 8 experts, so that a model
axis of 4 divides them; batch 4 x 16):

- a (1, 1) mesh gives the unsharded ep step's state and metrics byte for
  byte (``accum`` 1 and 2);
- one spawn of 4 gloo ranks (a ``FileStore`` under the test's temporary
  directory) runs granite-moe on (1, 4), (2, 2) and the three-axis
  (2, 1, 2), and jamba on (2, 2), at the reference's capacity factor
  1.25: slots drop in every granite case (``ep_moe.dispatch_hook``).  The
  loss, the metrics and every gathered gradient leaf are held to the
  port's unsharded ep step (the list form over a bare ``Mesh`` of the same
  shape, its routing replayed; ``LOSS_RTOL`` / ``GRAD_REL_RMS``, the
  sharded step's limits), and granite's to ``jax.value_and_grad`` of the
  reference's loss with ``moe_impl="ep"`` on a virtual CPU mesh of the
  same shape (a subprocess a mesh, started before the ranks).  Each of
  three controls lies past the leaf limit: the entry backward keeping
  only the participant's own block of ``dx``, the router's gradient
  without the sum over ``"model"``, the aux terms' gradient counted
  whole on every model participant.  Two micro-batches take their
  capacity from the micro-batch's block;
- the sharded ep prefill's logits and gathered cache are held to the
  unsharded port (routing replayed) and to the reference's ep prefill on
  the virtual mesh; a decode step at a model axis of one, (4, 1), runs;
- a decode step at a model axis above one, ``E`` not a multiple of it,
  and rows that do not split over the data axes (a prefill of one row, a
  train batch of three rows on two data participants) raise
  ``ValueError`` on every rank before any collective;
- every rank's collectives in one ep train step and one ep prefill equal
  the same call run on ``meta`` over ``MetaShards`` at the rank's
  coordinate, call for call (the dry run's count).
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import textwrap
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
from repro_torch.launch.mesh import init_ranks, make_mesh, run_ranks
from repro_torch.models import Model, moe, smoke_variant
from repro_torch.parallel import ep_moe
from repro_torch.parallel.collectives import MetaShards, observe
from repro_torch.parallel.sharding import (
    gather_tree,
    param_shardings,
    shard_tree,
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "granite_moe_1b_a400m"
HYBRID = "jamba_v0_1_52b"
#: granite-moe's smoke variant with 8 experts (4 in the smoke variant):
#: a model axis of 4 divides them
EXPERTS = 8
MESHES = {"1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
#: (arch, mesh) of the train cases; jamba is held to the unsharded port
#: only (the reference's jamba ep gradient takes minutes to compile)
CASES = [(ARCH, name) for name in MESHES] + [(HYBRID, "2x2")]
#: a model axis of one: the ep decode step runs
DECODE_MESH = ((4, 1), ("data", "model"))
WORLD = 4
JOIN_S = 300.0
KERNEL_PATHS = dict(attention_impl="cuda", moe_impl="ep", ssm_impl="cuda",
                    remat=True)
#: the sharded step's limits (``tests/test_torch_sharded_step.py``,
#: ``chip_smoke.py``'s float32 ``grad_f32``), and the JAX comparison's:
#: loss relative, each leaf's largest difference over its largest
#: magnitude
LOSS_RTOL = 1e-6
GRAD_REL_RMS = 1e-4
JAX_LOSS_RTOL = 1e-5
JAX_GRAD_TOL = 1e-4
#: serving: ``chip_smoke.py``'s float32 limit (relative RMS) against the
#: port, ``tests/test_torch_serve.py``'s against JAX
REL_RMS = 1e-4
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, SEQ = 4, 16
MAX_LEN = SEQ + 8
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
CONTROLS = ("own_block_entry", "aux_on_every_model_participant")


def port_cfg(arch: str, **kw):
    cfg = replace(smoke_variant(get_config(arch)), **KERNEL_PATHS)
    if arch == ARCH:
        cfg = replace(cfg, moe_experts=EXPERTS)
    return replace(cfg, **kw).validate()


def mesh_of(name: str):
    return make_mesh(*MESHES[name])


def np_params(arch: str) -> dict:
    return lm_params_to_numpy(Model(port_cfg(arch)).init(
        torch.Generator().manual_seed(0), device="cpu"))


def np_batch(vocab: int, seed: int = 0, batch: int = BATCH) -> dict:
    """Next-token rows whose last label is ignored; the first row ignores
    five more."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (batch, SEQ)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :5] = -1
    return {"tokens": tokens, "labels": labels}


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def rel_rms(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().reshape(-1).view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def flat(tree_: dict, prefix: str = "") -> dict:
    """A nested dict's leaves keyed by their ``/``-joined paths."""
    out = {}
    for k, v in tree_.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


# -- the controls -------------------------------------------------------------

class _MeanWhole(torch.autograd.Function):
    """``mean_over_mesh`` whose gradient is taken whole on every model
    participant (the control)."""

    @staticmethod
    def forward(ctx, x, part):
        return part.pmean_mesh(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def control(name: str):
    """The patch of a named control of the sharded ep layer."""
    if name == "own_block_entry":
        # plain slicing: the entry's gradient only the participant's own
        # block of dx, zeros elsewhere
        def own(x, part):
            n = x.shape[1] // part.m
            return x[:, part.mi * n:(part.mi + 1) * n]
        return mock.patch.object(ep_moe, "enter_sequence_block", own)
    assert name == "aux_on_every_model_participant"
    return mock.patch.object(
        ep_moe, "mean_over_mesh",
        lambda x, part: (x if part.m * part.dp == 1
                         else _MeanWhole.apply(x, part)))


# -- the unsharded ep step, the list form -------------------------------------

def _replayer(recorded: list, part, shards: int):
    """Replays the unsharded run's routing (every shard's call, in shard
    order, call after call) on this participant: its shard's calls."""
    me = part.di * part.m + part.mi
    calls = iter(recorded[me::shards])

    def hook(probs, experts):
        rec = next(calls)
        assert rec.shape == experts.shape
        return rec
    return hook


def unsharded_grads(arch: str, np_params_, batch: dict, mesh, accum=1):
    """The port's unsharded ep step over ``mesh`` (every shard in this
    process): metrics, gradients, the routing (every router call) and the
    kept-slot masks."""
    cfg = port_cfg(arch)
    params = lm_params_from_numpy(np_params_, cfg, "cpu")
    model = Model(cfg)
    routing, kept = [], []

    def keep(probs, experts):
        routing.append(experts.clone())
        return experts

    def grad_fn(b):
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        loss, metrics = model.loss(tree.unflatten(params, leaves), b)
        return ({k: v.detach() for k, v in metrics.items()},
                list(torch.autograd.grad(loss, leaves)))
    ep_moe.set_mesh(mesh)
    try:
        with moe.routing_hook(keep), ep_moe.dispatch_hook(kept.append):
            metrics, grads = train_step._accumulate(
                grad_fn, torch_batch(batch), accum)
    finally:
        ep_moe.set_mesh(None)
    return {"metrics": metrics, "grads": grads, "routing": routing,
            "kept": kept}


def unsharded_prefill(np_params_, prompts: np.ndarray, mesh,
                      decode: bool = False) -> dict:
    """The port's unsharded ep prefill over ``mesh``: logits, the cache
    after it, the routing; with ``decode``, one greedy decode step's
    logits after it too."""
    cfg = port_cfg(ARCH)
    params = lm_params_from_numpy(np_params_, cfg, "cpu")
    model = Model(cfg)
    routing = []

    def keep(probs, experts):
        routing.append(experts.clone())
        return experts
    batch = {"tokens": torch.from_numpy(prompts)}
    ep_moe.set_mesh(mesh)
    try:
        with moe.routing_hook(keep), torch.no_grad():
            cache = model.init_cache(params, batch, MAX_LEN)
            logits, cache = model.prefill(params, batch, cache)
            out = {"logits": logits,
                   "cache": tree.map(torch.clone, cache["slots"])}
            if decode:
                tok = logits[:, -1, :cfg.vocab].argmax(-1)[:, None].to(
                    torch.int32)
                out["tok"] = tok
                out["step"], _ = model.decode(params, tok, cache)
    finally:
        ep_moe.set_mesh(None)
    out["routing"] = routing
    return out


# -- the reference on a virtual mesh ------------------------------------------

REF_SCRIPT = r"""
import sys
from dataclasses import replace
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import Model, smoke_variant
from repro.models import lm
from repro.parallel import ep_moe

inp = dict(np.load(sys.argv[1]))
shape = tuple(int(n) for n in sys.argv[3].split("x"))
names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
cfg = replace(smoke_variant(get_config("ARCH")), moe_experts=EXPERTS,
              moe_impl="ep")
params = {}
for key, v in inp.items():
    if key.startswith("p/"):
        node = params
        *path, leaf = key[2:].split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v)
batch = {"tokens": inp["tokens"], "labels": inp["labels"]}
mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
ep_moe.set_mesh(mesh)
(loss, metrics), grads = jax.jit(jax.value_and_grad(
    lambda p, b: lm.loss_fn(p, cfg, b), has_aux=True))(params, batch)
out = {"loss": np.asarray(loss)}
out.update({f"m/{k}": np.asarray(v) for k, v in metrics.items()})
flat = jax.tree_util.tree_flatten_with_path(grads)[0]
for path, g in flat:
    out["g/" + "/".join(p.key for p in path)] = np.asarray(g)
model = Model(cfg)
prompts = {"tokens": jnp.asarray(inp["prompts"])}
cache = model.init_cache(params, prompts, MAX_LEN)
logits, cache = jax.jit(model.prefill)(params, prompts, cache)
out["logits"] = np.asarray(logits)
for path, c in jax.tree_util.tree_flatten_with_path(cache["slots"])[0]:
    out["c/" + "/".join(p.key for p in path)] = np.asarray(c)
np.savez(sys.argv[2], **out)
"""


def start_reference(tmp, params: dict, batch: dict, prompts: np.ndarray):
    """One subprocess a mesh shape, each the reference's ep
    ``value_and_grad`` and ep prefill on a 4-device virtual CPU mesh."""
    inputs = {f"p/{k}": v for k, v in flat(params).items()}
    inputs.update(batch, prompts=prompts)
    np.savez(tmp / "in.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    script = (REF_SCRIPT.replace("ARCH", ARCH)
              .replace("EXPERTS", str(EXPERTS))
              .replace("MAX_LEN", str(MAX_LEN)))
    procs = {}
    for name, (shape, _) in MESHES.items():
        out, log = tmp / f"out_{name}.npz", tmp / f"log_{name}.txt"
        with open(log, "w") as f:
            procs[name] = (subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(script),
                 str(tmp / "in.npz"), str(out), "x".join(map(str, shape))],
                stdout=subprocess.DEVNULL, stderr=f, env=env), out, log)
    return procs


# -- one rank -----------------------------------------------------------------

def _grads_case(part, arch, np_params_, batch, routing=None, shards=1,
                control_name=None, accum=1) -> dict:
    """Metrics and gathered gradients of the sharded ep step on this rank
    (with and without the sum over ``"model"`` of the partial leaves),
    its kept-slot masks."""
    cfg = port_cfg(arch)
    model = Model(cfg)
    local = lm_shard_from_numpy(np_params_, cfg, part.mesh, part.coord,
                                "cpu")
    like = lm_params_from_numpy(np_params_, cfg, "cpu")
    sh = param_shardings(like, cfg, part.mesh)
    kept = []
    hook = (moe.routing_hook(_replayer(routing, part, shards))
            if routing is not None else _nothing())
    patch = control(control_name) if control_name else _nothing()
    with hook, patch, ep_moe.dispatch_hook(kept.append):
        metrics, grads = train_step.sharded_grads(
            model, local, torch_batch(batch), part, accum)
    whole = train_step.psum_partial(
        grads, train_step.partial_grad_leaves(sh), part)
    return {"metrics": {k: v.clone() for k, v in metrics.items()},
            "grads": gather_tree(whole, sh, part.shards, like),
            "unsummed": gather_tree(grads, sh, part.shards, like),
            "kept": kept}


def _prefill_case(part, np_params_, prompts, routing=None, shards=1,
                  decode=None) -> dict:
    """The sharded ep prefill on this rank: every row's logits (gathered
    over the data axes), the gathered cache; with ``decode`` (the greedy
    tokens), one decode step's logits after it."""
    cfg = port_cfg(ARCH)
    model = Model(cfg)
    local = lm_shard_from_numpy(np_params_, cfg, part.mesh, part.coord,
                                "cpu")
    batch = {"tokens": torch.from_numpy(prompts)}
    hook = (moe.routing_hook(_replayer(routing, part, shards))
            if routing is not None else _nothing())
    with hook, torch.no_grad():
        cache = model.init_cache(local, batch, MAX_LEN, shards=part)
        logits, cache = model.prefill(local, batch, cache, shards=part)
        out = {"logits": part.all_gather_dp(logits).reshape(
            -1, *logits.shape[1:]),
            "cache": gather_cache(cache, cfg, part, prompts.shape[0])[
                "slots"]}
        if decode is not None:
            step, _ = model.decode(local, decode, cache, shards=part)
            out["step"] = part.all_gather_dp(step).reshape(
                -1, *step.shape[1:])
    return out


def _record_case(part, np_params_, batch, prompts) -> dict:
    """Each ``(kind, operand bytes)`` this rank's collectives report in one
    sharded ep train step and in one ep prefill."""
    cfg = port_cfg(ARCH)
    model = Model(cfg)
    params = lm_params_from_numpy(np_params_, cfg, "cpu")
    full = {"params": params, "opt": adamw_init(params)}
    sh = state_shardings(abstract_state(model, OPT), cfg, part.mesh)
    step = make_train_step(model, OPT, shards=part, shardings=sh)
    out = {"train": [], "prefill": []}
    with observe(lambda kind, n: out["train"].append((kind, n))):
        step(shard_tree(full, sh, part.coord), torch_batch(batch))
    local = shard_tree(params, sh["params"], part.coord)
    tokens = {"tokens": torch.from_numpy(prompts)}
    with torch.no_grad():
        cache = model.init_cache(local, tokens, MAX_LEN, shards=part)
        with observe(lambda kind, n: out["prefill"].append((kind, n))):
            model.prefill(local, tokens, cache, shards=part)
    return out


def _refused(fn) -> dict:
    """``fn()``'s ``ValueError`` and the collectives reported before it."""
    seen = []
    try:
        with observe(lambda kind, n: seen.append(kind)):
            fn()
    except ValueError as e:
        return {"error": str(e), "collectives": seen}
    return {"error": None, "collectives": seen}


def _refusal_cases(part, np_params_, batch, prompts) -> dict:
    """Each refusal on this rank of the (2, 2) mesh."""
    cfg = port_cfg(ARCH)
    model = Model(cfg)
    local = lm_shard_from_numpy(np_params_, cfg, part.mesh, part.coord,
                                "cpu")
    tokens = {"tokens": torch.from_numpy(prompts)}
    out = {}
    with torch.no_grad():
        cache = model.init_cache(local, tokens, MAX_LEN, shards=part)
        _, cache = model.prefill(local, tokens, cache, shards=part)
        out["decode"] = _refused(lambda: model.decode(
            local, tokens["tokens"][:, :1], cache, shards=part))
        one = {"tokens": tokens["tokens"][:1]}
        whole_rows = model.init_cache(local, one, MAX_LEN, shards=part)
        out["fully_seq_prefill"] = _refused(lambda: model.prefill(
            local, one, whole_rows, shards=part))
    three = {k: v[:3] for k, v in torch_batch(batch).items()}
    out["uneven_train_rows"] = _refused(lambda: train_step.sharded_grads(
        model, local, three, part))
    cfg5 = port_cfg(ARCH, moe_experts=5)
    whole5 = Model(cfg5).init(torch.Generator().manual_seed(0), device="cpu")
    local5 = shard_tree(whole5, param_shardings(whole5, cfg5, part.mesh),
                        part.coord)
    out["experts"] = _refused(lambda: Model(cfg5).loss(
        local5, torch_batch(batch), shards=part))
    return out


def _rank_cases(rank: int, store: str, params: dict, batch: dict,
                prompts: np.ndarray, routings: dict) -> dict:
    torch.set_num_threads(1)
    dm = init_ranks(mesh_of("2x2"), rank, store)
    meshes = {name: dm if name == "2x2" else mesh_of(name).device_mesh()
              for name in MESHES}
    out = {"rank": rank, "coords": {}, "flat": {}, "grads": {},
           "controls": {}, "prefill": {}, "records": {}}
    for arch, name in CASES:
        part = Participant(meshes[name])
        n = part.mesh.size
        out["coords"][name] = part.coord
        out["flat"][name] = part.di * part.m + part.mi
        out["grads"][arch, name, "free"] = _grads_case(
            part, arch, params[arch], batch)
        out["grads"][arch, name, "replay"] = _grads_case(
            part, arch, params[arch], batch, routings["train", arch, name], n)
        for c in CONTROLS:
            out["controls"][arch, name, c] = _grads_case(
                part, arch, params[arch], batch,
                routings["train", arch, name], n, c)["grads"]
        if arch != ARCH:
            continue
        out["prefill"][name, "free"] = _prefill_case(part, params[ARCH],
                                                     prompts)
        out["prefill"][name, "replay"] = _prefill_case(
            part, params[ARCH], prompts, routings["prefill", name], n)
        out["records"][name] = _record_case(part, params[ARCH], batch,
                                            prompts)
    part = Participant(dm)
    out["accum"] = _grads_case(part, ARCH, params[ARCH], batch,
                               routings["accum"], 4, accum=2)
    out["refusals"] = _refusal_cases(part, params[ARCH], batch, prompts)
    decode = Participant(make_mesh(*DECODE_MESH).device_mesh())
    out["decode"] = _prefill_case(decode, params[ARCH], prompts,
                                  routings["decode"], 4,
                                  decode=routings["decode_tok"])
    return out


# -- fixtures -----------------------------------------------------------------

def prompts_of() -> np.ndarray:
    return np.random.default_rng(2).integers(
        0, 256, (BATCH, SEQ)).astype(np.int32)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The inputs, the reference's subprocesses (started here, read when a
    test needs them) and the port's unsharded ep runs."""
    params = {arch: np_params(arch) for arch in (ARCH, HYBRID)}
    batch = np_batch(port_cfg(ARCH).vocab)
    prompts = prompts_of()
    jax_procs = start_reference(tmp_path_factory.mktemp("ep_virtual_mesh"),
                                params[ARCH], batch, prompts)
    unsharded, routings = {}, {}
    for arch, name in CASES:
        run = unsharded_grads(arch, params[arch], batch, mesh_of(name))
        unsharded[arch, name] = run
        routings["train", arch, name] = run["routing"]
    for name in MESHES:
        run = unsharded_prefill(params[ARCH], prompts, mesh_of(name))
        unsharded["prefill", name] = run
        routings["prefill", name] = run["routing"]
    run = unsharded_grads(ARCH, params[ARCH], batch, mesh_of("2x2"), 2)
    unsharded["accum"] = run
    routings["accum"] = run["routing"]
    run = unsharded_prefill(params[ARCH], prompts, make_mesh(*DECODE_MESH),
                            decode=True)
    unsharded["decode"] = run
    routings["decode"], routings["decode_tok"] = run["routing"], run["tok"]
    return {"params": params, "batch": batch, "prompts": prompts,
            "jax": jax_procs, "unsharded": unsharded, "routings": routings}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("sharded_ep") / "store")
    return run_ranks(_rank_cases, WORLD, store, reference["params"],
                     reference["batch"], reference["prompts"],
                     reference["routings"], timeout_s=JOIN_S)


@pytest.fixture(scope="module")
def jax_ref(reference):
    """Each mesh's reference outputs (waits for its subprocess)."""
    out = {}
    for name, (proc, path, log) in reference["jax"].items():
        proc.wait(timeout=JOIN_S)
        assert proc.returncode == 0, log.read_text()[-4000:]
        out[name] = dict(np.load(path))
    return out


def errors(got: dict, want: dict, key: str = "grads") -> dict:
    """Loss and metric relative errors, each leaf's relative RMS."""
    return {"metrics": max(abs(float(got["metrics"][k]) - float(v))
                           / max(abs(float(v)), 1e-30)
                           for k, v in want["metrics"].items()),
            "leaves": [rel_rms(g, w) for g, w in zip(
                tree.leaves(got[key]), want["grads"], strict=True)]}


def router_leaves(arch: str) -> list[bool]:
    return [str(path[-1]) == "router" for path, _ in tree.leaves_with_path(
        Model(port_cfg(arch)).abstract_params())]


# -- one shard ----------------------------------------------------------------

def test_a_one_by_one_mesh_is_the_unsharded_ep_step_byte_for_byte():
    cfg = port_cfg(ARCH)
    model = Model(cfg)
    state = init_state(model, torch.Generator().manual_seed(0), OPT,
                       device="cpu")
    batch = torch_batch(np_batch(cfg.vocab))
    mesh = make_mesh((1, 1), ("data", "model"))
    shardings = state_shardings(abstract_state(model, OPT), cfg, mesh)
    for accum in (1, 2):
        ep_moe.set_mesh(mesh)
        try:
            want_state, want = make_train_step(model, OPT, accum)(state,
                                                                  batch)
        finally:
            ep_moe.set_mesh(None)
        got_state, got = make_train_step(
            model, OPT, accum, shards=mesh, shardings=shardings)(
            shard_tree(state, shardings, {"data": 0, "model": 0}), batch)
        assert got.keys() == want.keys()
        assert all(sha(got[k]) == sha(want[k]) for k in want), accum
        for a, b in zip(tree.leaves(got_state), tree.leaves(want_state),
                        strict=True):
            assert sha(a) == sha(b), accum


def test_the_sharded_layer_reads_no_published_mesh():
    """The sharded form takes its participant from ``part``: with no mesh
    published (``get_shards`` raises) it runs."""
    ep_moe.set_mesh(None)
    with pytest.raises(RuntimeError):
        ep_moe.get_shards()
    cfg = port_cfg(ARCH)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    loss, _ = model.loss(params, torch_batch(np_batch(cfg.vocab)),
                         shards=make_mesh((1, 1), ("data", "model")))
    assert torch.isfinite(loss)


# -- four ranks ---------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_sharded_ep_gradients_equal_the_unsharded_ep_step(
        ranks, reference, arch, mesh_name):
    want = reference["unsharded"][arch, mesh_name]
    for r in ranks:
        e = errors(r["grads"][arch, mesh_name, "replay"], want)
        assert e["metrics"] <= LOSS_RTOL, (r["rank"], e["metrics"])
        assert max(e["leaves"]) <= GRAD_REL_RMS, (r["rank"], e["leaves"])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_slots_drop_in_every_granite_case(ranks, reference, mesh_name):
    """The capacity factor 1.25 drops slots here, so the sharded step is
    held to ep's own function (not to the token-sorted MoE's), and the
    kept slots are the unsharded step's, shard for shard."""
    want = reference["unsharded"][ARCH, mesh_name]["kept"]
    n = mesh_of(mesh_name).size
    assert not torch.stack(want).all()
    for r in ranks:
        me = r["flat"][mesh_name]
        got = r["grads"][ARCH, mesh_name, "replay"]["kept"]
        assert len(got) == len(want) // n
        assert all(torch.equal(g, w) for g, w in zip(got, want[me::n]))


@pytest.mark.parametrize("arch,mesh_name", CASES)
@pytest.mark.parametrize("name", [*CONTROLS, "router_unsummed"])
def test_each_control_lies_past_the_leaf_limit(ranks, reference, arch,
                                               mesh_name, name):
    """The entry backward keeping only the participant's own block of
    ``dx``, the router's gradient without the sum over ``"model"``, the
    aux terms' gradient counted whole on every model participant: each
    moves a leaf past ``GRAD_REL_RMS``, the last two the router's."""
    want = reference["unsharded"][arch, mesh_name]
    routers = router_leaves(arch)
    for r in ranks:
        if name == "router_unsummed":
            got = r["grads"][arch, mesh_name, "replay"]
            e = errors(got, want, "unsummed")["leaves"]
        else:
            e = [rel_rms(g, w) for g, w in zip(
                tree.leaves(r["controls"][arch, mesh_name, name]),
                want["grads"], strict=True)]
        assert max(e) > GRAD_REL_RMS, (r["rank"], e)
        if name != "own_block_entry":
            assert min(x for x, is_r in zip(e, routers) if is_r) \
                > GRAD_REL_RMS, (r["rank"], e)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_ep_gradients_equal_jax_value_and_grad(ranks, jax_ref,
                                                       mesh_name):
    want = jax_ref[mesh_name]
    for r in ranks:
        got = r["grads"][ARCH, mesh_name, "free"]
        assert float(got["metrics"]["loss"]) == pytest.approx(
            float(want["loss"]), rel=JAX_LOSS_RTOL)
        for k, v in got["metrics"].items():
            assert float(v) == pytest.approx(
                float(want[f"m/{k}"]), rel=JAX_LOSS_RTOL, abs=1e-7), k
        leaves = flat(lm_params_to_numpy(got["grads"]))
        assert {f"g/{k}" for k in leaves} == {k for k in want
                                               if k.startswith("g/")}
        errs = {k: float(np.abs(g - want[f"g/{k}"]).max()
                         / max(np.abs(want[f"g/{k}"]).max(), 1e-30))
                for k, g in leaves.items()}
        assert max(errs.values()) <= JAX_GRAD_TOL, (mesh_name, errs)


def test_micro_batches_take_their_capacity_from_their_block(ranks,
                                                            reference):
    """``accum=2`` on (2, 2): each micro-batch of 2 rows, one a data
    participant, routes 8 tokens a model participant (capacity 10 a
    destination, not the whole batch's 20)."""
    want = reference["unsharded"]["accum"]
    assert ep_moe.capacity(8, 2, 2, 1.25) == 10
    for r in ranks:
        got = r["accum"]
        e = errors(got, want)
        assert e["metrics"] <= LOSS_RTOL and max(e["leaves"]) <= GRAD_REL_RMS
        assert all(k.numel() == 8 * 2 for k in got["kept"])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_ep_prefill_equals_the_unsharded_port(ranks, reference,
                                                      mesh_name):
    want = reference["unsharded"]["prefill", mesh_name]
    for r in ranks:
        got = r["prefill"][mesh_name, "replay"]
        assert rel_rms(got["logits"], want["logits"]) <= REL_RMS
        for g, w in zip(tree.leaves(got["cache"]), tree.leaves(want["cache"]),
                        strict=True):
            assert rel_rms(g, w) <= REL_RMS


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_ep_prefill_matches_the_reference(ranks, jax_ref, mesh_name):
    want = jax_ref[mesh_name]
    for r in ranks:
        got = r["prefill"][mesh_name, "free"]
        np.testing.assert_allclose(got["logits"].numpy(), want["logits"],
                                   **LOGIT_TOL)
        for k, g in flat(lm_params_to_numpy(got["cache"])).items():
            np.testing.assert_allclose(g, want[f"c/{k}"], **LOGIT_TOL)


def test_a_decode_step_runs_at_a_model_axis_of_one(ranks, reference):
    want = reference["unsharded"]["decode"]
    for r in ranks:
        got = r["decode"]
        assert rel_rms(got["logits"], want["logits"]) <= REL_RMS
        assert rel_rms(got["step"], want["step"]) <= REL_RMS


@pytest.mark.parametrize("case", ["decode", "fully_seq_prefill",
                                  "uneven_train_rows", "experts"])
def test_each_refusal_raises_on_every_rank_before_any_collective(ranks,
                                                                 case):
    for r in ranks:
        got = r["refusals"][case]
        assert got["error"] is not None, (r["rank"], case)
        assert "expert parallelism" in got["error"]
        assert got["collectives"] == [], (r["rank"], got["collectives"])


def meta_records(mesh_name: str, coord: dict, params: dict, batch: dict,
                 prompts: np.ndarray) -> dict:
    """``_record_case`` on ``meta`` over ``MetaShards`` at ``coord``."""
    cfg = port_cfg(ARCH, attention_impl="dense")
    model = Model(cfg)
    mesh = mesh_of(mesh_name)
    part = Participant(MetaShards(mesh, coord))
    abstract = abstract_state(model, OPT)
    sh = state_shardings(abstract, cfg, mesh)
    step = make_train_step(model, OPT, shards=part, shardings=sh)
    meta = {k: torch.empty(v.shape, dtype=torch.int32, device="meta")
            for k, v in batch.items()}
    out = {"train": [], "prefill": []}
    with observe(lambda kind, n: out["train"].append((kind, n))):
        step(shard_tree(abstract, sh, coord), meta)
    local = shard_tree(abstract["params"], sh["params"], coord)
    tokens = {"tokens": torch.empty(prompts.shape, dtype=torch.int32,
                                    device="meta")}
    cache = model.init_cache(local, tokens, MAX_LEN, shards=part)
    with observe(lambda kind, n: out["prefill"].append((kind, n))):
        model.prefill(local, tokens, cache, shards=part)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_the_meta_count_is_every_rank_record(ranks, reference, mesh_name):
    """The dry run's count of the ep train step and prefill: call for
    call, kind, order and operand bytes; the MoE's row-count stand-in
    (``moe.local_rows``, ``gmm``'s) changes no record."""
    for r in ranks:
        want = meta_records(mesh_name, r["coords"][mesh_name],
                            reference["params"], reference["batch"],
                            reference["prompts"])
        assert r["records"][mesh_name] == want, r["rank"]
        kinds = {k for k, _ in want["train"]}
        assert "all-to-all" in kinds and "all-gather" in kinds
        with mock.patch.object(moe, "local_rows",
                               lambda mine, slots, le, e: slots):
            assert meta_records(mesh_name, r["coords"][mesh_name],
                                reference["params"], reference["batch"],
                                reference["prompts"]) == want

