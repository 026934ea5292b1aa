"""The rank form of ``repro_torch.parallel`` (one shard a
``torch.distributed`` rank) against its list form, byte for byte.

One spawn of 4 gloo ranks, meeting at a ``FileStore`` under the test's
temporary directory (no port), runs every case; each rank runs the case's
list form too, on the same seeded inputs in the same process (one thread),
and sends both back.  ``tests/test_torch_parallel.py`` holds the list form
to the reference's virtual mesh.  Held equal, bit for bit: each
collective, the ep MoE at meshes (1, 2), (1, 4) and (2, 2) (output,
``MoeAux``, every shard's kept slots, in float32 and at (1, 4) in
bfloat16) and a model's prefill through it, the 4-stage pipeline, the
int8 all-reduce's gathered payloads, scales and mean, and the ``observe``
records of both forms.  A decode-shaped input raises ``ValueError`` on
every rank before any collective, and a rank that raises or dies fails
the run instead of hanging it (the spawn joins within ``JOIN_S``).
"""
from __future__ import annotations

import os
import time
from dataclasses import replace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch.mesh import init_ranks, make_mesh, run_ranks
from repro_torch.models import Model, smoke_variant
from repro_torch.parallel import collectives, compress, ep_moe, pipeline
from repro_torch.parallel.dist import RankShards

WORLD = 4
JOIN_S = 120.0
#: Capacity factor of the ep cases: low enough that slots drop.
EP_CF = 0.5
#: ep cases: (data, model) mesh and dtype.
EP_CASES = {"1x2": ((1, 2), torch.float32), "1x4": ((1, 4), torch.float32),
            "2x2": ((2, 2), torch.float32),
            "1x4_bf16": ((1, 4), torch.bfloat16)}
COLLECTIVES = ("all_gather_model", "all_gather_data_model", "all_to_all",
               "ppermute_next", "psum", "pmean")
ALLREDUCE_SHAPE = (3, 300)          # blocks of 256 with a ragged last one


def _moe_cfg():
    return replace(smoke_variant(get_config("granite_moe_1b_a400m")),
                   moe_impl="ep")


def _ep_inputs(dtype):
    cfg = _moe_cfg()
    layer = {k: v[0].to(dtype) for k, v in Model(cfg).init(device="cpu")
             ["blocks"]["L0_moe"].items()}
    x = np.random.default_rng(1).normal(0, 1, (4, 8, cfg.d_model))
    return cfg, layer, torch.from_numpy(x.astype(np.float32)).to(dtype)


def _recorded(fn):
    """``(fn(), [(kind, bytes), ...])`` of the collectives ``fn`` ran."""
    rec = []
    with collectives.observe(lambda kind, n: rec.append((kind, n))):
        out = fn()
    return out, rec


def _ep_run(mesh, cfg, layer, x):
    kept = []
    ep_moe.set_mesh(mesh)
    try:
        with ep_moe.dispatch_hook(kept.append):
            (y, aux), rec = _recorded(lambda: ep_moe.ep_moe_apply(
                layer, x, cfg, capacity_factor=EP_CF))
    finally:
        ep_moe.set_mesh(None)
    return {"y": y, "lb": aux.load_balance_loss, "z": aux.router_z_loss,
            "load": aux.expert_load, "kept": [k.clone() for k in kept],
            "record": rec}


def _collective(sh, name: str, rank: int):
    """One collective over ``sh`` of a (2, 2) mesh on small tensors of
    several dtypes (each shard's distinct); returns its outputs, a list
    of the held shards' for each dtype."""
    def val(r, dtype):
        t = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r
        return (t > 12 + r) if dtype == torch.bool else t.to(dtype)

    outs = []
    for dtype in (torch.float32, torch.bfloat16, torch.int8, torch.bool):
        held = [val(r, dtype) for r in sh.flat_index(("data", "model"))]
        if name.startswith("all_gather"):
            axes = "model" if name == "all_gather_model" else ("data",
                                                               "model")
            outs.append(sh.all_gather(held, axes))
        elif name == "all_to_all":
            outs.append([torch.stack(b) for b in sh.all_to_all(
                [torch.stack([t, ~t if dtype == torch.bool else -t])
                 for t in held], "model")])
        elif name == "ppermute_next":
            outs.append(sh.ppermute_next(held, "model"))
        elif dtype in (torch.float32, torch.bfloat16):
            outs.append(getattr(sh, name)(held, ("data", "model")))
    return outs


def _rank_cases(rank: int, store: str) -> dict:
    """Every case on this rank, rank form and list form."""
    torch.set_num_threads(1)
    dm = init_ranks(make_mesh((2, 2), ("data", "model")), rank, store)
    pair = RankShards(make_mesh((1, 2), ("data", "model")),
                      {"model": dm.get_group("model")},
                      {"data": 0, "model": dm.get_local_rank("model")})
    rank_meshes = {"2x2": dm, "1x2": pair,
                   "1x4": make_mesh((1, 4), ("data", "model")).device_mesh()}
    out = {"rank": rank, "form": type(collectives.shards(dm)).__name__,
           "coord": collectives.shards(dm).coords[0]}

    world = collectives.shards(dm)
    listed = collectives.ListShards(make_mesh((2, 2), ("data", "model")))
    out["collectives"] = {
        name: (_recorded(lambda: _collective(world, name, rank)),
               _recorded(lambda: _collective(listed, name, rank)))
        for name in COLLECTIVES}

    out["ep"] = {}
    for case, ((dp, m), dtype) in EP_CASES.items():
        cfg, layer, x = _ep_inputs(dtype)
        out["ep"][case] = (
            _ep_run(rank_meshes[f"{dp}x{m}"], cfg, layer, x),
            _ep_run(make_mesh((dp, m), ("data", "model")), cfg, layer, x))

    # A model's prefill through the rank form, and a decode step: S = 1
    # over M = 4 raises on every rank before any collective.
    cfg = _moe_cfg()
    model = Model(cfg)
    params = model.init(device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    model_runs = []
    for mesh in (rank_meshes["1x4"], make_mesh((1, 4), ("data", "model"))):
        ep_moe.set_mesh(mesh)
        cache = model.init_cache(params, {"tokens": tokens}, 12)
        logits, cache = model.prefill(params, {"tokens": tokens}, cache)
        try:
            model.decode(params, tokens[:, :1], cache)
            raised = None
        except ValueError as e:
            raised = str(e)
        model_runs.append({"logits": logits, "decode_raises": raised})
    ep_moe.set_mesh(None)
    out["model"] = model_runs
    # no rank waits in a collective after the raise: one more runs
    out["after_raise"] = world.psum([torch.ones(1)], ("data", "model"))[0]

    rng = np.random.default_rng(3)
    ws = torch.from_numpy(rng.normal(0, 0.3, (WORLD, 16, 16))
                          .astype(np.float32))
    xp = torch.from_numpy(rng.normal(0, 1, (8, 2, 16)).astype(np.float32))
    fn = lambda w, h: torch.tanh(h @ w)  # noqa: E731
    pipe = make_mesh((WORLD,), ("pipe",))
    out["pipeline"] = (
        _recorded(lambda: pipeline.pipeline_apply(
            fn, ws[rank:rank + 1], xp, pipe.device_mesh())),
        _recorded(lambda: pipeline.pipeline_apply(fn, ws, xp, pipe)))

    xs = [torch.from_numpy(np.random.default_rng(4 + i).normal(
        0, 1 + i, ALLREDUCE_SHAPE).astype(np.float32)) for i in range(WORLD)]
    group = RankShards.of_group(dist.group.WORLD)
    qts = [compress.quantize(t) for t in xs]
    out["allreduce"] = {
        "payloads": (group.all_gather([qts[rank].q], "group")[0],
                     collectives.all_gather([q.q for q in qts])),
        "scales": (group.all_gather([qts[rank].scale], "group")[0],
                   collectives.all_gather([q.scale for q in qts])),
        "mean": (_recorded(lambda: compress.compressed_allreduce_mean(
                     xs[rank], dist.group.WORLD)),
                 _recorded(lambda: compress.compressed_allreduce_mean(xs)))}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("dist") / "store")
    t0 = time.monotonic()
    out = run_ranks(_rank_cases, WORLD, store, timeout_s=JOIN_S)
    return {"ranks": out, "seconds": time.monotonic() - t0}


def same(a, b) -> bool:
    """Equal dtype, shape and bytes (tensors, or lists / dicts of them)."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and bool(
                    (a.reshape(-1).view(torch.uint8)
                     == b.reshape(-1).view(torch.uint8)).all()))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return a == b


def list_position(run: dict, mesh_shape) -> int:
    """The rank's shard among the list form's, in its shard order: the
    rank on a mesh of every rank; its ``model`` index on a (1, 2) mesh
    (one model group of the (2, 2) mesh)."""
    dp, m = mesh_shape
    return run["rank"] if dp * m == WORLD else run["coord"]["model"]


# -- the ranks ------------------------------------------------------------------

def test_ranks_join_one_mesh_within_the_limit(runs):
    assert [r["rank"] for r in runs["ranks"]] == list(range(WORLD))
    assert {r["form"] for r in runs["ranks"]} == {"RankShards"}
    assert [r["coord"] for r in runs["ranks"]] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]
    assert runs["seconds"] < JOIN_S


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_equals_the_list_form(runs, name):
    for r in runs["ranks"]:
        (got, rec), (want, want_rec) = r["collectives"][name]
        # the list form holds every shard: this rank's output is its own
        assert same([g[0] for g in got], [w[r["rank"]] for w in want]), (
            name, r["rank"])
        assert rec == want_rec


def test_collectives_move_the_shards_data(runs):
    r = runs["ranks"][3]                       # data 1, model 1
    (got, _), _ = r["collectives"]["ppermute_next"]
    assert torch.equal(got[0][0], torch.arange(6.).reshape(2, 3) + 20)
    (got, _), _ = r["collectives"]["all_gather_data_model"]
    assert got[0][0][:, 0, 0].tolist() == [0, 10, 20, 30]
    (got, _), _ = r["collectives"]["all_to_all"]
    assert got[0][0][:, 0, 0].tolist() == [-20, -30]   # block 1 of each
    (got, _), _ = r["collectives"]["psum"]
    assert torch.equal(got[0][0], 4 * torch.arange(6.).reshape(2, 3) + 60)
    (got, _), _ = runs["ranks"][2]["collectives"]["ppermute_next"]
    assert torch.equal(got[0][0], torch.zeros(2, 3))   # model 0 gets zeros


# -- expert parallelism -------------------------------------------------------

@pytest.mark.parametrize("case", list(EP_CASES))
def test_ep_output_and_aux_equal_the_list_form(runs, case):
    for r in runs["ranks"]:
        got, want = r["ep"][case]
        for key in ("y", "lb", "z", "load"):
            assert same(got[key], want[key]), (case, r["rank"], key)
        assert got["y"].dtype == EP_CASES[case][1]


@pytest.mark.parametrize("case", list(EP_CASES))
def test_ep_kept_slots_equal_the_list_forms_shard(runs, case):
    shape = EP_CASES[case][0]
    for r in runs["ranks"]:
        got, want = r["ep"][case]
        assert len(got["kept"]) == 1 and len(want["kept"]) == shape[0] * \
            shape[1]
        assert same(got["kept"][0], want["kept"][list_position(r, shape)])
    assert not all(bool(k.all()) for r in runs["ranks"]
                   for k in r["ep"][case][0]["kept"])    # slots did drop


@pytest.mark.parametrize("case", list(EP_CASES))
def test_ep_observed_collectives_equal_the_list_form(runs, case):
    for r in runs["ranks"]:
        got, want = r["ep"][case]
        assert got["record"] == want["record"]
    kinds = [k for k, _ in runs["ranks"][0]["ep"][case][0]["record"]]
    assert kinds == ["all-to-all"] * 4 + ["all-gather"] + ["all-reduce"] * 3


def test_ep_prefill_logits_equal_the_list_form(runs):
    for r in runs["ranks"]:
        got, want = r["model"]
        assert same(got["logits"], want["logits"]), r["rank"]
        assert torch.isfinite(got["logits"]).all()


def test_a_decode_step_raises_on_every_rank(runs):
    for r in runs["ranks"]:
        got, want = r["model"]
        assert got["decode_raises"] and "multiples of 4" in \
            got["decode_raises"]
        assert got["decode_raises"] == want["decode_raises"]
        assert torch.equal(r["after_raise"], torch.full((1,), 4.0))


# -- pipeline and int8 all-reduce ----------------------------------------------

def test_pipeline_equals_the_list_form(runs):
    for r in runs["ranks"]:
        (got, rec), (want, want_rec) = r["pipeline"]
        assert same(got, want) and got.shape == (8, 2, 16)
        assert rec == want_rec
        assert [k for k, _ in rec] == ["collective-permute"] * 11 + [
            "all-gather"]


@pytest.mark.parametrize("part", ["payloads", "scales"])
def test_allreduce_wire_equals_the_list_form(runs, part):
    for r in runs["ranks"]:
        got, want = r["allreduce"][part]
        assert same(got, want)
        assert got.dtype == (torch.int8 if part == "payloads"
                             else torch.float32)


def test_allreduce_mean_equals_the_list_form(runs):
    for r in runs["ranks"]:
        (got, rec), (want, want_rec) = r["allreduce"]["mean"]
        assert same(got, want) and got.shape == ALLREDUCE_SHAPE
        # 900 values: 4 blocks of 256, int8 payloads and float32 scales
        assert rec == want_rec == [("all-gather", 4 * 256),
                                   ("all-gather", 4 * 4)]


# -- failures ---------------------------------------------------------------------

def _fail_one(rank: int, store: str, how: str):
    """Rank 1 raises (or exits) while rank 0 waits in a collective."""
    dm = init_ranks(make_mesh((1, 2), ("data", "model")), rank, store)
    if rank == 1:
        if how == "exits":
            os._exit(3)
        raise RuntimeError("rank 1 gives up")
    return collectives.shards(dm).all_gather([torch.ones(2)], "model")


@pytest.mark.parametrize("how", ["raises", "exits"])
def test_a_rank_that_fails_fails_the_run_without_a_hang(tmp_path, how):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_ranks(_fail_one, 2, str(tmp_path / "store"), how,
                  timeout_s=JOIN_S)
    if how == "raises":
        assert "rank 1 failed" in str(err.value)
        assert "rank 1 gives up" in str(err.value)
    else:       # seen as the exit, or as rank 0's collective losing its peer
        assert ("rank 1 exited with code 3" in str(err.value)
                or "rank 0 failed" in str(err.value))
    assert time.monotonic() - t0 < JOIN_S
