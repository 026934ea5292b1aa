"""``repro_torch.launch.{specs,dryrun,report}`` against the JAX package.

- ``input_specs``: for every cell, the port's ``meta`` tensors equal the
  reference's ``ShapeDtypeStruct`` s in tree, shapes and dtypes (exact);
  the reference's ``abstract_cache`` runs its own ``jax.eval_shape``.  The
  port's cache also holds ``"pos"`` (an ``int``, the host mirror of
  ``"len"``) and, for enc-dec, ``"cross_len"``: the only extra leaves.
- Per-device argument bytes: for the params of every arch on both
  production meshes, equal to the sum over leaves of
  ``NamedSharding(AbstractMesh(...), spec).shard_shape`` bytes where every
  sharded dimension divides, and of the ceil-divided shape where one does
  not (``shard_shape`` raises there), counting the leaves of each branch
  (exact).
- ``run_cell`` end to end on meta for a dense, an MoE and an SSM cell at
  full size: ``status == "ok"``, the reference's result keys, and
  ``report.py`` renders them; the dense and MoE cells count one
  participant's sharded collectives on both meshes (the MoE's through
  ``"gmm"``), the SSM cell too (24 SSD heads on a model axis of 16: 1.5
  heads a participant, its state all-gathered);
- an ``--moe-impl ep`` cell counts the sharded program with the ep MoE
  inside it (``"sharded program, MoE 'ep'"``: all_to_alls among its
  collectives), and its decode cell is an error cell naming the
  refusal, as the reference records a cell that fails to compile;
- no cell is refused: every sharded program of the 32 cells of
  mamba2-130m and seamless-m4t-medium (the encoder-decoder) runs on both
  meshes and counts its collectives, and a refusal of the sharded layers
  still names itself (``count_collectives``).
"""
from __future__ import annotations

import json
import math

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding as JaxSharding

import repro.parallel.sharding as ref_sharding
from repro.configs import ARCH_IDS
from repro.configs import cells as ref_cells
from repro.configs import get_config as ref_config
from repro.launch import specs as ref_specs
from repro.models import Model as RefModel
from repro_torch import tree
from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.launch import dryrun, report, specs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import Model
from repro_torch.parallel import sharding

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
#: The reference's result keys of an ``ok`` cell (``dryrun.py:283-300``).
RESULT_KEYS = {"version", "arch", "shape", "mesh", "status",
               "compile_seconds", "cost_extraction_seconds", "cost",
               "memory_analysis", "collectives", "roofline", "overrides"}
ROOFLINE_KEYS = {"flops_per_device", "bytes_per_device",
                 "bytes_upper_bound_per_device", "collective_bytes_per_device",
                 "chips", "compute_s", "memory_s", "memory_upper_s",
                 "collective_s", "dominant", "model_flops", "useful_ratio",
                 "roofline_fraction"}


def _jax_leaves(jax_tree) -> dict:
    return {tuple(str(k.key) if hasattr(k, "key") else str(k.idx)
                  for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax_tree)[0]}


def _port_leaves(port_tree) -> dict:
    return {tuple(str(k) for k in path): leaf
            for path, leaf in tree.leaves_with_path(port_tree)}


@pytest.mark.parametrize("arch,shape", [(a, s.name) for a, s in cells()])
def test_input_specs_equal_the_reference(arch, shape):
    assert [(a, s.name) for a, s in ref_cells()] == \
        [(a, s.name) for a, s in cells()]
    rcfg, cfg = ref_config(arch), get_config(arch)
    want = _jax_leaves(ref_specs.input_specs(RefModel(rcfg), rcfg,
                                             SHAPES[shape]))
    got = _port_leaves(specs.input_specs(Model(cfg), cfg, SHAPES[shape]))
    extra = set(got) - set(want)
    assert {p[-1] for p in extra} <= {"pos", "cross_len"}, extra
    assert all(isinstance(got[p], int) for p in extra if p[-1] == "pos")
    for path, w in want.items():
        g = got[path]
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), (path, g.shape, w.shape)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path


def _reference_bytes(leaf, spec, mesh) -> tuple[int, bool]:
    """One leaf's per-device bytes from the reference's sharding, and
    whether ``shard_shape`` took it (every sharded dim divides)."""
    elt = np.dtype(str(leaf.dtype)).itemsize
    try:
        shape = JaxSharding(mesh, spec).shard_shape(tuple(leaf.shape))
        return math.prod(shape) * elt, True
    except ValueError:
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        shape = []
        for dim, e in zip(leaf.shape, entries):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            shape.append(-(-dim // math.prod(mesh.shape[a] for a in axes)))
        return math.prod(shape) * elt, False


def test_argument_bytes_equal_the_reference_shardings():
    branches = {True: 0, False: 0}
    for mesh_name, (shape, axes) in MESHES.items():
        ref_mesh, mesh = AbstractMesh(shape, axes), Mesh(shape, axes)
        for arch in ARCH_IDS:
            rcfg, cfg = ref_config(arch), get_config(arch)
            ref_params = RefModel(rcfg).abstract_params()
            want_sh = ref_sharding.param_shardings(ref_params, rcfg,
                                                   ref_mesh)
            want = 0
            for leaf, sh in zip(jax.tree_util.tree_leaves(ref_params),
                                jax.tree_util.tree_leaves(want_sh)):
                nbytes, divides = _reference_bytes(leaf, sh.spec, ref_mesh)
                want += nbytes
                branches[divides] += 1
            params = Model(cfg).abstract_params()
            got = dryrun.argument_bytes(
                params, sharding.param_shardings(params, cfg, mesh))
            assert got == want, (arch, mesh_name)
    # The production rules shard a dimension only where it divides (every
    # leaf takes ``shard_shape``'s branch); the ceil branch is pinned by
    # test_shard_shape_ceil_divides.
    assert branches == {True: 550, False: 0}, branches


def test_shard_shape_ceil_divides():
    mesh = Mesh((2, 16, 16), ("pod", "data", "model"))
    sh = sharding.NamedSharding(mesh, sharding.spec(("pod", "data"), None,
                                                    "model"))
    assert dryrun.shard_shape((64, 3, 33), sh) == (2, 3, 3)
    assert dryrun.shard_shape((64, 3, 33, 5),
                              sharding.NamedSharding(mesh, ())) == (64, 3, 33, 5)


#: (arch, shape): the cells whose collectives the sharded layers refuse
#: to run, on both production meshes: none
REFUSED: set = set()
#: The cells that were refused until the SSD ran on blocks of channels and
#: the encoder-decoder sharded.
ONCE_REFUSED = {("mamba2_130m", s) for s in ("train_4k", "prefill_32k",
                                             "decode_32k", "long_500k")} | {
    ("seamless_m4t_medium", s) for s in ("train_4k", "prefill_32k",
                                         "decode_32k")}


@pytest.mark.parametrize("arch,shape", [("granite_8b", "prefill_32k"),
                                        ("granite_moe_1b_a400m", "train_4k"),
                                        ("mamba2_130m", "decode_32k")])
def test_run_cell_on_meta_at_full_size(arch, shape, tmp_path, capsys):
    counts: dict = {}
    refused = (arch, shape) in REFUSED
    for mesh_kind in ("single", "multi"):
        r = dryrun.run_cell(arch, SHAPES[shape], mesh_kind, force=True,
                            results_dir=str(tmp_path), counts=counts)
        assert r["status"] == "ok", r.get("traceback")
        assert set(r) == RESULT_KEYS
        assert set(r["roofline"]) == ROOFLINE_KEYS
        assert r["memory_analysis"]["temp_size_in_bytes"] is None
        assert r["memory_analysis"]["argument_size_in_bytes"] > 0
        roof = r["roofline"]
        assert roof["chips"] == (256 if mesh_kind == "single" else 512)
        assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
        coll = r["collectives"]
        if refused:
            assert roof["collective_bytes_per_device"] is None
            assert roof["collective_s"] is None
            assert "does not divide" in coll["skipped"]
            assert roof["dominant"] in ("compute", "memory")
        else:
            # one participant's sharded program, counted on meta
            assert coll["skipped"] is None
            assert roof["collective_bytes_per_device"] > 0
            assert roof["collective_bytes_per_device"] == sum(
                coll["bytes_by_kind"].values())
            assert coll["count_by_kind"]["all-reduce"] > 0
            assert coll["source"] == ("sharded program, MoE 'gmm'"
                                      if "moe" in arch else
                                      "sharded program")
        kernels = r["cost"]["kernels"]
        cfg = dryrun.make_cell_cfg(arch)
        if cfg.ssm_state:
            assert kernels == {}     # decode: the recurrent step is plain
        else:
            assert kernels["flash_attention"]["launches"] >= cfg.n_layers
        with open(tmp_path / f"{mesh_kind}__{arch}__{shape}.json") as f:
            assert json.load(f) == r
    # one count of the step for both meshes, one of the collectives a mesh
    assert len(counts) == 3
    rows = report.load(results_dir=str(tmp_path))
    table = report.dryrun_table(rows)
    assert table.count("| ok |") == 2
    assert ("n/a:" in table) == refused
    assert ("all-reduce=" in table) != refused
    roof = report.roofline_table(rows, mesh="multi")
    assert f"| {arch} | {shape} |" in roof
    report.main(["--results-dir", str(tmp_path)])
    assert "### Roofline (single-pod)" in capsys.readouterr().out


def test_moe_cells_default_to_the_dense_formulation():
    assert dryrun.make_cell_cfg("olmoe_1b_7b").moe_impl == "dense"
    assert dryrun.make_cell_cfg("olmoe_1b_7b", moe_impl="gmm").moe_impl == \
        "gmm"
    cfg = dryrun.make_cell_cfg("glm4_9b", attention_impl="pallas")
    assert cfg.attention_impl == "cuda"
    assert dryrun.make_cell_cfg("glm4_9b").attention_impl == "cuda"


def test_a_failing_cell_is_data(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no")
    monkeypatch.setattr(dryrun, "build_cell", boom)
    r = dryrun.run_cell("glm4_9b", SHAPES["decode_32k"], "single",
                        force=True, results_dir=str(tmp_path))
    assert r["status"] == "error" and "RuntimeError: no" in r["error"]
    assert "FAIL" in report.dryrun_table(report.load(
        results_dir=str(tmp_path)))


def test_gmm_cell_counts_the_kernel_and_its_plain_backward(tmp_path):
    """``--moe-impl gmm``: K5's work in the forward and the recompute; its
    backward, the plain version's autograd, runs on meta too (one product
    of every row with one expert's weights stands in for the per-expert
    split)."""
    r = dryrun.run_cell("granite_moe_1b_a400m", SHAPES["train_4k"],
                        "single", force=True, moe_impl="gmm",
                        results_dir=str(tmp_path), tag="gmm")
    assert r["status"] == "ok", r.get("traceback")
    cfg = get_config("granite_moe_1b_a400m")
    assert r["cost"]["kernels"]["moe_gmm"]["launches"] == 2 * 3 * cfg.n_layers
    assert r["overrides"]["moe_impl"] == "gmm"
    assert report.load(results_dir=str(tmp_path)) == []
    assert len(report.load(variants=True, results_dir=str(tmp_path))) == 1


def test_port_results_never_land_in_the_reference_directory():
    assert dryrun.RESULTS_DIR.endswith("dryrun_results_torch")
    assert report.RESULTS_DIR.endswith("dryrun_results_torch")


def test_the_refused_cells_are_read_off_the_configs():
    """No cell's collectives are refused: the sharded layers run every
    config on a model axis of 16 (mamba2-130m's 24 SSD heads as blocks of
    channels), and the encoder-decoder.  The cells refused before are
    counted on both meshes: each once-refused cell's sharded program
    reports its collectives, an all-gather among them (mamba2's whole SSD
    state gathered from the participants' channels, seamless's
    vocabulary), and a refusal of the sharded layers still names itself."""
    from repro_torch.models import lm

    def refuses(arch: str) -> bool:
        try:
            lm.check_shardable(get_config(arch), 16)
        except NotImplementedError:
            return True
        return False
    assert {(a, s.name) for a, s in cells() if refuses(a)} == REFUSED
    for arch, shape in sorted(ONCE_REFUSED):
        for mesh_kind in ("single", "multi"):
            mesh = dryrun.make_production_mesh(multi_pod=mesh_kind == "multi")
            cfg = dryrun.make_cell_cfg(arch)
            args, shardings, _ = dryrun.build_cell(cfg, SHAPES[shape], mesh)
            got = dryrun.count_collectives(dryrun.sharded_step(
                dryrun.collective_cfg(cfg), SHAPES[shape], mesh, args,
                shardings))
            assert got["skipped"] is None, got
            assert got["bytes_by_kind"]["all-gather"] > 0, got
            assert got["count_by_kind"]["all-reduce"] > 0, got

    def refused():
        raise NotImplementedError("a layer the sharded program refuses")
    got = dryrun.count_collectives(refused)
    assert got["skipped"] == ("NotImplementedError: a layer the sharded "
                              "program refuses")
    assert "bytes_by_kind" not in got


def test_the_collective_count_follows_zero1_and_the_mesh(tmp_path):
    """ZeRO-1 adds the all-gather of the data slices of every moment's
    update; the multi-pod mesh halves each data participant's rows."""
    shape = SHAPES["train_4k"]
    counts: dict = {}
    got = {}
    for zero in (False, True):
        for mesh_kind in ("single", "multi"):
            r = dryrun.run_cell("granite_moe_1b_a400m", shape, mesh_kind,
                                force=True, zero_opt=zero, counts=counts,
                                results_dir=str(tmp_path / str(zero)))
            assert r["status"] == "ok", r.get("traceback")
            got[zero, mesh_kind] = r["collectives"]
    assert len(counts) == 1 + 4
    for mesh_kind in ("single", "multi"):
        plain, zero = got[False, mesh_kind], got[True, mesh_kind]
        assert zero["count_by_kind"]["all-gather"] == \
            plain["count_by_kind"]["all-gather"] + 1
        assert zero["bytes_by_kind"]["all-gather"] > \
            plain["bytes_by_kind"]["all-gather"]
    assert got[False, "multi"]["bytes_by_kind"]["all-reduce"] < \
        got[False, "single"]["bytes_by_kind"]["all-reduce"]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_an_ep_cell_counts_its_sharded_program(shape, tmp_path,
                                               monkeypatch):
    """The collectives of granite-moe's ``--moe-impl ep`` cells come from
    the participant's sharded program, ep inside it.  (The cell's FLOPs
    are its unsharded step's over the 256-shard list form, minutes of meta
    work a cell: stubbed here, the count under test is the program's.)"""
    def unsharded_count(step):
        return {"flops": 1.0, "bytes": 1.0, "bytes_upper": 1.0,
                "coll_bytes_by_kind": {}, "coll_count_by_kind": {},
                "kernels": {}, "seconds": 0.0}
    monkeypatch.setattr(dryrun, "count_step", unsharded_count)
    r = dryrun.run_cell("granite_moe_1b_a400m", SHAPES[shape], "single",
                        force=True, moe_impl="ep", tag="ep",
                        results_dir=str(tmp_path))
    if shape.startswith("decode"):
        assert r["status"] == "error"
        assert r["error"].startswith("ValueError: expert parallelism")
        return
    assert r["status"] == "ok", r.get("traceback")
    coll = r["collectives"]
    assert coll["source"] == "sharded program, MoE 'ep'"
    assert coll["skipped"] is None
    cfg = get_config("granite_moe_1b_a400m")
    # the dispatch (rows, ids, flags) and return a layer, forward and
    # recompute, and the two of the backward
    assert coll["count_by_kind"]["all-to-all"] == 10 * cfg.n_layers
    assert r["overrides"]["moe_impl"] == "ep"
