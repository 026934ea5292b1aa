"""Dry run on ``meta`` tensors: every (arch × shape) cell's step on the
production meshes, with its roofline terms.

The JAX package proves its distribution config coherent without hardware
by lowering and compiling every cell for the 16×16 single-pod and the
2×16×16 multi-pod mesh.  Here the counterpart of that gate is the cell's
step run at full depth on ``meta`` tensors (nothing is computed or
allocated): the train step's loss, backward (with ``remat``) and AdamW
update, the prefill, or one decode step.  A cell that raises is
``status: "error"`` with its traceback.  Around the step,
:class:`~repro_torch.launch.roofline.StepCounter` counts FLOPs, bytes,
the port's explicit collectives and the hand-written kernels' work.

- No depth extrapolation: the reference compiles depth-1 and depth-2
  unrolled variants because XLA's cost analysis counts a while loop's
  body once; eager PyTorch runs every layer, so the count is at full
  depth (1–8 s a cell on a host core).
- Per-device FLOPs and bytes are the global counts over the mesh size.
- ``memory_analysis.argument_size_in_bytes`` is the per-device bytes of
  every input leaf under the port's shardings (each dimension
  ceil-divided by the product of its spec entry's axis sizes, as XLA pads
  an uneven shard); ``temp_size_in_bytes`` has no counterpart on meta and
  is null.
- Collective bytes are those of the port's explicit collectives (the ep
  MoE's dispatch, combine, output gather and aux reductions, each counted
  once with one participant's operand bytes, as an HLO collective over
  every data-parallel group at once).  An auto-sharded cell has none — the collectives GSPMD would
  insert have no eager counterpart — and its ``collective_bytes`` is
  null: ``dominant`` is taken over compute and memory.

Results go one JSON per cell under ``dryrun_results_torch/`` (never the
reference's ``dryrun_results/``); a finished cell is not run again unless
``--force``.  ``--all`` counts a cell's step once for both meshes.

Usage:
  python -m repro_torch.launch.dryrun --arch glm4_9b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both [--jobs 6]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from dataclasses import replace

import torch

from .. import tree
from ..configs import ARCH_IDS, SHAPES, ShapeSpec, cells, get_config, shapes_for
from ..models.api import Model
from ..parallel.sharding import (
    NamedSharding,
    batch_specs,
    cache_shardings,
    dp_axes,
    dp_size,
    param_shardings,
    spec,
)
from ..serve.engine import cast_params
from ..train.optimizer import AdamWConfig
from ..train.step import abstract_state, make_train_step, state_shardings
from . import specs as S
from .mesh import make_production_mesh
from .roofline import Roofline, StepCounter, model_flops_for

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_results_torch")

RESULT_VERSION = 2  # bump to invalidate cached cell JSONs


def make_cell_cfg(arch: str, *, moe_impl: str | None = None,
                  attention_impl: str | None = None,
                  param_dtype: str | None = None):
    cfg = get_config(arch)
    overrides = {}
    # MoE under GSPMD: the token-sort/ragged path does not partition — use
    # the dense-einsum formulation as the auto-sharding baseline (the
    # reference's rule).
    if cfg.moe_experts:
        overrides["moe_impl"] = moe_impl or "dense"
    if attention_impl:
        overrides["attention_impl"] = attention_impl
    if param_dtype:
        overrides["param_dtype"] = param_dtype
    if overrides:
        cfg = replace(cfg, **overrides)
    return cfg.validate()


def build_cell(cfg, shape: ShapeSpec, mesh, *, accum: int = 1,
               zero_opt: bool = False, max_len: int | None = None,
               served: bool = False):
    """The cell's inputs on meta, their shardings (trees of one structure)
    and its step, a callable of no arguments.  ``max_len``: the cache's
    positions (default ``seq_len``); ``served``: the parameters in
    ``cfg.dtype``, as ``ServeEngine`` casts them, not ``cfg.param_dtype``."""
    from ..parallel import ep_moe

    ep_moe.set_mesh(mesh)
    model = Model(cfg)
    ins = S.input_specs(model, cfg, shape, max_len)

    def sharded(batch: dict, **kw) -> dict:
        b_spec = batch_specs(cfg, mesh, shape.global_batch, **kw)
        return {k: NamedSharding(mesh, b_spec[k]) for k in batch}

    if shape.kind == "train":
        opt_cfg = AdamWConfig()
        state = abstract_state(model, opt_cfg)
        train_step = make_train_step(model, opt_cfg, accum=accum)
        args = {"state": state, "batch": ins["batch"]}
        shardings = {
            "state": state_shardings(state, cfg, mesh, zero_opt=zero_opt),
            "batch": sharded(ins["batch"],
                             has_embeds="embeds" in ins["batch"],
                             encdec=cfg.enc_layers > 0)}
        return args, shardings, lambda: train_step(state, ins["batch"])
    params = model.abstract_params()
    if served:
        params = cast_params(params, cfg, torch.device("meta"))
    c_sh = cache_shardings(cfg, mesh, ins["cache"], shape.global_batch)
    if shape.kind == "prefill":
        args = {"params": params, "batch": ins["batch"],
                "cache": ins["cache"]}
        shardings = {"params": param_shardings(params, cfg, mesh),
                     "batch": sharded(ins["batch"],
                                      has_embeds="embeds" in ins["batch"]),
                     "cache": c_sh}
        return args, shardings, lambda: model.prefill(params, ins["batch"],
                                                      ins["cache"])
    tok_ok = shape.global_batch % dp_size(mesh) == 0
    args = {"params": params, "tokens": ins["tokens"], "cache": ins["cache"]}
    shardings = {"params": param_shardings(params, cfg, mesh),
                 "tokens": NamedSharding(mesh, spec(
                     dp_axes(mesh) if tok_ok else None, None)),
                 "cache": c_sh}
    return args, shardings, lambda: model.decode(params, ins["tokens"],
                                                 ins["cache"])


def shard_shape(shape, sharding: NamedSharding) -> tuple[int, ...]:
    """One device's block of a leaf: each dimension ceil-divided by the
    product of the sizes of the axes its spec entry names (XLA pads an
    uneven shard)."""
    mesh = sharding.mesh
    entries = list(sharding.spec) + [None] * (len(shape) - len(sharding.spec))
    out = []
    for dim, entry in zip(shape, entries):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        out.append(-(-dim // math.prod(mesh.shape[a] for a in axes)))
    return tuple(out)


def argument_bytes(args, shardings) -> int:
    """Per-device bytes of every tensor leaf of ``args`` under its
    sharding (host values such as the cache's ``"pos"`` hold none)."""
    total = 0
    for leaf, sh in zip(tree.leaves(args), tree.leaves(shardings)):
        if isinstance(leaf, torch.Tensor):
            total += (math.prod(shard_shape(leaf.shape, sh))
                      * leaf.element_size())
    return total


def count_step(step) -> dict:
    """FLOPs, bytes, collectives and kernel work of one run of ``step``."""
    t0 = time.time()
    with StepCounter() as c:
        step()
    return {"flops": float(c.flops), "bytes": float(c.bytes),
            "bytes_upper": float(c.bytes_upper),
            "coll_bytes_by_kind": dict(c.collectives.bytes_by_kind),
            "coll_count_by_kind": dict(c.collectives.count_by_kind),
            "kernels": c.kernels, "seconds": time.time() - t0}


def run_cell(arch: str, shape: ShapeSpec, mesh_kind: str, *,
             force: bool = False, moe_impl: str | None = None,
             attention_impl: str | None = None,
             param_dtype: str | None = None, accum: int = 1,
             zero_opt: bool = False, tag: str = "",
             results_dir: str = RESULTS_DIR, counts: dict | None = None
             ) -> dict:
    """One cell on one mesh kind, its result written to ``results_dir``.
    ``counts``: a dict shared by calls that may reuse each other's count
    of the step (it depends on the mesh only through the ep dispatch)."""
    os.makedirs(results_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(
        results_dir, f"{mesh_kind}__{arch}__{shape.name}{suffix}.json"
    )
    if os.path.exists(path) and not force:
        with open(path) as f:
            cached = json.load(f)
        if (cached.get("version") == RESULT_VERSION
                and cached.get("status") == "ok"):
            return cached

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    chips = mesh.size
    t0 = time.time()
    try:
        cfg = make_cell_cfg(arch, moe_impl=moe_impl,
                            attention_impl=attention_impl,
                            param_dtype=param_dtype)
        args, shardings, step = build_cell(cfg, shape, mesh, accum=accum,
                                           zero_opt=zero_opt)
        mem = {"argument_size_in_bytes": argument_bytes(args, shardings),
               "temp_size_in_bytes": None}
        counts = {} if counts is None else counts
        key = (cfg, shape.name, accum,
               tuple(mesh.shape.items()) if cfg.moe_impl == "ep" else None)
        if key not in counts:
            counts[key] = count_step(step)
        counted = counts[key]
        explicit = sum(counted["coll_count_by_kind"].values()) > 0
        cost = {
            "flops": counted["flops"] / chips,
            "bytes": counted["bytes"] / chips,
            "bytes_upper": counted["bytes_upper"] / chips,
            "coll_bytes_by_kind": counted["coll_bytes_by_kind"],
            "coll_count_by_kind": counted["coll_count_by_kind"],
            "coll_bytes": (float(sum(counted["coll_bytes_by_kind"].values()))
                           if explicit else None),
            "kernels": counted["kernels"],
        }
        roof = Roofline.build(
            flops=cost["flops"],
            bytes_=cost["bytes"],
            coll_bytes=cost["coll_bytes"],
            chips=chips,
            model_flops=model_flops_for(cfg, shape),
            bytes_upper=cost["bytes_upper"],
        )
        result = {
            "version": RESULT_VERSION,
            "arch": arch,
            "shape": shape.name,
            "mesh": mesh_kind,
            "status": "ok",
            "compile_seconds": time.time() - t0,
            "cost_extraction_seconds": counted["seconds"],
            "cost": cost,
            "memory_analysis": mem,
            "collectives": {
                "bytes_by_kind": cost["coll_bytes_by_kind"],
                "count_by_kind": cost["coll_count_by_kind"],
            },
            "roofline": roof.to_dict(),
            "overrides": {"moe_impl": moe_impl,
                          "attention_impl": attention_impl,
                          "param_dtype": param_dtype, "accum": accum,
                          "zero_opt": zero_opt},
        }
    except Exception as e:  # noqa: BLE001 — cell failures are data
        result = {
            "version": RESULT_VERSION,
            "arch": arch,
            "shape": shape.name,
            "mesh": mesh_kind,
            "status": "error",
            "compile_seconds": time.time() - t0,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
    with open(path + ".tmp", "w") as f:
        json.dump(result, f, indent=1)
    os.replace(path + ".tmp", path)
    return result


def _fmt_s(v) -> str:
    return "      n/a" if v is None else f"{v:9.3e}"


def print_result(r: dict) -> None:
    if r["status"] != "ok":
        print(f"[FAIL] {r['mesh']:6s} {r['arch']:22s} {r['shape']:12s} "
              f"{r['error'][:120]}")
        return
    roof = r["roofline"]
    mem = r.get("memory_analysis", {})
    print(
        f"[ ok ] {r['mesh']:6s} {r['arch']:22s} {r['shape']:12s} "
        f"compute={roof['compute_s']:9.3e}s memory={roof['memory_s']:9.3e}s "
        f"coll={_fmt_s(roof['collective_s'])}s dom={roof['dominant']:10s} "
        f"useful={roof['useful_ratio']:6.3f} "
        f"args={mem.get('argument_size_in_bytes', 0)/1e9:7.2f}GB "
        f"({r['compile_seconds']:.1f}s meta run)", flush=True
    )


def _run_cells(todo: list, meshes: list, kw: dict) -> list[dict]:
    counts: dict = {}
    return [run_cell(arch, SHAPES[shape], mesh_kind, counts=counts, **kw)
            for arch, shape in todo for mesh_kind in meshes]


def run_all(todo: list[tuple[str, str]], meshes: list[str], *,
            jobs: int = 1, **kw) -> list[dict]:
    """``run_cell`` for every (arch, shape name) of ``todo`` on every mesh
    kind, in ``jobs`` processes (a cell's meshes in one process, which
    counts its step once)."""
    if jobs <= 1:
        return _run_cells(todo, meshes, kw)
    import multiprocessing as mp

    parts = [todo[i::jobs] for i in range(jobs)]
    with mp.get_context("spawn").Pool(jobs) as pool:
        done = pool.starmap(_run_cells,
                            [(p, meshes, kw) for p in parts if p])
    by_cell = {(r["arch"], r["shape"], r["mesh"]): r
               for part in done for r in part}
    return [by_cell[(a, s, m)] for m in meshes for a, s in todo]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--moe-impl",
                    choices=["gmm", "ragged", "dense", "gathered", "ep"],
                    default=None)
    ap.add_argument("--attention-impl",
                    choices=["cuda", "blocked", "dense", "pallas"],
                    default=None)
    ap.add_argument("--param-dtype", choices=["float32", "bfloat16"],
                    default=None)
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches (train cells)")
    ap.add_argument("--zero-opt", action="store_true",
                    help="ZeRO-1: shard optimizer state over the data axis")
    ap.add_argument("--tag", default="", help="result-file suffix for variants")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes over the cells")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(a, s.name) for a, s in cells()]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        todo = [(args.arch, args.shape)]
        valid = {s.name for s in shapes_for(args.arch)}
        if args.shape not in valid:
            raise SystemExit(
                f"{args.arch} skips {args.shape} (sub-quadratic gate)"
            )

    results = run_all(
        todo, meshes, jobs=args.jobs, force=args.force,
        moe_impl=args.moe_impl, attention_impl=args.attention_impl,
        param_dtype=args.param_dtype, accum=args.accum,
        zero_opt=args.zero_opt, tag=args.tag, results_dir=args.results_dir)
    for r in results:
        print_result(r)
    raise SystemExit(1 if any(r["status"] != "ok" for r in results) else 0)


if __name__ == "__main__":
    main()
