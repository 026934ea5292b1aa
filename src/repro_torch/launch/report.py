"""Render the dry run's tables (matrix and roofline) from
``dryrun_results_torch/``.

    PYTHONPATH=src python -m repro_torch.launch.report            # markdown tables
    PYTHONPATH=src python -m repro_torch.launch.report --variants # incl. tag variants

The roofline is the H100's (:mod:`repro_torch.launch.roofline`).  The
collective column is one participant's sharded program, counted on meta
(:mod:`repro_torch.launch.dryrun`): an MoE cell's through the sharded
``"gmm"`` MoE, whose routed row count on meta is each participant's even
share of the slots; an ``ep`` cell's through the sharded ep MoE.  Every
cell of the production meshes is counted; a cell the sharded layers
refuse prints the refusal's short form where its bytes would be, and its
collective term as "n/a".  The collective term is over one NVLink 4 GPU's rate
(``LINK_BW``), on meshes far larger than one NVLink domain.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_results_torch")


def load(variants: bool = False, results_dir: str = RESULTS_DIR) -> list[dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        name = os.path.basename(p)[:-5]
        parts = name.split("__")
        is_variant = len(parts) > 3
        if is_variant and not variants:
            continue
        with open(p) as f:
            r = json.load(f)
        r["_tag"] = parts[3] if is_variant else ""
        out.append(r)
    return out


def fmt_bytes(b: float | None) -> str:
    if b is None:
        return "n/a"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def fmt_s(v: float | None) -> str:
    return "n/a" if v is None else f"{v:.3e}"


def skipped_note(r: dict) -> str:
    """A short form of why a cell's collectives were not counted."""
    why = r.get("collectives", {}).get("skipped") or ""
    return f"n/a: {why[:40]}" if why else "n/a"


def dryrun_table(rows: list[dict]) -> str:
    lines = [
        "| mesh | arch | shape | status | args/dev | temp/dev | "
        "collective ops (per-device bytes) | meta run |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["status"] != "ok":
            lines.append(
                f"| {r['mesh']} | {r['arch']} | {r['shape']} | FAIL: "
                f"{r.get('error', '?')[:60]} | | | | |"
            )
            continue
        mem = r.get("memory_analysis", {})
        coll = r.get("collectives", {}).get("bytes_by_kind", {})
        if r["roofline"]["collective_bytes_per_device"] is None:
            coll_s = skipped_note(r)
        else:
            coll_s = ", ".join(
                f"{k}={fmt_bytes(v)}" for k, v in sorted(coll.items()) if v
            ) or "none"
        tag = f" ({r['_tag']})" if r.get("_tag") else ""
        lines.append(
            f"| {r['mesh']} | {r['arch']}{tag} | {r['shape']} | ok | "
            f"{fmt_bytes(mem.get('argument_size_in_bytes', 0))} | "
            f"{fmt_bytes(mem.get('temp_size_in_bytes'))} | {coll_s} | "
            f"{r.get('compile_seconds', 0):.1f}s |"
        )
    return "\n".join(lines)


def roofline_table(rows: list[dict], mesh: str = "single") -> str:
    lines = [
        "| arch | shape | compute (s) | memory (s) | collective (s) | "
        "dominant | roofline frac | MODEL/counted flops | one-line bottleneck note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["status"] != "ok" or r["mesh"] != mesh:
            continue
        roof = r["roofline"]
        note = bottleneck_note(r)
        tag = f" ({r['_tag']})" if r.get("_tag") else ""
        lines.append(
            f"| {r['arch']}{tag} | {r['shape']} | {roof['compute_s']:.3e} | "
            f"{roof['memory_s']:.3e} | {fmt_s(roof['collective_s'])} | "
            f"{roof['dominant']} | {roof.get('roofline_fraction', 0):.3f} | "
            f"{roof['useful_ratio']:.3f} | {note} |"
        )
    return "\n".join(lines)


def bottleneck_note(r: dict) -> str:
    roof = r["roofline"]
    dom = roof["dominant"]
    coll = r.get("collectives", {}).get("bytes_by_kind", {})
    big_coll = max(coll.items(), key=lambda kv: kv[1])[0] if coll else "none"
    shape = r["shape"]
    if dom == "collective":
        return f"dominated by {big_coll}; re-shard to cut its payload"
    if dom == "memory":
        if "decode" in shape or "500k" in shape:
            return "weight/KV streaming bound; cast serve params to bf16, shard cache"
        if roof["useful_ratio"] < 0.3:
            return "non-useful compute streams bytes (dense-MoE/remat); fix impl first"
        return "activation+weight traffic; raise arithmetic intensity (fusion/remat policy)"
    return "compute-bound: already at the tensor-core roofline knee"


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    rows = load(variants=args.variants, results_dir=args.results_dir)
    print("### Dry-run matrix\n")
    print(dryrun_table(rows))
    print(f"\n### Roofline ({args.mesh}-pod)\n")
    print(roofline_table(rows, mesh=args.mesh))


if __name__ == "__main__":
    main()
