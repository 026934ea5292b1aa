"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--control] [--fault half_batch] [--fault-only] [--seconds 8]

For each seed: the compared numbers of a sound run (a training cell's
set-up steps; a serving cell's short window at the cell's load), and
with ``--control`` the same numbers for the control, the plain reference
computed with float8 (e4m3, one scale a tensor) products in the program's
place (training: its own routing, which the reference's routed step 1
then follows); with ``--fault`` those of the program with that fault
planted.  One JSON line a seed and reading.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import common  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--witness", action="store_true",
                    help="also read the reference in bf16 products and the "
                         "program computing in float32")
    ap.add_argument("--fault-only", action="store_true",
                    help="read the fault alone, not the sound run beside it")
    args = ap.parse_args()
    common.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = common.cell(args.workload)
    kind = cell["workload"]["driver"]
    for seed in args.seeds:
        readings = [] if args.fault_only else ["sound"]
        for what in readings + (["fault"] if args.fault else []):
            t = time.perf_counter()
            torch.backends.cuda.matmul.allow_tf32 = True
            if kind == "train":
                from portbench.harness.train import (
                    TrainCell,
                    numbers,
                    routed_numbers,
                )

                run = TrainCell(cell, seed, device,
                                fault=args.fault if what == "fault" else None)
                run.setup()
                run.close()
                run.free()
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
                ref = run.reference()

                def read(got):
                    out = numbers(got, ref)
                    routed = run.routed_step(got.get("routes"))
                    out.update(routed_numbers(got, routed))
                    del routed
                    return out

                line = {"seed": seed, "reading": what, **read(run.records),
                        "losses": run.records["losses"],
                        "ref_losses": ref["losses"]}
                if args.control and what == "sound":
                    run.records = None
                    line["control"] = read(run.reference(mm=run.ref.mm_fp8))
                if args.witness and what == "sound":
                    line["reference_bf16"] = read(
                        run.reference(mm=run.ref.mm_bf16))
                    f32 = TrainCell(cell, seed, device,
                                    port_over={"dtype": "float32"})
                    f32.setup()
                    f32.close()
                    f32.free()
                    line["program_f32"] = read(f32.records)
                    del f32
                del ref
            else:
                from portbench.harness.serve import ServeCell

                run = ServeCell(cell, seed, device,
                                fault=args.fault if what == "fault" else None)
                run.setup()
                w = run.window(args.seconds)
                run.close()
                run.free()
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
                line = {"seed": seed, "reading": what,
                        "attempted": w["attempted"], **run.gaps()}
                if args.control and what == "sound":
                    line["control"] = run.gaps(control=run.ref.mm_fp8)
                run.batches.clear()
            line["seconds"] = time.perf_counter() - t
            print(json.dumps(line), flush=True)
            del run
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
