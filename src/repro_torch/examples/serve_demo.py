"""Batched serving demo: prefill + decode a reduced GLM4 with 8 requests,
with serve-side BigRoots telemetry.

On the GPU the reduction keeps glm4-9b's width and cuts it to two layers,
so that the prefill runs the flash-attention kernel and every decode step
the decode-attention kernel (the smoke variant's 16-wide heads are below
the kernels' 64); on the CPU (``--device cpu``) it is the reference's smoke
variant.

    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]
"""
from __future__ import annotations

import argparse

from ..device import resolve_device
from ..launch import serve


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    device = resolve_device(ap.parse_args(argv).device)
    reduced = ["--smoke"] if device.type == "cpu" else ["--layers", "2"]
    serve.main(["--arch", "glm4_9b", *reduced, "--requests", "8",
                "--prompt-len", "12", "--max-new", "8",
                "--device", str(device)])
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
