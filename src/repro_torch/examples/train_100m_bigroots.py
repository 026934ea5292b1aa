"""End-to-end run: train a model with BigRoots telemetry + live anomaly
injection + offline root-cause analysis + mitigation plan.

Default is CPU-sized (reduced granite-family config, 200 steps, a real CPU
anomaly generator firing mid-run).  ``--preset 100m`` trains a true ~100M-
parameter model (the config is the point).

    PYTHONPATH=src python -m repro_torch.examples.train_100m_bigroots [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_100m_bigroots --preset 100m --steps 5
"""
from __future__ import annotations

import argparse
import json
import tempfile
from dataclasses import replace

from ..configs import get_config
from ..launch import train as lt


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["smoke", "100m"], default="smoke")
    ap.add_argument("--steps", type=int, default=None)
    outer, rest = ap.parse_known_args(argv)

    args = lt.build_argparser().parse_args(rest or [])
    args.arch = "granite_8b"
    original_get = lt.get_config
    if outer.preset == "100m":
        # true ~100M-parameter decoder (12L, d=768): N ≈ 2·32k·768 +
        # 12·(4·768² + 3·768·2048) ≈ 0.13B params
        base = get_config("granite_8b")
        cfg_100m = replace(
            base, name="granite-100m", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=4, d_ff=2048, vocab=32768, dtype="float32",
            attention_impl="dense", remat=False,
        )
        lt.get_config = lambda a: cfg_100m  # inject the preset
        args.smoke = False
        args.steps = outer.steps or 20
        args.batch, args.seq = 2, 128
    else:
        args.smoke = True
        args.steps = outer.steps or 200
        args.batch, args.seq = 4, 64

    args.anomaly = "cpu"
    args.anomaly_at = args.steps // 3
    args.anomaly_steps = max(args.steps // 6, 3)
    args.anomaly_workers = 2
    args.window = 16
    args.ckpt_dir = tempfile.mkdtemp(prefix="repro_e2e_ckpt_")
    args.ckpt_every = max(args.steps // 4, 5)
    args.async_ckpt = True

    try:
        out = lt.run(args)
    finally:
        lt.get_config = original_get
    print(out["report"])
    print(json.dumps({k: v for k, v in out.items() if k != "report"},
                     indent=2, default=str))
    assert out["loss_decreased"], "training should reduce the loss"
    print("OK: loss decreased and telemetry → analysis pipeline ran end-to-end")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
