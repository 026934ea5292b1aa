"""Serving entry point: batched requests through prefill + decode with telemetry.

On the GPU (the default device), any decoder-only arch at full size —
dense (glm4_9b, codeqwen1_5_7b, granite_8b, granite_3_8b), MoE
(granite_moe_1b_a400m, olmoe_1b_7b), SSM (mamba2_130m):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4_9b
The hybrid and the VLM backbone fit one H100 cut to whole layer periods
(jamba_v0_1_52b: 8 of 32 layers; internvl2_26b: text prompts only, the
engine takes no patch embeddings):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba_v0_1_52b --layers 8
CPU-sized example (the smoke variant, on the host):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_130m \\
      --smoke --device cpu --requests 8 --max-new 16
Full width cut to fewer layers (the kernels' shapes, a smaller model):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4_9b --layers 2
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace

import numpy as np
import torch

from ..configs import get_config
from ..core import BigRootsAnalyzer, JAX_FEATURES, render_markdown, summarize
from ..device import resolve_device
from ..models import Model, smoke_variant
from ..serve import Diagnosis
from ..serve.engine import Request, ServeEngine, cast_params
from ..telemetry.events import StepTelemetry
from ..telemetry.sampler import SystemSampler
from ..telemetry.timeline import ResourceTimeline


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="glm4_9b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep only this many layers (a multiple of the "
                         "arch's layer pattern), at the config's width")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions on the host)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.layers:
        cfg = replace(cfg, n_layers=args.layers).validate()
    if cfg.enc_layers:
        raise SystemExit("the serving entry point takes decoder-only archs")
    model = Model(cfg)
    # Seeded float32 parameters, each leaf cast to the served dtype as it
    # goes: the float32 tree beside the engine's copy would not fit one card
    # for the largest cut (jamba_v0_1_52b --layers 8, 13.3 B parameters).
    params = cast_params(
        model.init(torch.Generator(device=device).manual_seed(args.seed)),
        cfg, device, in_place=True)

    timeline = ResourceTimeline()
    telem = StepTelemetry("host0", timeline=timeline, window=64,
                          streaming=True)
    rng = np.random.default_rng(args.seed)
    requests = [
        Request(
            request_id=f"r{i}",
            prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new,
        )
        for i in range(args.requests)
    ]

    engine = ServeEngine(
        model, params,
        max_len=args.prompt_len + args.max_new + 8,
        batch_size=args.batch_size,
        temperature=args.temperature,
        telemetry=telem,
        diagnosis=Diagnosis.local(
            BigRootsAnalyzer(JAX_FEATURES, timelines=timeline, device=device)
        ),
        device=device,
    )
    del params  # the engine holds the same tensors
    with SystemSampler("host0", timeline, interval=0.25):
        t0 = time.time()
        done = 0
        for i in range(0, len(requests), args.batch_size):
            batch = requests[i : i + args.batch_size]
            engine.run(batch, step_offset=i * args.max_new)
            done += len(batch)
        wall = time.time() - t0

    analyzer = BigRootsAnalyzer(JAX_FEATURES, timelines=timeline,
                                device=device)
    summary = summarize(analyzer.analyze(telem.trace))
    toks = sum(len(r.output) for r in requests)
    print(render_markdown(summary, title=f"BigRoots serve report — {cfg.name}"))
    print(json.dumps({
        "arch": cfg.name,
        "requests": done,
        "generated_tokens": toks,
        "wall_seconds": wall,
        "tokens_per_second": toks / wall if wall else 0.0,
        "prefill_seconds_last_batch": engine.last_prefill_seconds,
        "stragglers": summary.num_stragglers,
        "live_root_causes": [
            {"task": c.task_id, "feature": c.feature, "value": c.value}
            for c in engine.live_root_causes
        ],
    }, indent=2))


if __name__ == "__main__":
    main()
