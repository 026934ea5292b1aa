"""Cells at widths a host runs in seconds: every width of the cell's
configuration cut, its traffic shrunk, the program on the CPU in float32
(where each kernel's plain version runs).  A configuration gives its own
cut widths under ``"smoke": {"train": {...}, "serve": {...}}``; without
them a driver's default below holds."""
from __future__ import annotations

import copy

import torch

from portbench.harness import common
from portbench.harness.serve import ServeCell
from portbench.harness.train import TrainCell

CPU = torch.device("cpu")
TRAIN_MODEL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   head_dim=16, d_ff=32, moe_experts=4, moe_top_k=2,
                   moe_d_ff=32, vocab=4096, dtype="float32")
SERVE_MODEL = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=16,
                   d_ff=32, moe_experts=4, moe_top_k=2, moe_d_ff=32,
                   vocab=4096, ssm_head_dim=8, ssm_chunk=8, dtype="float32")
SMOKE = {"train": TRAIN_MODEL, "serve": SERVE_MODEL}


def cell(name: str) -> dict:
    return shrink(copy.deepcopy(common.cell(name)))


def shrink(c: dict) -> dict:
    """Cell ``c`` with its traffic shrunk, in place."""
    wl = c["workload"]
    if wl["driver"] == "train":
        wl.update(batch=2, seq=16, window_steps=4, max_stages=2,
                  first_step=8)
    else:
        wl.update(clients=2, new_tokens=4,
                  prompt_lengths=[16, 32, 24][:len(wl["prompt_lengths"])])
        wl["check"].update(sample_requests=3, ref_batch=2)
        wl["limits"]["tokens_compared"] = 3 * (wl["new_tokens"] + 1)
    return c


def widths(c: dict) -> dict:
    """The cut widths of cell ``c``'s configuration for its driver."""
    driver = c["workload"]["driver"]
    return c["config"].get("smoke", {}).get(driver, SMOKE[driver])


def run(name: str, seed: int, fault: str | None = None,
        seconds: float | None = None):
    """One run of ``name`` on the host: ``(result numbers, checks, run)``."""
    c = cell(name)
    if seconds is None:
        seconds = 1.5 if c["workload"]["driver"] == "train" else 3.0
    drive = TrainCell if c["workload"]["driver"] == "train" else ServeCell
    r = drive(c, seed, CPU, model=widths(c), fault=fault)
    r.setup()
    w = r.window(seconds)
    e2e = r.end_to_end(w)
    r.close()
    r.free()
    return {"window": w, "end_to_end": e2e}, r.check(), r
