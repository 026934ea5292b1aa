"""Work a call needs, counted from its shapes, and the card's peaks.

Copies of the port's ``launch/roofline.py`` arithmetic (``flash_work``,
``gmm_work``, ``model_flops_for`` and the parameter count it reads), taken
as they stood when the benchmark was defined.  They read plain numbers and
a configuration dict, never the program's objects.

Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet: 989 TFLOP/s dense
bf16 on the tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

import math

PEAK_FLOPS = 989e12     # dense bf16 / fp16 on the tensor cores, per GPU
HBM_BW = 3.35e12        # bytes/s of HBM3 per GPU
BF16_BYTES = 2


def causal_pairs(sq: int, sk: int) -> int:
    """(query, key) pairs with key ``j <= i``: ``sum_i min(i + 1, sk)``."""
    m = min(sq, sk)
    return m * (m + 1) // 2 + (sq - m) * sk


def flash_work(b: int, sq: int, sk: int, h: int, kv: int, d: int,
               causal: bool, elt: int = BF16_BYTES) -> dict:
    """Attention: the two products over the attended pairs; q and the
    output read / written once, K and V once per kv head."""
    pairs = causal_pairs(sq, sk) if causal else sq * sk
    return {"flops": 4 * b * h * d * pairs,
            "bytes": elt * d * (2 * b * sq * h + 2 * b * sk * kv)}


def gmm_work(rows: int, k: int, n: int, active: int,
             elt: int = BF16_BYTES) -> dict:
    """One grouped product: every routed row read once, the weights of the
    ``active`` experts read once, every output written once."""
    return {"flops": 2 * rows * k * n,
            "bytes": elt * (rows * k + active * k * n + rows * n)}


def moe_ffn_work(rows: int, d: int, f: int, active: int) -> dict:
    """An expert FFN over ``rows`` sorted rows: gate and up ``d -> f``, down
    ``f -> d``, each one grouped product."""
    parts = (gmm_work(rows, d, f, active), gmm_work(rows, d, f, active),
             gmm_work(rows, f, d, active))
    return {"flops": sum(p["flops"] for p in parts),
            "bytes": sum(p["bytes"] for p in parts)}


def bound_s(work: dict) -> float:
    """The least time the card could take for ``work`` (bf16): the larger
    of operations over the peak rate and bytes over HBM bandwidth."""
    return max(work["flops"] / PEAK_FLOPS, work["bytes"] / HBM_BW)


# -- model FLOPs -------------------------------------------------------------

def pattern(m: dict) -> list[tuple[str, str | None]]:
    """The repeating (mixer, ffn) slots of a decoder-only configuration."""
    if m["family"] == "ssm":
        return [("ssm", None)]
    period = 1
    if m.get("attn_period"):
        period = math.lcm(period, m["attn_period"])
    if m.get("moe_experts") and m.get("moe_period", 1) > 1:
        period = math.lcm(period, m["moe_period"])
    slots = []
    for i in range(period):
        mixer = "attn"
        if m.get("attn_period"):
            mixer = "attn" if i % m["attn_period"] == m["attn_offset"] \
                else "ssm"
        moe = m.get("moe_experts") and \
            i % m.get("moe_period", 1) == m.get("moe_offset", 0) % m.get(
                "moe_period", 1)
        slots.append((mixer, "moe" if moe else "mlp"))
    return slots


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def param_count(m: dict, active_only: bool = False) -> int:
    """Parameters (or those active per token), embeddings included."""
    d, ff = m["d_model"], m.get("d_ff", 0)
    hd = head_dim(m) if m.get("n_heads") else 0
    n = m["vocab"] * d * (1 if m.get("tie_embeddings") else 2)
    e_ff = m.get("moe_d_ff") or ff
    di = m.get("ssm_expand", 2) * d
    groups, state = m.get("ssm_groups", 1), m.get("ssm_state", 0)
    ssm_heads = di // m.get("ssm_head_dim", 64)
    conv_dim = di + 2 * groups * state
    in_proj = 2 * di + 2 * groups * state + ssm_heads
    attn = (d * m.get("n_heads", 0) * hd + 2 * d * m.get("n_kv_heads", 0) * hd
            + m.get("n_heads", 0) * hd * d + d)
    mlp = 3 * d * ff + d
    experts = m.get("moe_top_k", 0) if active_only else m.get("moe_experts", 0)
    moe = d * m.get("moe_experts", 0) + experts * 3 * d * e_ff + d
    ssm = (d * in_proj + conv_dim * m.get("ssm_conv", 4) + conv_dim
           + 3 * ssm_heads + di * d + di + d)
    slots = pattern(m)
    blocks = m["n_layers"] // len(slots)
    for mixer, ffn in slots:
        n += blocks * (attn if mixer == "attn" else ssm)
        if ffn == "mlp":
            n += blocks * mlp
        elif ffn == "moe":
            n += blocks * moe
    return n + d


def active_params(m: dict) -> int:
    return param_count(m, active_only=bool(m.get("moe_experts")))


def train_flops(m: dict, tokens: int) -> float:
    """6 N D, N the active parameters."""
    return 6.0 * active_params(m) * tokens


def serve_flops(m: dict, tokens: int) -> float:
    """2 N D over prompt and generated tokens."""
    return 2.0 * active_params(m) * tokens
