"""Work a call needs, counted from its shapes, and the card's peaks.

Copies of the port's ``launch/roofline.py`` arithmetic (``flash_work``,
``gmm_work``, ``model_flops_for``), taken as they stood when the
benchmark was defined.  They read plain numbers, never the program's
objects.  The parameter count the model FLOPs read is the
configuration's reference's (``param_count``), since it depends on the
architecture.

Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet: 989 TFLOP/s dense
bf16 on the tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

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

def active_params(ref, m: dict) -> int:
    """Parameters active per token, by the reference ``ref``'s count."""
    return ref.param_count(m, active_only=bool(m.get("moe_experts")))


def train_flops(active: int, tokens: int) -> float:
    """6 N D, N the active parameters."""
    return 6.0 * active * tokens


def serve_flops(active: int, tokens: int) -> float:
    """2 N D over prompt and generated tokens."""
    return 2.0 * active * tokens
