"""Roofline terms of a step on an NVIDIA H100, counted at the aten level.

Three terms per (arch × shape × mesh), in seconds, as the JAX package's
``launch/roofline.py`` defines them:

    compute    = FLOPs / (chips × peak FLOP/s)
    memory     = HBM bytes / (chips × HBM bandwidth)
    collective = collective bytes / (chips × link bandwidth)

The JAX package reads FLOPs from XLA's cost analysis and bytes and
collectives from the compiled HLO text.  Eager PyTorch has no compiled
program, so :class:`StepCounter` counts what a step dispatches, on
``meta`` tensors (nothing is computed or allocated):

- ``flops``: matrix-class operations, as ``torch.utils.flop_counter``
  counts them;
- ``bytes``: operand and result bytes of the data-moving operations only
  (``_HBM_OPS``, the reference's list translated to aten); elementwise
  chains are left out, as the reference leaves them to fusion;
- ``bytes_upper``: every operation's bytes (views and allocations aside),
  the counterpart of XLA-CPU's "bytes accessed";
- collectives: the list collectives of :mod:`repro_torch.parallel.
  collectives`, per-device operand bytes and counts by kind under the
  reference's HLO names;
- the hand-written kernels: a wrapper given ``meta`` tensors adds its
  kernel's own work (the ``*_work`` formulas below) to the active counter
  and computes nothing.  The same formulas give ``chip_smoke.py``'s
  per-kernel bounds, so a kernel's work is counted one way whatever
  implements it.

Peaks of one H100 SXM, from NVIDIA's data sheet
(https://www.nvidia.com/en-us/data-center/h100/): dense bf16 on the tensor
cores 989 TFLOP/s, float32 without them 67 TFLOP/s, float64 34 TFLOP/s,
HBM3 3.35 TB/s, NVLink 4 900 GB/s in total.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..parallel import collectives

PEAK_FLOPS = 989e12       # dense bf16 on the tensor cores, per GPU
HBM_BW = 3.35e12          # bytes/s of HBM3 per GPU
# NVLink 4 moves 900 GB/s per GPU in total, 450 GB/s in each direction: a
# collective's operand leaves a GPU at the one-direction rate.
LINK_BW = 450e9

#: Peak rate of each dtype's arithmetic (the kernels' operations bound):
#: bf16 / f16 on the tensor cores, float32 and float64 outside them.
PEAK_FLOPS_BY_DTYPE = {torch.bfloat16: PEAK_FLOPS, torch.float16: PEAK_FLOPS,
                       torch.float32: 67e12, torch.float64: 34e12}

#: The Eq. 5 gate kernel's operations per element it decides: sub, div,
#: mul for each of the two peer means, and seven comparisons.
GATE_OPS_PER_ELEMENT = 13


@dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, int] = field(default_factory=dict)
    count_by_kind: dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1


# ---------------------------------------------------------------------------
# kernel work: FLOPs and bytes of each hand-written kernel from its shapes
# ---------------------------------------------------------------------------
def _elt(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def causal_pairs(Sq: int, Sk: int) -> int:
    """(query, key) pairs with key ``j <= i`` over ``Sq`` queries and
    ``Sk`` keys: ``Σ_i min(i + 1, Sk)``."""
    m = min(Sq, Sk)
    return m * (m + 1) // 2 + (Sq - m) * Sk


def flash_work(B, Sq, Sk, H, KV, D, dtype, causal: bool) -> dict:
    """K2: the two products over the attended pairs (causal: ``j <= i``),
    q and the output read / written once, K and V once per kv head."""
    pairs = causal_pairs(Sq, Sk) if causal else Sq * Sk
    return {"flops": 4 * B * H * D * pairs,
            "bytes": _elt(dtype) * D * (2 * B * Sq * H + 2 * B * Sk * KV),
            "dtype": dtype}


def decode_work(B, H, KV, D, valid, dtype, stats: bool = False) -> dict:
    """K3: ``valid`` cache positions of K and V read once per kv head, q
    read and the output written once; the two products over them.  The
    statistics form (``stats``) writes its output in float32 and a float32
    ``m`` and ``l`` per (batch, head) beside it."""
    out = 4 * B * H * (D + 2) if stats else _elt(dtype) * B * H * D
    return {"flops": 4 * B * H * D * valid,
            "bytes": _elt(dtype) * D * (2 * B * valid * KV + B * H) + out,
            "dtype": dtype}


def gmm_work(rows, K, N, active, dtype) -> dict:
    """K5: every routed row read once, the weights of the ``active``
    experts (those with rows) read once, every output written once;
    ``2·rows·K·N`` operations."""
    return {"flops": 2 * rows * K * N,
            "bytes": _elt(dtype) * (rows * K + active * K * N + rows * N),
            "dtype": dtype}


def ssd_work(B, S, H, G, N, Q, dtype, P=64) -> dict:
    """K4: x, B, C read once in x's dtype and dt in float32, y, the chunk
    states and seg written once in float32; the causal products C·Bᵀ and
    scores·x over ``j <= i`` and the chunk state Bᵀ·xw."""
    elt = _elt(dtype)
    Nc = S // Q
    pairs = Q * (Q + 1) // 2
    flops = B * H * Nc * (2 * pairs * N + 2 * pairs * P + 2 * Q * N * P)
    nbytes = (elt * B * S * H * P + 4 * B * S * H * P + 4 * B * S * H
              + elt * 2 * B * S * G * N + 4 * B * H * Nc * N * P
              + 4 * B * H * S)
    return {"flops": flops, "bytes": nbytes, "dtype": dtype}


def gate_work(W, R, F, live_rows, pv_sectors, count_sectors) -> dict:
    """K1, what the function needs of its inputs (float64): ``rowmask`` of
    every row (8 B), ``v`` of every live element (8 B), ``pv`` by the
    32-byte sectors holding an element that can fire and each of the two
    counts by the sectors holding such a row, the column vectors, ``W·R·F``
    int8 written; the gate operations of the live elements.  Beside it two
    earlier yardsticks: ``bytes_live_rows`` (``v`` and ``pv`` of every live
    row, 24 B of row scalars for every row) and ``bytes_all_rows`` (``v``
    and ``pv`` of every row as well), with their operations."""
    cols = 24 * W * F + 8 * F
    written = W * R * F
    return {
        "flops": live_rows * F * GATE_OPS_PER_ELEMENT,
        "bytes": (8 * W * R + 8 * F * live_rows + 32 * pv_sectors
                  + 2 * 32 * count_sectors + cols + written),
        "dtype": torch.float64,
        "bytes_live_rows": live_rows * 16 * F + W * R * 24 + cols + written,
        "bytes_all_rows": W * R * (16 * F + 24) + cols + written,
        "flops_all_rows": W * R * F * GATE_OPS_PER_ELEMENT,
    }


def bound(flops: float, nbytes: float, dtype: torch.dtype) -> dict:
    """The least time the card could take: the larger of the bytes over
    HBM bandwidth and the operations over ``dtype``'s peak rate."""
    bytes_ms = nbytes / HBM_BW * 1e3
    ops_ms = flops / PEAK_FLOPS_BY_DTYPE[dtype] * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def work_bound(work: dict) -> dict:
    """:func:`bound` of a ``*_work`` result."""
    return bound(work["flops"], work["bytes"], work["dtype"])


# ---------------------------------------------------------------------------
# counting a step on meta tensors
# ---------------------------------------------------------------------------
# Operations that stream HBM (aten names, in-place ``_`` dropped): the
# reference's dot, convolution, gather, scatter, dynamic-(update-)slice,
# reduce(-window), sort, concatenate, pad, copy, cholesky and
# triangular-solve.
_HBM_OPS = frozenset((
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
    "_scaled_mm", "convolution", "convolution_backward",
    "gather", "index", "index_select", "embedding",
    "embedding_dense_backward",
    "scatter", "scatter_add", "scatter_reduce", "index_add", "index_put",
    "_index_put_impl", "index_copy", "slice_scatter", "select_scatter",
    "sort", "topk", "argsort",
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "var", "var_mean", "std", "norm", "linalg_vector_norm", "argmax",
    "argmin", "any", "all", "cumsum", "cumprod", "_softmax",
    "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data",
    "cat", "constant_pad_nd", "copy", "_to_copy", "clone",
    "linalg_cholesky_ex", "triangular_solve", "linalg_solve_triangular",
))
# Allocations: no traffic until written.
_FREE = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                   "new_empty_strided", "detach", "lift_fresh"))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _ByteMode(TorchDispatchMode):
    def __init__(self, counter: "StepCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__.rstrip("_")
        if getattr(func, "is_view", False) or name in _FREE:
            return out
        nbytes = _nbytes((args, kwargs)) + _nbytes(out)
        self.counter.bytes_upper += nbytes
        if name in _HBM_OPS:
            self.counter.bytes += nbytes
        return out


_ACTIVE: list["StepCounter"] = []


class StepCounter:
    """FLOPs, bytes, collectives and kernel work of what runs inside the
    ``with`` block (meant for ``meta`` tensors).  ``kernels`` maps each
    kernel's name to its launches and summed ``flops`` / ``bytes``; the
    kernels' work is part of ``flops``, ``bytes`` and ``bytes_upper``."""

    def __init__(self) -> None:
        self.flops = 0
        self.bytes = 0
        self.bytes_upper = 0
        self.collectives = CollectiveStats()
        self.kernels: dict[str, dict] = {}
        self._stack: contextlib.ExitStack | None = None
        self._flop_mode = None

    def __enter__(self) -> "StepCounter":
        stack = contextlib.ExitStack()
        self._flop_mode = stack.enter_context(FlopCounterMode(display=False))
        stack.enter_context(_ByteMode(self))
        stack.enter_context(collectives.observe(self.collectives.add))
        _ACTIVE.append(self)
        stack.callback(_ACTIVE.remove, self)
        self._stack = stack
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()
        self.flops += self._flop_mode.get_total_flops()

    def add_kernel(self, name: str, work: dict) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0,
                                           "bytes": 0})
        k["launches"] += 1
        k["flops"] += work["flops"]
        k["bytes"] += work["bytes"]
        self.flops += work["flops"]
        self.bytes += work["bytes"]
        self.bytes_upper += work["bytes"]


def count_kernel(name: str, work: dict) -> None:
    """A kernel wrapper given ``meta`` tensors reports its kernel's work
    here: added to the innermost active :class:`StepCounter`, if any."""
    if _ACTIVE:
        _ACTIVE[-1].add_kernel(name, work)


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------
@dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float               # data-moving operations' bytes
    bytes_upper_bound_per_device: float   # every operation's bytes
    collective_bytes_per_device: float | None   # None: not counted
    chips: int
    compute_s: float = 0.0
    memory_s: float = 0.0
    memory_upper_s: float = 0.0
    collective_s: float | None = 0.0
    dominant: str = ""
    model_flops: float = 0.0
    useful_ratio: float = 0.0

    @staticmethod
    def build(flops: float, bytes_: float, coll_bytes: float | None,
              chips: int, model_flops: float,
              bytes_upper: float | None = None) -> "Roofline":
        """``coll_bytes=None`` where the step's collectives are not known
        (an auto-sharded cell: the collectives GSPMD would insert have no
        eager counterpart); ``dominant`` is then taken over compute and
        memory."""
        r = Roofline(
            flops_per_device=flops,
            bytes_per_device=bytes_,
            bytes_upper_bound_per_device=(
                bytes_upper if bytes_upper is not None else bytes_
            ),
            collective_bytes_per_device=coll_bytes,
            chips=chips,
            model_flops=model_flops,
        )
        r.compute_s = flops / PEAK_FLOPS
        r.memory_s = bytes_ / HBM_BW
        r.memory_upper_s = r.bytes_upper_bound_per_device / HBM_BW
        r.collective_s = None if coll_bytes is None else coll_bytes / LINK_BW
        terms = {
            "compute": r.compute_s,
            "memory": r.memory_s,
            "collective": r.collective_s,
        }
        terms = {k: v for k, v in terms.items() if v is not None}
        r.dominant = max(terms, key=terms.get)
        global_flops = flops * chips
        r.useful_ratio = model_flops / global_flops if global_flops else 0.0
        return r

    @property
    def bound_s(self) -> float:
        return max(t for t in (self.compute_s, self.memory_s,
                               self.collective_s) if t is not None)

    @property
    def roofline_fraction(self) -> float:
        """compute_term / max(all terms): 1.0 = the step is compute-bound at
        peak; lower = the dominant non-compute term caps MFU at this value."""
        b = self.bound_s
        return self.compute_s / b if b else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "bytes_upper_bound_per_device": self.bytes_upper_bound_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "memory_upper_s": self.memory_upper_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape, active_only_for_moe: bool = True) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode),
    N = active params for MoE."""
    n = cfg.param_count(active_only=active_only_for_moe and cfg.moe_experts > 0)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
