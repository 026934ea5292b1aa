"""Batched BigRoots Eq. 5 gate pipeline for fleet sweeps — the Hopper kernel.

Replaces the TPU kernel ``_gates_kernel`` of the JAX package
(``src/repro/kernels/bigroots_gates.py``, reached through ``eval_gates``).
The §III-B gate algebra — the λq quantile gate, the inter-/intra-node
peer-mean gates, the TIME significance floor and the NUMERICAL
stage-mean ≤ 0 guard — is a pure elementwise pipeline over the packed
``[W, R, F]`` batch that :func:`repro_torch.core.fleet.pack_windows`
builds; one launch returns the fired-gate bits for the whole fleet.

Inputs (see :class:`repro_torch.core.fleet.FleetGateBatch`), all float64:

==============  ===================  =========================================
``v``           ``[W, R, F]``        gate-space values of the packed rows
``peer_vsum``   ``[W, R, F]``        per-row node Σv
``inter_cnt``   ``[W, R, 1]``        ``n - count(node)`` per row
``intra_cnt``   ``[W, R, 1]``        ``count(node) - 1`` per row
``rowmask``     ``[W, R, 1]``        1.0 for real rows, 0.0 for padding
``vsum``        ``[W, 1, F]``        window running Σv
``q``           ``[W, 1, F]``        per-column λq thresholds
``numok``       ``[W, 1, F]``        NUMERICAL mean>0 guard (1.0 = pass)
``floor``       ``[1, 1, F]``        TIME floor per column (−inf elsewhere)
==============  ===================  =========================================

Output: ``gbits [W, R, F]`` int8 — 0 where no gate fired; else bit 0 set
when the inter-node observation fired and bit 1 for intra-node.

The work is bound by memory bandwidth (16 bytes read an element at most
and 1 written, no reuse), so the kernel (``csrc/bigroots_gates.cu``) is one
fused pass over window-tiled blocks: a thread owns a column pair (read as
16-byte ``double2`` loads) or, on the scalar path, one column, takes several
rows with their loads in flight together, reads ``pv`` and the counts only
where an element's output depends on them (never for a padded row), and
divides only where a quotient decides the output.  The kernel chooses the
path and the tiling from the shapes and the pointers; :func:`gate_plan`
mirrors that choice.  It is built by :mod:`repro_torch.kernels.build` at
first use.

The functions:

- :func:`eval_gates_torch` — the plain PyTorch version of the same
  function.  The CPU tests use it, and the kernel is held against it on
  the GPU; nothing on the main path calls it when the tensors are on a
  CUDA device.
- :func:`gate_plan` — the path and tiling the kernel takes for a batch
  shape (:func:`plan_for` reads the pointers' alignment off the tensors).
- :func:`gates_launch` — tensors in, int8 tensor out on the same device.
  For CUDA tensors it launches the kernel (on the current stream, without
  synchronising) or raises; it takes the plain version only for tensors
  that lie on the CPU.  ``LAUNCHES`` counts kernel launches.
- :func:`eval_gates` — the nine-array signature of the JAX package's
  wrapper: numpy arrays or tensors in, ``gbits`` back on the host as numpy.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from . import build

#: Number of times :func:`gates_launch` launched the CUDA kernel.
LAUNCHES = 0

_ARG_NAMES = ("v", "peer_vsum", "inter_cnt", "intra_cnt", "rowmask",
              "vsum", "q", "numok", "floor")

#: The tiling's constants, the same in ``csrc/bigroots_gates.cu``: a block's
#: threads at most, the column units a block spans at most (wider rows are
#: cut into chunks), and the rows a thread takes in a block (their loads in
#: flight together).
BLOCK_THREADS = 128
MAX_UNITS = 128
ROWS_PER_THREAD = 2

#: Values at the edges of float64 arithmetic, on which the kernel is held
#: against its plain version: NaN, both zeros, both infinities, subnormals
#: (``__ddiv_rn``'s slow path), the smallest normal and the largest finite.
SPECIAL_VALUES = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 5e-324,
                           -5e-324, 1e-310, -1e-310, 2.2250738585072014e-308,
                           1.7976931348623157e308, -1.7976931348623157e308])

_fn = None


class GatePlan(NamedTuple):
    """How the kernel covers a ``[W, R, F]`` batch.

    ``path`` is ``"vector"`` (a thread owns a column pair, 16-byte loads) or
    ``"scalar"`` (one column, 8-byte loads).  A block has ``threads =
    rows_per_pass * units`` threads: ``units`` consecutive column units of
    ``rows_per_pass`` consecutive rows.  A row's units are cut into
    ``chunks`` of ``units``, a window's rows into ``tiles`` of
    ``rows_per_pass * ROWS_PER_THREAD``, and the grid is ``W * tiles *
    chunks`` blocks."""

    path: str
    threads: int
    rows_per_pass: int
    units: int
    chunks: int
    tiles: int
    grid: int


def gate_plan(W: int, R: int, F: int, aligned: bool) -> GatePlan:
    """The plan ``bigroots_gates_f64`` derives for a ``[W, R, F]`` batch
    (the same arithmetic, for the tests and for reports).  The vector path
    needs an even ``F`` and ``aligned`` pointers (``v`` and ``pv`` on 16
    bytes, the output on 2); anything else takes the scalar path."""
    path = "vector" if aligned and F % 2 == 0 else "scalar"
    per_row = F // 2 if path == "vector" else F
    units = min(per_row, MAX_UNITS)
    chunks = -(-per_row // units)
    rows_per_pass = BLOCK_THREADS // units
    tiles = -(-R // (rows_per_pass * ROWS_PER_THREAD))
    return GatePlan(path, rows_per_pass * units, rows_per_pass, units,
                    chunks, tiles, W * tiles * chunks)


def plan_for(v: torch.Tensor, peer_vsum: torch.Tensor,
             out: torch.Tensor) -> GatePlan:
    """:func:`gate_plan` for these tensors, their alignment read off their
    data pointers (a view at an odd element offset is not aligned)."""
    W, R, F = v.shape
    aligned = (v.data_ptr() % 16 == 0 and peer_vsum.data_ptr() % 16 == 0
               and out.data_ptr() % 2 == 0)
    return gate_plan(W, R, F, aligned)


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("bigroots_gates").bigroots_gates_f64
        fn.argtypes = (
            [ctypes.c_void_p] * 10
            + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double]
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def eval_gates_torch(v, peer_vsum, inter_cnt, intra_cnt, rowmask, vsum, q,
                     numok, floor, *, peer_mean: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same operand order, float64).

    Each op rounds once (eager torch fuses nothing), comparisons with NaN
    are false and division by a zero count yields inf/NaN masked by the
    ``cnt > 0`` terms — bit-for-bit the numpy oracle's arithmetic."""
    inter = (vsum - peer_vsum) / inter_cnt
    intra = (peer_vsum - v) / intra_cnt
    gate_inter = (v > inter * peer_mean) & (inter_cnt > 0.0)
    gate_intra = (v > intra * peer_mean) & (intra_cnt > 0.0)
    fired = (
        (rowmask > 0.0) & (v > q) & (gate_inter | gate_intra)
        & (numok > 0.0) & (v > floor)
    )
    gbits = gate_inter.to(torch.int8) + 2 * gate_intra.to(torch.int8)
    return torch.where(fired, gbits, torch.zeros_like(gbits))


def _check(args: tuple) -> tuple[int, int, int]:
    """Raise on anything the kernel does not take."""
    v = args[0]
    if v.dim() != 3:
        raise ValueError(f"v must be [W, R, F], got shape {tuple(v.shape)}")
    W, R, F = v.shape
    want = ((W, R, F), (W, R, F), (W, R, 1), (W, R, 1), (W, R, 1),
            (W, 1, F), (W, 1, F), (W, 1, F), (1, 1, F))
    for name, t, shape in zip(_ARG_NAMES, args, want):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must have shape {shape}, got {tuple(t.shape)}"
            )
        if t.device != v.device:
            raise ValueError(
                f"{name} is on {t.device}, v is on {v.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return W, R, F


def gates_launch(v, peer_vsum, inter_cnt, intra_cnt, rowmask, vsum, q, numok,
                 floor, *, peer_mean: float,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Evaluate the gate pipeline on the tensors' own device.

    CUDA tensors go through the hand-written kernel on the current stream
    (no synchronisation; the output is allocated with ``torch.empty`` unless
    a reusable int8 ``[W, R, F]`` tensor is passed as ``out``), on the path
    :func:`plan_for` names; CPU tensors through :func:`eval_gates_torch`."""
    global LAUNCHES
    args = (v, peer_vsum, inter_cnt, intra_cnt, rowmask, vsum, q, numok,
            floor)
    W, R, F = _check(args)
    if v.device.type == "cpu":
        return eval_gates_torch(*args, peer_mean=float(peer_mean))
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    if W * R * F >= 2 ** 31:
        raise ValueError(
            f"batch of {W * R * F} elements: the kernel indexes with 32 bits"
        )
    if out is None:
        out = torch.empty((W, R, F), dtype=torch.int8, device=v.device)
    elif (out.dtype != torch.int8 or tuple(out.shape) != (W, R, F)
          or out.device != v.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous int8 [W, R, F] tensor "
                         "on the inputs' device")
    fn = _kernel_fn()
    with torch.cuda.device(v.device):
        rc = fn(*(t.data_ptr() for t in args), out.data_ptr(), W, R, F,
                float(peer_mean), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"bigroots_gates_f64 launch failed: CUDA error {rc}"
        )
    LAUNCHES += 1
    return out


def eval_gates(
    v, peer_vsum, inter_cnt, intra_cnt, rowmask, vsum, q, numok, floor, *,
    peer_mean: float, device=None,
) -> np.ndarray:
    """Evaluate the Eq. 5 gate pipeline for a packed fleet batch.

    Takes numpy arrays (moved to ``device``, resolved by
    :func:`repro_torch.device.resolve_device`: the GPU unless the caller
    names the CPU) or tensors (used where they lie), and returns ``gbits``
    as a numpy int8 array on the host.  No row re-padding happens here: the
    kernel masks its own ragged tail."""
    args = (v, peer_vsum, inter_cnt, intra_cnt, rowmask, vsum, q, numok,
            floor)
    if not all(isinstance(a, torch.Tensor) for a in args):
        dev = resolve_device(device)
        args = tuple(
            a.to(dev) if isinstance(a, torch.Tensor)
            else torch.from_numpy(a).to(dev)
            for a in args
        )
    return gates_launch(*args, peer_mean=peer_mean).cpu().numpy()
