"""Ragged grouped matrix product over expert-sorted rows — the Hopper kernel.

Replaces the TPU kernel ``_gmm_kernel`` of the JAX package
(``src/repro/kernels/moe_gmm.py``, reached through ``grouped_matmul`` and
``ops.moe_gmm_ffn``).  Every MoE layer runs it three times (gate, up, down)
in the prefill and in every decode step when ``ModelConfig.moe_impl ==
"gmm"``.

Layout: ``xs [M, K]`` holds the routed rows sorted by expert,
``group_sizes [E]`` (integers on xs's device) how many rows each expert
has, ``w [E, K, N]`` the experts' weights → ``[M, N]`` in xs's dtype, row
``r`` of expert ``e`` times ``w[e]``, accumulated in float32.  The
reference's padded ``[E, Cap, K]`` signature is the special case of ``E``
groups of ``Cap`` rows; unlike its wrapper nothing is padded or dropped.

- :func:`grouped_matmul_torch` — the plain PyTorch version: one float32
  ``torch.matmul`` per expert (it reads the group sizes on the host).  The
  CPU tests use it, and the kernel is held against it on the GPU.
- :func:`grouped_matmul` — CUDA tensors launch the kernel
  (``csrc/moe_gmm.cu``: wgmma + TMA for bfloat16, scalar FMAs for float32)
  on the current stream or raise; the kernel reads the group sizes from
  device memory, so the host never waits on them.  The bfloat16 kernel's
  output tile is :func:`tile_rows` rows high, chosen from ``M`` and ``E``
  alone, and its inputs must suit a TMA tensor map (:mod:`.tma`).  CPU
  tensors take the plain version.  ``LAUNCHES`` counts kernel launches.
  Its gradient is the plain version's, by autograd (:mod:`.grad`).
  ``meta`` tensors (the dry run) take the kernel's checks, then an empty
  output, and its work (:func:`repro_torch.launch.roofline.gmm_work`) goes
  to the active step counter.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .flash_attention import DTYPES
from .grad import PlainGradient
from .tma import check_tma

#: Number of times :func:`grouped_matmul` launched the CUDA kernel.
LAUNCHES = 0

#: Experts the CUDA kernel takes (its ``MAX_EXPERTS``: one shared int each).
MAX_EXPERTS = 1024
#: Output tile heights of the bfloat16 kernel (``TILE_ROWS_SMALL`` and
#: ``TILE_ROWS_LARGE`` in the source): one consumer warpgroup of 64 rows,
#: or two.
TILE_ROWS = (64, 128)

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("moe_gmm").moe_gmm_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def tile_rows(M: int, E: int) -> int:
    """The bfloat16 kernel's tile height for ``M`` routed rows over ``E``
    experts, known on the host without reading the group sizes: 64 where
    the mean group is under 64 rows (a decode step: 64 rows over ~27
    experts, where a 128-row tile would be mostly empty), else 128."""
    return TILE_ROWS[0] if M < TILE_ROWS[0] * E else TILE_ROWS[1]


def row_tiles(M: int, E: int, bm: int) -> int:
    """Row tiles the kernel provides for without reading the group sizes
    (the float32 body's grid; the bf16 body's bound on work items per
    column tile): ``ceil(M / bm) + E``, an upper bound on
    ``sum(ceil(n_e / bm))`` for any group sizes ``n_e`` summing to ``M``,
    since each group adds at most one partial tile."""
    return -(-M // bm) + E


def grouped_matmul_torch(xs, w, group_sizes) -> torch.Tensor:
    """Plain PyTorch version: ``xs[rows of e] @ w[e]`` in float32 for every
    expert ``e``, cast to xs's dtype.  On ``meta`` tensors, where the group
    sizes cannot be read, one product of every row with one expert's
    weights stands in: the same shapes and the same operation count, and
    so the same count under autograd (the dry run's backward)."""
    if xs.device.type == "meta":
        return (xs.float() @ w[0].float()).to(xs.dtype)
    sizes = [int(n) for n in group_sizes.tolist()]
    if sum(sizes) != xs.shape[0] or min(sizes, default=0) < 0:
        raise ValueError(f"group sizes {sizes} do not split {xs.shape[0]} "
                         "rows")
    out = torch.empty((xs.shape[0], w.shape[2]), dtype=xs.dtype,
                      device=xs.device)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            out[start:start + n] = (xs[start:start + n].float()
                                    @ w[e].float()).to(xs.dtype)
        start += n
    return out


def _check(xs, w, group_sizes) -> None:
    if xs.dim() != 2 or w.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError("xs must be [M, K], w [E, K, N], group_sizes [E]")
    if w.shape[1] != xs.shape[1] or w.shape[0] != group_sizes.shape[0]:
        raise ValueError(f"w {tuple(w.shape)} does not fit xs "
                         f"{tuple(xs.shape)} and {group_sizes.shape[0]} "
                         "groups")
    if xs.dtype != w.dtype:
        raise TypeError(f"dtypes differ: {xs.dtype}, {w.dtype}")
    if group_sizes.dtype.is_floating_point:
        raise TypeError("group_sizes must be integers")
    if not (xs.device == w.device == group_sizes.device):
        raise ValueError("xs, w, group_sizes lie on different devices")


def check_kernel_inputs(xs, w) -> None:
    """What the CUDA kernel takes beyond :func:`_check`: float32 or
    bfloat16, contiguous xs and w, at most ``MAX_EXPERTS`` experts, and for
    bfloat16 a layout TMA can describe (K and N multiples of 8, bases on 16
    bytes).  Raises; never copies."""
    if xs.dtype not in DTYPES:
        raise TypeError(f"dtype {xs.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if not (xs.is_contiguous() and w.is_contiguous()):
        raise ValueError("xs and w must be contiguous")
    if xs.dtype == torch.bfloat16:
        check_tma(xs, "xs")
        check_tma(w, "w")
    if w.shape[0] > MAX_EXPERTS:
        raise ValueError(f"{w.shape[0]} experts: the kernel takes at most "
                         f"{MAX_EXPERTS}")


def grouped_matmul(xs, w, group_sizes, *,
                   rows_per_tile: int | None = None) -> torch.Tensor:
    """The grouped product on the tensors' own device: the hand-written
    kernel for CUDA tensors (no synchronisation, no host read of
    ``group_sizes``), the plain version for CPU tensors.
    ``rows_per_tile`` (64 or 128) overrides :func:`tile_rows` for the
    bfloat16 kernel; it changes how the work is cut, not the result.
    Differentiable in ``xs`` and ``w``: the gradient is the plain
    version's (:class:`~repro_torch.kernels.grad.PlainGradient`)."""
    _check(xs, w, group_sizes)
    if rows_per_tile is not None and rows_per_tile not in TILE_ROWS:
        raise ValueError(f"rows_per_tile {rows_per_tile}: the kernel takes "
                         f"{TILE_ROWS}")
    if xs.device.type == "cpu":
        return PlainGradient.apply(grouped_matmul_torch, grouped_matmul_torch,
                                   xs, w, group_sizes)
    if xs.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {xs.device}")
    check_kernel_inputs(xs, w)
    if xs.device.type == "meta":
        return PlainGradient.apply(_count, grouped_matmul_torch, xs, w,
                                   group_sizes)
    return PlainGradient.apply(
        functools.partial(_launch, rows_per_tile=rows_per_tile),
        grouped_matmul_torch, xs, w, group_sizes)


def _count(xs, w, group_sizes):
    """The kernel on ``meta`` tensors: its work to the step counter (every
    expert that can hold a row counted active: the sizes are not known on
    meta), an empty output."""
    from ..launch import roofline

    M, K = xs.shape
    E, _, N = w.shape
    roofline.count_kernel("moe_gmm", roofline.gmm_work(
        M, K, N, min(E, M), xs.dtype))
    return torch.empty((M, N), dtype=xs.dtype, device=xs.device)


def _launch(xs, w, group_sizes, *, rows_per_tile: int | None):
    """One launch of the CUDA kernel on checked inputs."""
    global LAUNCHES
    M, K = xs.shape
    E, _, N = w.shape
    out = torch.empty((M, N), dtype=xs.dtype, device=xs.device)
    if M == 0:
        return out
    bm = rows_per_tile or tile_rows(M, E)
    sizes = group_sizes.to(torch.int32).contiguous()
    with torch.cuda.device(xs.device):
        rc = _kernel_fn()(xs.data_ptr(), w.data_ptr(), sizes.data_ptr(),
                out.data_ptr(), M, K, N, E, DTYPES[xs.dtype], bm,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm_fwd launch failed: "
                           f"{build.describe_error(rc)}")
    LAUNCHES += 1
    return out
