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
  :func:`grouped_matmul_dx_torch` and :func:`grouped_matmul_dw_torch` are
  the plain forms of its gradient in ``xs`` and in ``w``, which the two
  backward kernels are held against.
- :func:`grouped_matmul` — CUDA tensors launch the kernel
  (``csrc/moe_gmm.cu``: wgmma + TMA for bfloat16, scalar FMAs for float32)
  on the current stream or raise; the kernel reads the group sizes from
  device memory, so the host never waits on them.  The bfloat16 kernel's
  output tile is :func:`tile_rows` rows high, chosen from ``M`` and ``E``
  alone, and its inputs must suit a TMA tensor map (:mod:`.tma`).  CPU
  tensors take the plain version.  ``LAUNCHES`` counts kernel launches.
  The gradient of a bfloat16 CUDA call is two kernels of its own
  (:class:`KernelGradient`: ``dX`` and ``dW``, on the current stream, no
  host read, counted in ``BACKWARD_LAUNCHES``); that of CPU, float32 CUDA
  and ``meta`` tensors is the plain version's, by autograd (:mod:`.grad`).
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
from .tma import TMA_ALIGN, check_tma

#: Number of times :func:`grouped_matmul` launched the CUDA kernel.
LAUNCHES = 0
#: Number of launches of the two backward kernels (``dX`` and ``dW``) by
#: :class:`KernelGradient`: two a backward call, one where only one input
#: needs a gradient, none on zero rows.
BACKWARD_LAUNCHES = 0

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


@functools.cache
def _backward_fn(name: str):
    """``moe_gmm_bwd_dx`` (with a tile height) or ``moe_gmm_bwd_dw``."""
    fn = getattr(build.load("moe_gmm"), name)
    ints = 5 if name == "moe_gmm_bwd_dx" else 4
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def grouped_matmul_dx_torch(g, w, group_sizes) -> torch.Tensor:
    """Plain gradient of :func:`grouped_matmul_torch` in ``xs``, for ``g``
    ``[M, N]`` the gradient of its output: ``g[rows of e] @ w[e]ᵀ`` in
    float32 for every expert, cast to g's dtype → ``[M, K]``."""
    return grouped_matmul_torch(g, w.transpose(1, 2), group_sizes)


def grouped_matmul_dw_torch(xs, g, group_sizes) -> torch.Tensor:
    """Plain gradient of :func:`grouped_matmul_torch` in ``w``:
    ``xs[rows of e]ᵀ @ g[rows of e]`` in float32 for every expert (zeros
    for one with no rows), cast to xs's dtype → ``[E, K, N]``."""
    sizes = [int(n) for n in group_sizes.tolist()]
    if sum(sizes) != xs.shape[0] or min(sizes, default=0) < 0:
        raise ValueError(f"group sizes {sizes} do not split {xs.shape[0]} "
                         "rows")
    dw = torch.zeros((len(sizes), xs.shape[1], g.shape[1]), dtype=xs.dtype,
                     device=xs.device)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            dw[e] = (xs[start:start + n].float().T
                     @ g[start:start + n].float()).to(xs.dtype)
        start += n
    return dw


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
    Differentiable in ``xs`` and ``w``: on bfloat16 CUDA tensors by the
    backward kernels (:class:`KernelGradient`), else by the plain
    version's autograd (:class:`~repro_torch.kernels.grad.PlainGradient`)."""
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
    if xs.dtype == torch.bfloat16:
        return KernelGradient.apply(xs, w, group_sizes, rows_per_tile)
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


class KernelGradient(torch.autograd.Function):
    """K5 on bfloat16 CUDA tensors with a gradient of kernels:
    ``KernelGradient.apply(xs, w, group_sizes, rows_per_tile)``.  Forward,
    :func:`_launch`; backward, for ``g`` the gradient of the output,
    ``dX = g[rows of e] · w[e]ᵀ`` and ``dW[e] = xs[rows of e]ᵀ ·
    g[rows of e]`` (one kernel each, launched only for an input that needs
    its gradient) from the saved ``xs``, ``w`` and int32 group sizes: no
    recompute, no host read, float32 sums rounded to bfloat16 once, as
    :func:`grouped_matmul_dx_torch` and :func:`grouped_matmul_dw_torch`."""

    @staticmethod
    def forward(ctx, xs, w, group_sizes, rows_per_tile):
        sizes = group_sizes.to(torch.int32).contiguous()
        ctx.save_for_backward(xs, w, sizes)
        ctx.set_materialize_grads(False)
        return _launch(xs, w, sizes, rows_per_tile=rows_per_tile)

    @staticmethod
    def backward(ctx, g):
        xs, w, sizes = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        if g is None:
            return None, None, None, None
        if not g.is_contiguous() or g.data_ptr() % TMA_ALIGN:
            g = g.clone(memory_format=torch.contiguous_format)
        return (_launch_dx(g, w, sizes) if need_x else None,
                _launch_dw(xs, g, sizes) if need_w else None, None, None)


def _launch_backward(name: str, inputs: tuple, out, ints: tuple):
    """One launch of a backward kernel's C entry ``name`` on the current
    stream: the input tensors' pointers, the output's, the ints."""
    global BACKWARD_LAUNCHES
    with torch.cuda.device(out.device):
        rc = _backward_fn(name)(*(t.data_ptr() for t in inputs),
                                out.data_ptr(), *ints,
                                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{build.describe_error(rc)}")
    BACKWARD_LAUNCHES += 1
    return out


def _launch_dx(g, w, sizes) -> torch.Tensor:
    M, N = g.shape
    E, K, _ = w.shape
    dx = torch.empty((M, K), dtype=g.dtype, device=g.device)
    if M == 0:
        return dx
    return _launch_backward("moe_gmm_bwd_dx", (g, w, sizes), dx,
                            (M, K, N, E, tile_rows(M, E)))


def _launch_dw(xs, g, sizes) -> torch.Tensor:
    M, K = xs.shape
    E, N = sizes.shape[0], g.shape[1]
    if M == 0:
        return torch.zeros((E, K, N), dtype=xs.dtype, device=xs.device)
    dw = torch.empty((E, K, N), dtype=xs.dtype, device=xs.device)
    return _launch_backward("moe_gmm_bwd_dw", (xs, g, sizes), dw,
                            (M, K, N, E))
