"""Mamba2 SSD intra-chunk dual form — the Hopper kernel.

Replaces the TPU kernel ``_ssd_kernel`` of the JAX package
(``src/repro/kernels/ssd_scan.py``, reached through ``ssd_intra_chunk`` and
``ops.ssd_chunked_pallas``).  The prefill of every SSM layer runs it once
when ``ModelConfig.ssm_impl == "cuda"``, through
:func:`repro_torch.kernels.ops.ssd_chunked_cuda`.

Layout: the model's, ``x [B, S, H, P]``, ``dt [B, S, H]`` (float32, after
the softplus), ``A [H]`` (float32, negative), ``Bm, Cm [B, S, G, N]``, with
``S`` cut into ``S / Q`` chunks of ``Q`` steps; head ``h`` reads group
``h // (H // G)``, as the reference's ``jnp.repeat(Bm, H // G, axis=2)``
gives, but nothing is repeated or transposed: the kernel reads strides.
Returns ``y [B, S, H, P]`` (the intra-chunk part, float32, which
``ops.ssd_chunked_cuda`` adds to the inter-chunk part before it rounds to
x's dtype), ``states [B, H, Nc, N, P]`` float32 and ``seg [B, H, Nc, Q]``
float32 — the reference kernel's three outputs, ``y`` in the model layout
and not yet rounded.

- :func:`ssd_intra_chunk_torch` — the plain PyTorch version (the JAX
  package's ``ref.ssd_intra_chunk_ref`` restated in the model layout, all
  in float32; float64 inputs make it a float64 oracle).  The CPU tests use
  it, and the kernel is held against it on the GPU.
- :func:`ssd_intra_chunk` — CUDA tensors launch the kernel
  (``csrc/ssd_scan.cu``: tensor cores for bfloat16, one block per chunk
  and group of :func:`head_group_plan` heads that share B and C; scalar
  FMAs for float32; P 64, N 16 / 32 / 64 / 128, Q a multiple of 16 up to
  256) on the current stream or raise; CPU tensors take the plain version.
  ``LAUNCHES`` counts kernel launches.  Its gradient is the plain
  version's, by autograd (:mod:`.grad`).  ``meta`` tensors (the dry run)
  take the kernel's checks, then empty outputs, and its work
  (:func:`repro_torch.launch.roofline.ssd_work`) goes to the active step
  counter.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..device import H100_SMS, sm_count
from . import build
from .flash_attention import DTYPES
from .grad import PlainGradient

#: Number of times :func:`ssd_intra_chunk` launched the CUDA kernel.
LAUNCHES = 0

#: Widths the CUDA kernel is built for (every SSM config of the repo).
HEAD_DIMS = (64,)
STATE_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 256
#: The kernel's chunks are whole 16-step tiles.
CHUNK_MULTIPLE = 16
#: The bfloat16 kernel's plan (constants of ``csrc/ssd_scan.cu`` of the
#: same names): heads per block at most, and the shared memory a block may
#: have on an H100.
MAX_HEADS_PER_BLOCK = 3
SMEM_MAX = 232448

_fn = None


def smem_bytes(N: int, Q: int, heads: int, P: int = 64) -> int:
    """Shared memory of a bfloat16 block (``smem_bytes_bf16`` of the
    source): the chunk's B rows, and per head its x rows, seg (float64),
    dt, the decay's column factors and the state weights (float32)."""
    return Q * N * 2 + heads * Q * (P * 2 + 20)


@functools.lru_cache(maxsize=256)
def head_group_plan(B: int, S: int, H: int, G: int, N: int, Q: int,
                    P: int = 64, sms: int = H100_SMS) -> int:
    """Heads per bfloat16 block: a divisor of ``H / G`` (so a block never
    spans two B/C groups) up to ``MAX_HEADS_PER_BLOCK`` whose shared memory
    fits, chosen to make waves × a block's work least (one block per SM):
    a block computes C·Bᵀ once (``Q²N/2``) and per head the scores·x and
    state products with their hi/lo halves (``Q²P + 2QNP``).  Ties go to
    more heads per block (fewer B/C reads)."""
    rep, chunks = H // G, S // Q
    best = None
    for hb in range(1, MAX_HEADS_PER_BLOCK + 1):
        if rep % hb or smem_bytes(N, Q, hb, P) > SMEM_MAX:
            continue
        waves = -(-(B * chunks * H // hb) // sms)
        cost = waves * (Q * Q * N // 2 + hb * (Q * Q * P + 2 * Q * N * P))
        if best is None or cost <= best[0]:
            best = (cost, hb)
    return best[1]


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("ssd_scan").ssd_intra_chunk_fwd
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 15 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def ssd_intra_chunk_torch(x, dt, A, Bm, Cm, chunk: int):
    """Plain PyTorch version, float32 throughout, outputs included
    (float64 for float64 inputs): ``seg = cumsum(dt·A)`` per chunk, the
    decay ``exp(seg_i − seg_j)`` below the diagonal and 0 above it,
    ``y = ((C·Bᵀ)·decay·dt_j)·x`` and ``S = Bᵀ·(x·dt·exp(seg_last −
    seg))``.  Above the diagonal ``seg_i − seg_j`` is positive and can
    overflow the exponent: it is masked to ``-inf`` before the exponent
    (the reference selects after it), which gives the same values and a
    finite gradient where ``0 · exp(overflow)`` would give NaN."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q, rep = chunk, H // G
    Nc = S // Q
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32

    def chunked(t, width):    # [B, S, H, w] -> [B, H, Nc, Q, w]
        return t.to(acc).reshape(B_, Nc, Q, H, width).permute(0, 3, 1, 2, 4)

    xf = chunked(x, P)
    dtf = dt.to(acc).reshape(B_, Nc, Q, H).permute(0, 3, 1, 2)
    Bf = chunked(Bm.repeat_interleave(rep, dim=2), N)
    Cf = chunked(Cm.repeat_interleave(rep, dim=2), N)
    seg = torch.cumsum(dtf * A.to(acc)[None, :, None, None], dim=-1)
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(mask, seg[..., :, None] - seg[..., None, :],
                                  -torch.inf))
    scores = torch.einsum("bhcin,bhcjn->bhcij", Cf, Bf) * decay
    scores = scores * dtf[..., None, :]
    y = torch.einsum("bhcij,bhcjp->bhcip", scores, xf)
    state_decay = torch.exp(seg[..., -1:] - seg)
    xw = xf * (dtf * state_decay)[..., None]
    states = torch.einsum("bhcjn,bhcjp->bhcnp", Bf, xw)
    y = y.permute(0, 2, 3, 1, 4).reshape(B_, S, H, P)
    return y, states, seg


def _check(x, dt, A, Bm, Cm, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 \
            or Cm.shape != Bm.shape:
        raise ValueError("x must be [B, S, H, P], dt [B, S, H], A [H], "
                         "Bm and Cm [B, S, G, N]")
    B_, S, H, _ = x.shape
    if dt.shape != (B_, S, H) or A.shape != (H,) \
            or Bm.shape[:2] != (B_, S) or H % Bm.shape[2]:
        raise ValueError(f"shapes do not fit x {tuple(x.shape)}: dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B/C "
                         f"{tuple(Bm.shape)}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"seq len {S} not divisible by chunk {chunk}")
    if not (x.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(f"dtypes differ: {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("dt and A must be float32")
    if len({t.device for t in (x, dt, A, Bm, Cm)}) != 1:
        raise ValueError("the inputs lie on different devices")


def ssd_intra_chunk(x, dt, A, Bm, Cm, chunk: int):
    """The intra-chunk SSD on the tensors' own device: the hand-written
    kernel for CUDA tensors (no synchronisation), the plain version for CPU
    tensors.  ``chunk`` must divide S; ``y`` is float32.  Differentiable:
    the gradient is the plain version's
    (:class:`~repro_torch.kernels.grad.PlainGradient`)."""
    _check(x, dt, A, Bm, Cm, chunk)
    plain = functools.partial(ssd_intra_chunk_torch, chunk=chunk)
    if x.device.type == "cpu":
        return PlainGradient.apply(plain, plain, x, dt, A, Bm, Cm)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    _check_kernel_inputs(x, Bm, Cm, chunk)
    launch = _count if x.device.type == "meta" else _launch
    return PlainGradient.apply(functools.partial(launch, chunk=chunk),
                               plain, x, dt, A, Bm, Cm)


def _outputs(x, Nc: int, N: int, chunk: int):
    """Empty ``y``, ``states`` and ``seg`` of the kernel's shapes."""
    B_, S, H, P = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty((B_, S, H, P), **f32),
            torch.empty((B_, H, Nc, N, P), **f32),
            torch.empty((B_, H, Nc, chunk), **f32))


def _count(x, dt, A, Bm, Cm, *, chunk: int):
    """The kernel on ``meta`` tensors: its work to the step counter, empty
    outputs."""
    from ..launch import roofline

    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    roofline.count_kernel("ssd_scan", roofline.ssd_work(
        B_, S, H, G, N, chunk, x.dtype, P))
    return _outputs(x, S // chunk, N, chunk)


def _check_kernel_inputs(x, Bm, Cm, chunk: int) -> None:
    """What the CUDA kernel takes beyond :func:`_check`.  Raises; never
    copies."""
    P, N = x.shape[3], Bm.shape[3]
    if x.dtype not in DTYPES:
        raise TypeError(f"dtype {x.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"P {P}, N {N}: the kernel takes P in {HEAD_DIMS} "
                         f"and N in {STATE_DIMS}")
    if chunk % CHUNK_MULTIPLE or chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the kernel takes a multiple of "
                         f"{CHUNK_MULTIPLE} up to {MAX_CHUNK}")
    if any(t.stride(3) != 1 for t in (x, Bm, Cm)):
        raise ValueError("the last axis of x, Bm and Cm must be contiguous")
    if x.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (x, Bm, Cm)):
        raise ValueError("bfloat16 rows must start on 16 bytes (the kernel "
                         "copies 16 bytes at a time)")


def _launch(x, dt, A, Bm, Cm, *, chunk: int):
    """One launch of the CUDA kernel on checked inputs."""
    global LAUNCHES
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Nc = S // chunk
    hb = (head_group_plan(B_, S, H, G, N, chunk, P, sm_count(x.device))
          if x.dtype == torch.bfloat16 else 1)
    A = A.contiguous()
    y, states, seg = _outputs(x, Nc, N, chunk)
    strides = [t.stride(i) for t in (x, dt, Bm, Cm, y) for i in range(3)]
    with torch.cuda.device(x.device):
        rc = _kernel_fn()(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), states.data_ptr(), seg.data_ptr(),
            B_, S, H, G, chunk, N, P, DTYPES[x.dtype], *strides, hb,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_intra_chunk_fwd launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return y, states, seg
