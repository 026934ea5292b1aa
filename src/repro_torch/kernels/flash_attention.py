"""Causal / full GQA attention forward — the Hopper kernel.

Replaces the TPU kernel ``_flash_kernel`` of the JAX package
(``src/repro/kernels/flash_attention.py``, reached through
``flash_attention`` and ``ops.mha_flash``).  The prefill of every attention
layer runs it once when ``ModelConfig.attention_impl == "cuda"``.

Layout: the model's, ``q [B, Sq, H, D]``, ``k, v [B, Sk, KV, D]`` →
``[B, Sq, H, D]`` in q's dtype; query head ``h`` reads kv head
``h // (H // KV)``, with no repeated K/V.  The kernel reads its inputs
through their strides (the head dimension must be contiguous), so the JAX
kernel's ``[BH, S, D]`` signature is the special case ``B = 1`` of a
permuted view, and no input is copied.  Causal means query ``i`` sees keys
``j <= i`` (no offset), as in the reference; any ``Sq``/``Sk`` works (the
reference asserts multiples of its 128-row block).

Two functions:

- :func:`flash_attention_torch` — the plain PyTorch version (the JAX
  package's ``ref.flash_attention_ref`` with the kernel's f32 logits).  The
  CPU tests use it, and the kernel is held against it on the GPU.
- :func:`flash_attention` — CUDA tensors launch the kernel
  (``csrc/flash_attention.cu``: wgmma + TMA for bfloat16, scalar FMAs for
  float32; D 64 or 128) on the current stream or raise; CPU tensors take
  the plain version.  bfloat16 inputs must suit a TMA tensor map
  (:mod:`.tma`) and are refused, never copied, where they do not.
  ``LAUNCHES`` counts kernel launches.  Its gradient is the plain
  version's, by autograd (:mod:`.grad`): the JAX package has no backward
  kernel either.  ``meta`` tensors (the dry run) take the kernel's checks,
  then an empty output of its shape, and its work (:func:`repro_torch.
  launch.roofline.flash_work`) goes to the active step counter.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .grad import PlainGradient
from .tma import check_tma, tma_strides

#: Number of times :func:`flash_attention` launched the CUDA kernel.
LAUNCHES = 0

NEG_INF = -1e30
#: Head dimensions the CUDA kernel is built for (every config of the repo).
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Query rows per work item of the bfloat16 kernel (``BF16_BQ`` in the
#: source: two consumer warpgroups of 64 rows).  Its ``ceil(Sq / BF16_BQ)
#: * H * B`` items are walked by at most one persistent block per SM.
BF16_BQ = 128

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float]
            + [ctypes.c_longlong] * 12 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_torch(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version: f32 logits of the inputs as given, scaled by
    ``1/sqrt(D)``, masked to ``-1e30``, f32 softmax, ``p`` rounded to the
    value dtype, then the P·V product in f32, cast to q's dtype."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kk = k.repeat_interleave(H // KV, dim=2)
    vv = v.repeat_interleave(H // KV, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float())
    logits = logits * (1.0 / math.sqrt(D))
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, vv.float()).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, heads, D]")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(
            f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q "
            f"{tuple(q.shape)}"
        )
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")


def check_kernel_inputs(q, k, v) -> None:
    """What the CUDA kernel takes beyond :func:`_check`: D 64 or 128,
    float32 or bfloat16, a contiguous head dimension, and for bfloat16 a
    layout TMA can describe.  Raises; never copies."""
    D = q.shape[3]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernel takes {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise TypeError(f"dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dimension must be contiguous")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma(t, name)


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Attention forward on the tensors' own device: the hand-written
    kernel for CUDA tensors (no synchronisation), the plain version for
    CPU tensors.  Differentiable: the gradient is the plain version's
    (:class:`~repro_torch.kernels.grad.PlainGradient`)."""
    _check(q, k, v)
    plain = functools.partial(flash_attention_torch, causal=causal)
    if q.device.type == "cpu":
        return PlainGradient.apply(plain, plain, q, k, v)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    check_kernel_inputs(q, k, v)
    launch = _count if q.device.type == "meta" else _launch
    return PlainGradient.apply(functools.partial(launch, causal=causal),
                               plain, q, k, v)


def _count(q, k, v, *, causal: bool) -> torch.Tensor:
    """The kernel on ``meta`` tensors: its work to the step counter, an
    empty output."""
    from ..launch import roofline

    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    roofline.count_kernel("flash_attention", roofline.flash_work(
        B, Sq, Sk, H, KV, D, q.dtype, causal))
    return torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)


def _launch(q, k, v, *, causal: bool) -> torch.Tensor:
    """One launch of the CUDA kernel on checked inputs."""
    global LAUNCHES
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or Sk == 0:
        return out.zero_()      # no keys: the plain version's zeros
    strides = [st for t in (q, k, v) for st in (
        tma_strides(t) if t.dtype == torch.bfloat16 else t.stride()[:3])]
    strides += out.stride()[:3]
    with torch.cuda.device(q.device):
        rc = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, KV, D, int(causal), DTYPES[q.dtype],
            1.0 / math.sqrt(D), *strides,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{build.describe_error(rc)}")
    LAUNCHES += 1
    return out
