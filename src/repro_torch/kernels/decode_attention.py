"""One-token GQA attention against a KV cache (split-K) — the Hopper kernel.

Replaces the TPU kernel ``_decode_kernel`` of the JAX package and its
wrapper's cross-split combine (``src/repro/kernels/decode_attention.py``,
reached through ``decode_attention`` and ``ops.mha_decode``).  Every decode
step runs it once per attention layer when
``ModelConfig.attention_impl == "cuda"``.

Layout: ``q [B, H, D]``, the caches in the model layout ``[B, S_max, KV,
D]`` (read through their strides, never copied or transposed), and
``cache_len``, the index of the current token: positions ``<= cache_len``
are valid, as in the reference (``decode_attention.py:43``).  On the GPU
``cache_len`` is a device int32 scalar that the kernel reads through a
pointer, so a decode loop never brings it to the host.  ``S_max`` need not
be a multiple of the split (the reference asserts a multiple of 512).

- :func:`decode_attention_torch` — the plain PyTorch version (the JAX
  package's ``ref.decode_attention_ref`` with the kernel's f32 logits).
- :func:`decode_attention_splits_torch` — the same function cut as the
  bfloat16 kernel cuts it (:func:`split_plan`): per-split partials and the
  kernel's combine, in plain PyTorch, so the CPU tests reach the combine's
  numerics.
- :func:`decode_attention_stats_torch` — the statistics form in plain
  PyTorch: the normalised output in float32 and the block's ``m`` (max
  logit) and ``l`` (``Σ exp(logit − m)``), for a cache split into blocks
  held apart (the fully-seq cache layout); :func:`combine_blocks` combines
  such blocks, on every device (it is a handful of elementwise operations,
  not a kernel).
- :func:`decode_attention` — CUDA tensors launch ``csrc/decode_attention.cu``
  on the current stream or raise (bfloat16: one launch, the splits of one
  (batch, kv head) in one thread-block cluster that combines them; float32:
  split partials through scratch, then a combine launch; D 64 or 128); CPU
  tensors take the plain version.  ``LAUNCHES`` counts calls that launched.
  ``meta`` tensors (the dry run) take the kernel's checks, then an empty
  output, and its work over the whole cache (``cache_len`` is not known on
  meta; a cell decodes at its full context) goes to the active step
  counter (:func:`repro_torch.launch.roofline.decode_work`).  With
  ``stats=True`` it returns the statistics form ``(o, m, l)`` from the same
  launches (``csrc``'s ``decode_attention_stats_fwd``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..device import H100_SMS, sm_count
from . import build
from .flash_attention import DTYPES, HEAD_DIMS, NEG_INF

#: Number of times :func:`decode_attention` launched the CUDA kernels.
LAUNCHES = 0

#: Cache positions per split in the float32 CUDA kernel (the reference's
#: is 512).
SPLIT = 64

#: The bfloat16 kernel's plan (the constants of ``csrc/decode_attention.cu``
#: of the same names): query heads per block at most (the 16 rows of an
#: ``mma.sync`` tile), cache positions per tile of its ring, split lengths a
#: multiple of ``SPLIT_MULTIPLE``, at most ``MAX_SPLITS`` splits (the blocks
#: of one cluster, the portable maximum).
HEAD_GROUP = 16
TILE = 64
SPLIT_MULTIPLE = 16
MAX_SPLITS = 8

_fns: dict = {}


@functools.lru_cache(maxsize=256)
def split_plan(B: int, KV: int, n_rep: int, S: int,
               sms: int = H100_SMS) -> tuple[int, int]:
    """``(n_splits, split_len)`` of the bfloat16 kernel for a cache of
    ``S`` positions: as many splits per (batch, kv head, head group) as make
    the grid about one wave of ``sms`` blocks, at most ``MAX_SPLITS`` and no
    more than ``S`` has 64-position tiles; lengths a multiple of
    ``SPLIT_MULTIPLE``, and ``n_splits = ceil(S / split_len)``.  It depends
    on the shapes only, never on ``cache_len``: splits past it load
    nothing."""
    pairs = B * KV * -(-n_rep // HEAD_GROUP)
    want = max(1, min(MAX_SPLITS, sms // pairs, -(-S // TILE)))
    length = -(-S // want)
    length = -(-length // SPLIT_MULTIPLE) * SPLIT_MULTIPLE
    return -(-S // length), length


def _kernel_fn(stats: bool = False):
    """The entry point of the default form, or of the statistics form
    (two more pointers, ``m`` and ``l``, after the output)."""
    if stats not in _fns:
        lib = build.load("decode_attention")
        lib.decode_attention_split.restype = ctypes.c_int
        if lib.decode_attention_split() != SPLIT:
            raise RuntimeError("decode_attention.cu and its wrapper disagree "
                               "on the split size")
        fn = (lib.decode_attention_stats_fwd if stats
              else lib.decode_attention_fwd)
        fn.argtypes = (
            [ctypes.c_void_p] * (10 if stats else 8) + [ctypes.c_int] * 6
            + [ctypes.c_float] + [ctypes.c_longlong] * 10
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fns[stats] = fn
    return _fns[stats]


def decode_attention_torch(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """Plain PyTorch version: f32 logits over the whole cache, positions
    ``> cache_len`` masked to ``-1e30``, f32 softmax, ``p`` rounded to the
    value dtype, P·V in f32, cast to q's dtype."""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    kk = k_cache.repeat_interleave(H // KV, dim=2)
    vv = v_cache.repeat_interleave(H // KV, dim=2)
    logits = torch.einsum("bhd,bkhd->bhk", q.float(), kk.float())
    logits = logits * (1.0 / math.sqrt(D))
    valid = torch.arange(S, device=q.device) <= cache_len
    logits = torch.where(valid, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v_cache.dtype).float()
    return torch.einsum("bhk,bkhd->bhd", p, vv.float()).to(q.dtype)


def decode_attention_stats_torch(q, k_cache, v_cache, cache_len):
    """The statistics form in plain PyTorch: float32 ``(o [B, H, D], m [B,
    H], l [B, H])`` with ``m`` the max logit over the positions ``<=
    cache_len`` (``-1e30`` where there is none: a ``cache_len`` of -1),
    ``p = exp(logit − m)`` there and 0 elsewhere, ``l = Σ p`` and ``o =
    Σ round(p)·v / max(l, 1e-30)`` (``p`` rounded to the value dtype), so
    a block with no valid position gives ``o = 0``, ``l = 0``."""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    kk = k_cache.repeat_interleave(H // KV, dim=2).float()
    vv = v_cache.repeat_interleave(H // KV, dim=2).float()
    logits = torch.einsum("bhd,bkhd->bhk", q.float(), kk) * (1.0 / math.sqrt(D))
    valid = torch.arange(S, device=q.device) <= cache_len
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhk,bkhd->bhd", p.to(v_cache.dtype).float(), vv)
    return acc / l.clamp_min(1e-30)[..., None], m, l


def combine_blocks(o, m, l) -> torch.Tensor:
    """The statistics forms of ``n`` blocks of one cache, stacked on a
    leading block dimension (``o [n, ..., D]``, ``m``, ``l [n, ...]``),
    combined in block order: ``M = max m``, ``w = l · exp(m − M)``, ``Σ
    w·o / max(Σ w, 1e-30)``, float32.  The same inputs give the same bits
    on every device of one type (the sums run block by block)."""
    M = m.amax(dim=0)
    w = l * torch.exp(m - M)
    num, den = w[0, ..., None] * o[0], w[0]
    for i in range(1, o.shape[0]):
        num = num + w[i, ..., None] * o[i]
        den = den + w[i]
    return num / den.clamp_min(1e-30)[..., None]


def decode_attention_splits_torch(q, k_cache, v_cache, cache_len,
                                  split_len: int) -> torch.Tensor:
    """The plain version cut into splits of ``split_len`` positions, as the
    bfloat16 kernel cuts the cache: per split f32 partials ``m`` (max
    logit, ``-1e30`` where the split holds no valid position), ``l = Σ p``
    and ``acc = Σ round(p)·v`` with ``p = exp(logit − m)`` masked to 0,
    then the kernel's combine ``w = exp(m − max m)``, ``Σ acc·w /
    max(Σ l·w, 1e-30)``.  (The kernel also cuts each split into the
    16-position slices of its warps, with an online softmax over its
    tiles: more partials of the same form.)"""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    kk = k_cache.repeat_interleave(H // KV, dim=2).float()
    vv = v_cache.repeat_interleave(H // KV, dim=2)
    logits = torch.einsum("bhd,bkhd->bhk", q.float(), kk) * (1.0 / math.sqrt(D))
    valid = torch.arange(S, device=q.device) <= cache_len
    logits = torch.where(valid, logits, NEG_INF)
    ms, ls, accs = [], [], []
    for s0 in range(0, S, split_len):
        part = logits[..., s0:s0 + split_len]
        m = part.max(dim=-1, keepdim=True).values
        p = torch.where(valid[s0:s0 + split_len], torch.exp(part - m), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhk,bkhd->bhd", p.to(v_cache.dtype).float(),
                                 vv[:, s0:s0 + split_len].float()))
    m = torch.cat(ms, dim=-1)                          # [B, H, n_s]
    w = torch.exp(m - m.max(dim=-1, keepdim=True).values)
    num = (torch.stack(accs, dim=-1) * w[:, :, None, :]).sum(dim=-1)
    den = (torch.cat(ls, dim=-1) * w).sum(dim=-1, keepdim=True)
    return (num / den.clamp_min(1e-30)).to(q.dtype)


def check_kernel_inputs(q, k_cache, v_cache) -> None:
    """What the CUDA kernels take beyond :func:`_check`: D 64 or 128,
    float32 or bfloat16, the head dimension contiguous; for bfloat16 every
    base address and every stride of q and the caches a multiple of 16
    bytes (the kernel copies K and V rows 16 bytes at a time and reads q in
    aligned pairs).  Raises where they do not hold; nothing is copied."""
    D = q.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the kernel takes {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise TypeError(f"dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if q.stride(2) != 1 or k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("the head dimension must be contiguous")
    if q.dtype == torch.bfloat16:
        for t in (q, k_cache, v_cache):
            if t.data_ptr() % 16:
                raise ValueError("bfloat16 tensors must start on 16 bytes "
                                 "(the kernel copies 16 bytes at a time)")
            if any(st % 8 for st in t.stride()[:-1]):
                raise ValueError(f"strides {t.stride()}: every stride must "
                                 "be a multiple of 16 bytes")


def _check(q, k, v) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q must be [B, H, D] and the caches [B, S, KV, D]")
    B, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(
            f"caches {tuple(k.shape)} / {tuple(v.shape)} do not fit q "
            f"{tuple(q.shape)}"
        )
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q and the caches lie on different devices")


def decode_attention(q, k_cache, v_cache, cache_len, stats: bool = False):
    """One-token attention on the tensors' own device.  ``cache_len`` is
    a 0-d int32 tensor on that device (on the CPU an ``int`` will do); it
    may be -1 (no valid position).  With ``stats``, the statistics form
    ``(o, m, l)`` (:func:`decode_attention_stats_torch`) from the same
    launches."""
    global LAUNCHES
    _check(q, k_cache, v_cache)
    if q.device.type == "cpu":
        if stats:
            return decode_attention_stats_torch(q, k_cache, v_cache,
                                                cache_len)
        return decode_attention_torch(q, k_cache, v_cache, cache_len)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    check_kernel_inputs(q, k_cache, v_cache)
    if (not isinstance(cache_len, torch.Tensor)
            or cache_len.dtype != torch.int32 or cache_len.numel() != 1
            or cache_len.device != q.device):
        raise ValueError("cache_len must be one int32 on q's device")
    if q.device.type == "meta":
        from ..launch import roofline

        roofline.count_kernel("decode_attention", roofline.decode_work(
            B, H, KV, D, S, q.dtype))
        if stats:
            return (torch.empty((B, H, D), device=q.device),
                    torch.empty((B, H), device=q.device),
                    torch.empty((B, H), device=q.device))
        return torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    out = torch.empty((B, H, D), dtype=torch.float32 if stats else q.dtype,
                      device=q.device)
    block_stats = ((torch.empty((B, H), dtype=torch.float32,
                                device=q.device),
                    torch.empty((B, H), dtype=torch.float32,
                                device=q.device)) if stats else ())
    if q.dtype == torch.bfloat16:
        n_splits, split_len = split_plan(B, KV, H // KV, S,
                                         sm_count(q.device))
        scratch = (None, None, None)
    else:
        # Scratch for the split partials.  It is freed when this returns,
        # before the kernels have run: the caching allocator hands the
        # memory only to later work on the same stream, which runs after
        # them.
        n_splits, split_len = 0, 0
        n_s = -(-S // SPLIT)
        m = torch.empty((B, H, n_s), dtype=torch.float32, device=q.device)
        scratch = (m, torch.empty_like(m),
                   torch.empty((B, H, n_s, D), dtype=torch.float32,
                               device=q.device))
    strides = (q.stride(0), q.stride(1),
               *(t.stride(i) for t in (k_cache, v_cache) for i in range(3)),
               out.stride(0), out.stride(1))
    with torch.cuda.device(q.device):
        rc = _kernel_fn(stats)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in scratch),
            out.data_ptr(), *(t.data_ptr() for t in block_stats),
            B, S, H, KV, D, DTYPES[q.dtype],
            1.0 / math.sqrt(D), *strides, split_len, n_splits,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"decode_attention_fwd launch failed: CUDA error {rc}"
        )
    LAUNCHES += 1
    return (out, *block_stats) if stats else out
