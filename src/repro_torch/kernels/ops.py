"""The attention kernels in the model layout (``[B, S, heads, D]``).

The entry points the models call when ``cfg.attention_impl == "cuda"``,
with the signatures of the JAX package's ``repro/kernels/ops.py``
(``mha_flash``, ``mha_decode``) less its block sizes and interpret switch:
the kernels choose their own tiles, and a tensor on the CPU takes the
kernel's plain version.  Unlike the reference, nothing here transposes or
reshapes: the kernels read the model layout through its strides, so a
decode step does not copy the cache.
"""
from __future__ import annotations

from .decode_attention import decode_attention
from .flash_attention import flash_attention


def mha_flash(q, k, v, *, causal: bool = True):
    """q ``[B,S,H,D]``; k/v ``[B,S,KV,D]`` → ``[B,S,H,D]`` (GQA folded into
    the kernel)."""
    return flash_attention(q, k, v, causal=causal)


def mha_decode(q, k_cache, v_cache, cache_len):
    """q ``[B,1,H,D]``; caches ``[B,S,KV,D]`` → ``[B,1,H,D]``; positions
    ``<= cache_len`` are attended."""
    return decode_attention(q[:, 0], k_cache, v_cache, cache_len)[:, None]
