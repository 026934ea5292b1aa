"""The JAX package's kernel oracles (its ``kernels/ref.py``), under their
names, signatures and layouts, as thin calls into the plain PyTorch
version each kernel module already has.

- :func:`flash_attention_ref` — ``q [BH, Sq, D]``, ``k, v [BKV, Sk, D]``;
  query row ``i`` reads kv row ``i // n_rep`` (``jnp.repeat`` on axis 0).
- :func:`decode_attention_ref` — ``q [BH, D]``, ``k, v [BKV, S, D]``,
  positions ``<= cache_len`` attended.
- :func:`ssd_intra_chunk_ref` — the chunked layout ``x [B, H, Nc, Q, P]``,
  ``dt [B, H, Nc, Q]``, ``A [H]``, ``B_, C [B, H, Nc, Q, N]`` →
  ``(y_intra, state, seg)``.
- :func:`grouped_matmul_ref` — ``x [E, Cap, d]``, ``w [E, d, f]``.

The plain versions keep their logits in float32 of the inputs as given
(the kernels' numerics), where the reference rounds a bf16 product before
its cast; float32 inputs give the reference's values up to summation
order.
"""
from __future__ import annotations

import torch

from .decode_attention import decode_attention_torch
from .flash_attention import flash_attention_torch
from .moe_gmm import grouped_matmul_torch
from .ssd_scan import ssd_intra_chunk_torch


def flash_attention_ref(q, k, v, *, causal=True, n_rep=1):
    """q [BH, Sq, D]; k/v [BKV, Sk, D] → [BH, Sq, D]."""
    if q.shape[0] != k.shape[0] * n_rep:
        raise ValueError(f"{q.shape[0]} query rows for {k.shape[0]} kv rows "
                         f"at n_rep {n_rep}")
    out = flash_attention_torch(q.transpose(0, 1)[None],
                                k.transpose(0, 1)[None],
                                v.transpose(0, 1)[None], causal=causal)
    return out[0].transpose(0, 1)


def decode_attention_ref(q, k, v, cache_len, *, n_rep=1):
    """q [BH, D]; k/v [BKV, S, D]; positions > cache_len masked."""
    if q.shape[0] != k.shape[0] * n_rep:
        raise ValueError(f"{q.shape[0]} query rows for {k.shape[0]} kv rows "
                         f"at n_rep {n_rep}")
    return decode_attention_torch(q[None], k.transpose(0, 1)[None],
                                  v.transpose(0, 1)[None], cache_len)[0]


def ssd_intra_chunk_ref(x, dt, A, B_, C):
    """Chunked-layout oracle.  x [B,H,Nc,Q,P], dt [B,H,Nc,Q], A [H],
    B_/C [B,H,Nc,Q,N] → (y_intra, state, seg) matching ssd_scan."""
    Bsz, H, Nc, Q, P = x.shape

    def seq(t):                       # [B, H, Nc, Q, w] -> [B, S, H, w]
        return t.permute(0, 2, 3, 1, 4).reshape(Bsz, Nc * Q, H, t.shape[-1])

    y, state, seg = ssd_intra_chunk_torch(
        seq(x), seq(dt.float()[..., None])[..., 0], A.float(), seq(B_),
        seq(C), Q)
    y = y.reshape(Bsz, Nc, Q, H, P).permute(0, 3, 1, 2, 4)
    return y.to(x.dtype), state, seg


def grouped_matmul_ref(x, w):
    """x [E, Cap, d]; w [E, d, f] → [E, Cap, f]."""
    E, cap, d = x.shape
    sizes = torch.full((E,), cap, dtype=torch.int64, device=x.device)
    out = grouped_matmul_torch(x.reshape(E * cap, d), w, sizes)
    return out.reshape(E, cap, w.shape[2])
