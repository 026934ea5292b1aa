"""Mamba2 mixer: state-space duality (SSD) layer [arXiv:2405.21060].

The JAX package's ``models/ssd.py`` over PyTorch tensors.  Prefill uses the
chunked dual form: within a chunk of Q steps the recurrence is a masked,
decayed attention-like product, and the chunk-boundary states are carried
by a short loop over the chunks.  Decode is the O(1) recurrent step, plain
tensor code in both packages.

``cfg.ssm_impl`` picks the chunked form: ``"cuda"`` runs the intra-chunk
part as the hand-written kernel
(:func:`repro_torch.kernels.ops.ssd_chunked_cuda`), ``"chunked"`` is the
reference's plain :func:`ssd_chunked`.  :func:`ssd_reference` is the
sequential oracle.

Shapes: x [B,S,H,P] (H = d_inner/P SSD heads), dt [B,S,H], A [H] (negative),
B/C [B,S,G,N] with G groups broadcast over heads.

Given a :class:`~repro_torch.parallel.tensor.Participant` (``part``), the
mixer runs on its block ``[c0, c1)`` of ``d_inner``, cut as ``shard_tree``
cuts ``wx`` (ceil-divided over ``"model"``): ``wz``, ``wx``, ``conv_x_*``
and ``inner_norm`` are that block, ``out_proj`` its rows; ``wbc``,
``wdt``, ``conv_bc_*``, ``A_log``, ``D`` and ``dt_bias`` are replicated,
and it reads their columns of the heads ``[c0 // P, ceil(c1 / P))`` that
its channels touch (and of the B/C groups they use).  Where the heads do
not divide the model axis (mamba2-130m's 24 on 16: 96 channels, 1.5 heads
a participant) the block is laid into whole-head slots, zeros in the
channels it does not own, and its channels of ``y`` are taken back: the
SSD never mixes the channels of a head (``y[..., h, p]`` reads
``x[..., h, p]``, the head's ``dt``, ``A`` and ``D`` and the shared B/C),
so a straddled head is computed on both of its participants, each for its
own channels, and zero channels give zero ``y`` and a zero state.  Where
the heads divide, the block is whole heads and nothing is padded.
``inner_norm`` normalises over all of ``d_inner``: the mean of squares is
summed over ``"model"`` before the ``rsqrt`` (:func:`sharded_rmsnorm`); a
norm over one block alone would be another function.  Its state is its
block of the cache's (``parallel/sharding.py``'s ``cache_shardings``):
``conv_x`` over its ``d_inner`` columns, ``conv_bc`` whole (replicated
over ``"model"``, the same bits on every participant), and ``ssm`` its
heads where they divide the model axis, else whole on every participant:
after the prefill and after each decode step every participant's
channels of the new state are all-gathered over ``"model"`` into it (one
all-gather a layer), the same bits on every participant.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel.tensor import (
    enter_model_region,
    leave_model_region_product,
    sum_over_model,
)
from .layers import _kept, _normal, dtype_of, rmsnorm

Params = dict[str, Any]


class SsmState(NamedTuple):
    conv_x: torch.Tensor   # [B, K-1, d_inner] shift register (x channels)
    conv_bc: torch.Tensor  # [B, K-1, 2·G·N] shift register (B|C channels)
    ssm: torch.Tensor      # [B, H, P, N] float32


def ssm_shapes(cfg) -> dict[str, tuple]:
    d, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gn2 = 2 * cfg.ssm_groups * cfg.ssm_state
    return {"norm_scale": (d,), "wz": (d, di), "wx": (d, di),
            "wbc": (d, gn2), "wdt": (d, H),
            "conv_x_w": (cfg.ssm_conv, di), "conv_x_b": (di,),
            "conv_bc_w": (cfg.ssm_conv, gn2), "conv_bc_b": (gn2,),
            "A_log": (H,), "D": (H,), "dt_bias": (H,),
            "inner_norm": (di,), "out_proj": (di, d)}


def ssm_init(gen, cfg, n_blocks: int, device, leaf=_kept) -> Params:
    """Parameters of ``n_blocks`` Mamba2 mixers, stacked on axis 0, drawn as
    the reference draws them: N(0, 0.02) projections, N(0, 0.1) conv
    weights, ``A_log = log(1..H)`` in float32 whatever ``param_dtype`` is,
    and ``dt_bias`` the inverse softplus of a log-uniform dt in
    [1e-3, 1e-1] (each through ``leaf``, as ``layers.attention_init``)."""
    pdt = dtype_of(cfg.param_dtype)
    H = cfg.ssm_heads
    p: Params = {}
    for name, shape in ssm_shapes(cfg).items():
        full = (n_blocks, *shape)
        if name in ("norm_scale", "inner_norm", "D"):
            t = torch.ones(full, dtype=pdt, device=device)
        elif name in ("conv_x_b", "conv_bc_b"):
            t = torch.zeros(full, dtype=pdt, device=device)
        elif name == "A_log":
            t = torch.log(torch.arange(
                1, H + 1, dtype=torch.float32, device=device)).expand(
                    full).clone()
        elif name == "dt_bias":
            u = torch.rand(full, generator=gen, device=device)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                           + math.log(1e-3))
            t = (dt + torch.log(-torch.expm1(-dt))).to(pdt)
        else:
            scale = 0.1 if name.startswith("conv") else 0.02
            t = _normal(gen, full, scale, pdt, device)
        p[name] = leaf(name, t)
    return p


# ---------------------------------------------------------------------------
# causal depthwise conv1d
# ---------------------------------------------------------------------------
def causal_conv1d(x, w, b, prepend=None):
    """x: [B, S, C]; w: [K, C]; causal (left) padding or supplied state."""
    K = w.shape[0]
    if prepend is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = prepend.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                        # [B, S+K-1, C]
    S = x.shape[1]
    out = xp[:, 0:S, :] * w[0].to(x.dtype)
    for i in range(1, K):
        out = out + xp[:, i:i + S, :] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


# ---------------------------------------------------------------------------
# chunked SSD (dual form), plain
# ---------------------------------------------------------------------------
def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """Returns (y [B,S,H,P] in x's dtype, final_state [B,H,P,N] f32).
    Computes in float32 (in float64 for float64 inputs, an oracle for
    float32 kernels)."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq len {S} not divisible by chunk {Q}")
    Nc = S // Q

    f32 = torch.float64 if x.dtype == torch.float64 else torch.float32
    xc = x.reshape(B_, Nc, Q, H, P).to(f32)
    dtc = dt.reshape(B_, Nc, Q, H).to(f32)
    Bc = Bm.reshape(B_, Nc, Q, G, N).repeat_interleave(rep, dim=3).to(f32)
    Cc = Cm.reshape(B_, Nc, Q, G, N).repeat_interleave(rep, dim=3).to(f32)

    a = dtc * A.to(f32)[None, None, None, :]             # [B,Nc,Q,H]
    seg = torch.cumsum(a, dim=2)

    # intra-chunk: decay(i <- j) = exp(seg_i - seg_j), valid for i >= j;
    # masked before the exponent (the reference masks after it): the same
    # values, and no NaN gradient where seg_i - seg_j (i < j) overflows.
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(
        mask[None, None, :, :, None],
        seg[:, :, :, None, :] - seg[:, :, None, :, :], -torch.inf))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * decay
    scores = scores * dtc[:, :, None, :, :]              # dt_j weighting
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

    # per-chunk boundary states
    chunk_sum = seg[:, :, -1, :]                         # [B,Nc,H]
    state_decay = torch.exp(chunk_sum[:, :, None, :] - seg)
    weighted = xc * (dtc * state_decay)[..., None]
    S_c = torch.einsum("bcjhn,bcjhp->bchpn", Bc, weighted)   # [B,Nc,H,P,N]

    # inter-chunk recurrence
    h = (torch.zeros((B_, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    chunk_decay = torch.exp(chunk_sum)                   # [B,Nc,H]
    h_before = []
    for c in range(Nc):
        h_before.append(h)                               # state BEFORE chunk
        h = h * chunk_decay[:, c, :, None, None] + S_c[:, c]
    h_before = torch.stack(h_before, dim=1)              # [B,Nc,H,P,N]

    in_decay = torch.exp(seg)
    y_inter = torch.einsum("bcihn,bchpn->bcihp", Cc * in_decay[..., None],
                           h_before)
    y = (y_intra + y_inter).reshape(B_, S, H, P)
    return y.to(x.dtype), h


def ssd_reference(x, dt, A, Bm, Cm, h0=None):
    """O(S) sequential-scan oracle for ssd_chunked (tests)."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=2).float()
    Ch = Cm.repeat_interleave(rep, dim=2).float()
    a = dt.float() * A.float()[None, None, :]
    h = (torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        h = h * torch.exp(a[:, t])[:, :, None, None] + (
            dt[:, t].float()[:, :, None, None] * x[:, t].float()[..., None]
            * Bh[:, t][:, :, None, :])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


# ---------------------------------------------------------------------------
# layer apply: full-sequence (prefill) and one-token decode
# ---------------------------------------------------------------------------
def _project(p: Params, x, cdt):
    return (x @ p["wz"].to(cdt), x @ p["wx"].to(cdt), x @ p["wbc"].to(cdt),
            x @ p["wdt"].to(cdt))


def _shift_reg(prev, cur, K: int):
    """The last K-1 rows of ``prev ++ cur`` (``prev`` None: zeros)."""
    if prev is None:
        prev = torch.zeros((cur.shape[0], K - 1, cur.shape[-1]),
                           dtype=cur.dtype, device=cur.device)
    return torch.cat([prev.to(cur.dtype), cur], dim=1)[:, -(K - 1):, :]


def sharded_rmsnorm(x, scale, n: int, part, eps: float = 1e-5):
    """:func:`~repro_torch.models.layers.rmsnorm` over a dimension of ``n``
    whose block ``x [..., n / m]`` (and ``scale``'s) this participant
    holds: each block's mean of squares, weighted by its share of ``n``,
    summed over ``"model"`` (its gradient too) before the ``rsqrt``.  On a
    mesh of one shard the weight is 1 and the result ``rmsnorm``'s
    bits."""
    dtype = x.dtype
    x = x.float()
    var = sum_over_model(x.square().mean(dim=-1, keepdim=True)
                         * (x.shape[-1] / n), part)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


def channel_block(cfg, part) -> tuple[int, int, int, int]:
    """``(c0, c1, h0, h1)``: ``part``'s block ``[c0, c1)`` of ``d_inner``
    (``part.block``, as ``shard_tree`` cuts ``wx``) and the SSD heads
    ``[h0, h1)`` its channels touch."""
    P = cfg.ssm_head_dim
    c0, c1 = part.block(cfg.d_inner)
    if c0 == c1:
        raise NotImplementedError(f"an empty block of d_inner "
                                  f"{cfg.d_inner} on a model axis of "
                                  f"{part.m}")
    return c0, c1, c0 // P, -(-c1 // P)


def slot_offset(c0: int, P: int) -> int:
    """Where a block of channels starting at ``c0`` begins in its first
    head slot of ``P`` channels."""
    return c0 % P


def _to_slots(t, off: int, width: int):
    """A block of channels ``t [..., n]`` at ``off`` in ``width`` channels,
    zeros around it (``t`` itself where it fills them)."""
    n = t.shape[-1]
    if off == 0 and n == width:
        return t
    return F.pad(t, (off, width - off - n))


def _from_slots(t, off: int, n: int):
    """The ``n`` channels at ``off`` of ``t [..., width]`` (``t`` itself
    where they are all of it)."""
    if off == 0 and n == t.shape[-1]:
        return t
    return t[..., off:off + n]


def _gather_state(h, off: int, n: int, part):
    """The whole SSD state ``[B, H, P, N]`` from every model participant's
    ``n`` channels at ``off`` of its slot state ``h [B, nh, P, N]``: one
    all-gather over ``"model"``, the blocks in model order."""
    B, nh, P, N = h.shape
    mine = h.reshape(B, nh * P, N)[:, off:off + n]
    blocks = part.all_gather_model(mine.contiguous())
    whole = torch.cat(list(blocks.unbind(0)), dim=1)
    return whole.reshape(B, -1, P, N)


def _local_groups(cfg, h0: int, h1: int) -> tuple[int, int]:
    """``(g0, g1)``: the B/C groups the heads ``[h0, h1)`` read.  Raises
    where those heads take part of a group and another participant's the
    rest unevenly."""
    rep = cfg.ssm_heads // cfg.ssm_groups
    g0, g1 = h0 // rep, (h1 - 1) // rep + 1
    if not (g1 - g0 == 1 or (h0 % rep == 0 and (h1 - h0) % rep == 0)):
        raise NotImplementedError(
            f"heads {h0}..{h1} split a group of {rep} heads sharing B/C")
    return g0, g1


def _ssm_sharded(p: Params, x, cfg, part, return_state: bool = False):
    """The full-sequence mixer over ``part``'s block of channels (module
    doc); with ``return_state``, also the state after the last step as the
    cache keeps it (its ``ssm`` gathered whole where the heads do not
    divide the model axis)."""
    B, S, _ = x.shape
    P, G, N = cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    c0, c1, h0, h1 = channel_block(cfg, part)
    g0, g1 = _local_groups(cfg, h0, h1)
    nh, n, off = h1 - h0, c1 - c0, slot_offset(c0, P)
    x = enter_model_region(x, part)
    cdt = x.dtype
    z = x @ p["wz"].to(cdt)
    xr = x @ p["wx"].to(cdt)
    gn = G * N
    bc_cols = torch.cat([torch.arange(g0 * N, g1 * N),
                         gn + torch.arange(g0 * N, g1 * N)]).to(x.device)
    bc = x @ p["wbc"][:, bc_cols].to(cdt)
    dt = x @ p["wdt"][:, h0:h1].to(cdt)
    xc = F.silu(causal_conv1d(xr, p["conv_x_w"], p["conv_x_b"]))
    bcc = F.silu(causal_conv1d(bc, p["conv_bc_w"][:, bc_cols],
                               p["conv_bc_b"][bc_cols]))
    gl = (g1 - g0) * N
    xs = _to_slots(xc, off, nh * P).reshape(B, S, nh, P)
    Bm = bcc[..., :gl].reshape(B, S, g1 - g0, N)
    Cm = bcc[..., gl:].reshape(B, S, g1 - g0, N)
    dt = F.softplus(dt.float() + p["dt_bias"][h0:h1].float())
    A = -torch.exp(p["A_log"][h0:h1].float())
    chunked = ops.ssd_chunked_cuda if cfg.ssm_impl == "cuda" else ssd_chunked
    y, h_final = chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + p["D"][h0:h1].to(cdt)[None, None, :, None] * xs
    y = _from_slots(y.reshape(B, S, nh * P), off, n)
    y = sharded_rmsnorm(y * F.silu(z), p["inner_norm"], cfg.d_inner, part,
                        cfg.norm_eps)
    out = leave_model_region_product(torch.matmul, part, y,
                                     p["out_proj"].to(cdt))
    if not return_state:
        return out
    if cfg.ssm_heads % part.m:
        h_final = _gather_state(h_final, off, n, part)
    K = cfg.ssm_conv
    # conv_bc's state is every B/C column: bc is that where this
    # participant reads every group, else the last K-1 steps' projection
    bc_all = bc if g1 - g0 == G else x[:, -(K - 1):] @ p["wbc"].to(cdt)
    return out, SsmState(conv_x=_shift_reg(None, xr, K),
                         conv_bc=_shift_reg(None, bc_all, K), ssm=h_final)


def ssm_apply(p: Params, x, cfg, state: SsmState | None = None,
              return_state: bool = False, part=None):
    """Full-sequence mixer. x: [B, S, d] → [B, S, d] (and the state after
    the last step when ``return_state``).  A_log, dt_bias and inner_norm
    are read in float32, as the reference reads them.  With ``part``, over
    its heads (module doc; no state in, its block of the state out)."""
    if part is not None:
        if state is not None:
            raise NotImplementedError("the sharded mixer starts from no "
                                      "state")
        return _ssm_sharded(p, x, cfg, part, return_state)
    B, S, _ = x.shape
    cdt = x.dtype
    z, xr, bc, dt = _project(p, x, cdt)
    xc = F.silu(causal_conv1d(xr, p["conv_x_w"], p["conv_x_b"],
                              prepend=None if state is None else state.conv_x))
    bcc = F.silu(causal_conv1d(bc, p["conv_bc_w"], p["conv_bc_b"],
                               prepend=None if state is None else state.conv_bc))
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    xs = xc.reshape(B, S, cfg.ssm_heads, cfg.ssm_head_dim)
    Bm = bcc[..., :gn].reshape(B, S, cfg.ssm_groups, cfg.ssm_state)
    Cm = bcc[..., gn:].reshape(B, S, cfg.ssm_groups, cfg.ssm_state)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    chunked = ops.ssd_chunked_cuda if cfg.ssm_impl == "cuda" else ssd_chunked
    y, h_final = chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk,
                         h0=None if state is None else state.ssm)
    y = y + p["D"].to(cdt)[None, None, :, None] * xs
    y = y.reshape(B, S, di)
    y = rmsnorm(y * F.silu(z), p["inner_norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(cdt)
    if not return_state:
        return out
    K = cfg.ssm_conv
    return out, SsmState(
        conv_x=_shift_reg(None if state is None else state.conv_x, xr, K),
        conv_bc=_shift_reg(None if state is None else state.conv_bc, bc, K),
        ssm=h_final,
    )


def ssm_decode(p: Params, x, cfg, state: SsmState, part=None):
    """One-token recurrent step. x: [B, 1, d] → (out [B, 1, d], new state);
    ``state`` is not modified.  With ``part``, over its heads and its
    block of the state (:func:`_ssm_decode_sharded`)."""
    if part is not None:
        return _ssm_decode_sharded(p, x, cfg, state, part)
    B = x.shape[0]
    cdt = x.dtype
    z, xr, bc, dt = _project(p, x, cdt)                  # [B, 1, *]
    win_x = torch.cat([state.conv_x.to(cdt), xr], dim=1)    # [B, K, di]
    win_bc = torch.cat([state.conv_bc.to(cdt), bc], dim=1)  # [B, K, 2gn]
    xc = F.silu(torch.einsum("bkc,kc->bc", win_x, p["conv_x_w"].to(cdt))
                + p["conv_x_b"].to(cdt))
    bcc = F.silu(torch.einsum("bkc,kc->bc", win_bc, p["conv_bc_w"].to(cdt))
                 + p["conv_bc_b"].to(cdt))
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    xs = xc.reshape(B, cfg.ssm_heads, cfg.ssm_head_dim)
    Bm = bcc[..., :gn].reshape(B, cfg.ssm_groups, cfg.ssm_state)
    Cm = bcc[..., gn:].reshape(B, cfg.ssm_groups, cfg.ssm_state)
    rep = cfg.ssm_heads // cfg.ssm_groups
    Bh = Bm.repeat_interleave(rep, dim=1).float()
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    dt = F.softplus(dt[:, 0, :].float() + p["dt_bias"].float())    # [B, H]
    A = -torch.exp(p["A_log"].float())
    h = state.ssm.float()
    h = h * torch.exp(dt * A[None, :])[:, :, None, None] + (
        dt[:, :, None, None] * xs.float()[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhn,bhpn->bhp", Ch, h).to(cdt)
    y = y + p["D"].to(cdt)[None, :, None] * xs
    y = y.reshape(B, 1, di)
    y = rmsnorm(y * F.silu(z), p["inner_norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(cdt)
    return out, SsmState(conv_x=win_x[:, 1:, :], conv_bc=win_bc[:, 1:, :],
                         ssm=h)


def _ssm_decode_sharded(p: Params, x, cfg, state: SsmState, part):
    """:func:`ssm_decode` over ``part``'s block of channels (module doc):
    its ``conv_x`` columns laid into its heads' slots and those heads'
    ``dt``, ``A``, ``D`` and ``dt_bias``; the B/C window whole (its state
    is replicated) and the groups its heads read; the state of its heads
    (its block of it, or those heads of the whole state, whose foreign
    channels it updates but never reads back), its channels of the new
    state all-gathered over ``"model"`` into the whole one where the heads
    do not divide the model axis; ``inner_norm`` through
    :func:`sharded_rmsnorm`; then ``out_proj``'s rows, summed over
    ``"model"``."""
    B = x.shape[0]
    P, G, N = cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    c0, c1, h0, h1 = channel_block(cfg, part)
    g0, g1 = _local_groups(cfg, h0, h1)
    nh, n, off = h1 - h0, c1 - c0, slot_offset(c0, P)
    whole = cfg.ssm_heads % part.m != 0
    x = enter_model_region(x, part)
    cdt = x.dtype
    z = x @ p["wz"].to(cdt)
    xr = x @ p["wx"].to(cdt)
    bc = x @ p["wbc"].to(cdt)
    dt = x @ p["wdt"][:, h0:h1].to(cdt)
    win_x = torch.cat([state.conv_x.to(cdt), xr], dim=1)
    win_bc = torch.cat([state.conv_bc.to(cdt), bc], dim=1)
    xc = F.silu(torch.einsum("bkc,kc->bc", win_x, p["conv_x_w"].to(cdt))
                + p["conv_x_b"].to(cdt))
    bcc = F.silu(torch.einsum("bkc,kc->bc", win_bc, p["conv_bc_w"].to(cdt))
                 + p["conv_bc_b"].to(cdt))
    gn = G * N
    xs = _to_slots(xc, off, nh * P).reshape(B, nh, P)
    Bm = bcc[..., g0 * N:g1 * N].reshape(B, g1 - g0, N)
    Cm = bcc[..., gn + g0 * N:gn + g1 * N].reshape(B, g1 - g0, N)
    rep = nh // (g1 - g0)
    Bh = Bm.repeat_interleave(rep, dim=1).float()
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    dt = F.softplus(dt[:, 0, :].float() + p["dt_bias"][h0:h1].float())
    A = -torch.exp(p["A_log"][h0:h1].float())
    h = (state.ssm[:, h0:h1] if whole else state.ssm).float()
    h = h * torch.exp(dt * A[None, :])[:, :, None, None] + (
        dt[:, :, None, None] * xs.float()[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhn,bhpn->bhp", Ch, h).to(cdt)
    y = y + p["D"][h0:h1].to(cdt)[None, :, None] * xs
    y = _from_slots(y.reshape(B, nh * P), off, n).reshape(B, 1, n)
    y = sharded_rmsnorm(y * F.silu(z), p["inner_norm"], cfg.d_inner, part,
                        cfg.norm_eps)
    out = leave_model_region_product(torch.matmul, part, y,
                                     p["out_proj"].to(cdt))
    if whole:
        h = _gather_state(h, off, n, part)
    return out, SsmState(conv_x=win_x[:, 1:, :], conv_bc=win_bc[:, 1:, :],
                         ssm=h)
