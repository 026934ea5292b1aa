"""Expert parallelism: the MoE layer with capacity-based all_to_all dispatch.

The JAX package's ``parallel/ep_moe.py`` runs this under ``shard_map``:
experts live on the ``model`` axis, tokens are sequence-sharded into the
block, and dispatch is the GShard/Switch capacity all_to_all.  Here the
shards are a :class:`~repro_torch.parallel.collectives.Shards`: with a bare
``Mesh`` published (:func:`set_mesh`) every shard runs in this process, a
list on one device; with a ``DeviceMesh`` each rank runs its own, and the
collectives cross processes (:mod:`repro_torch.parallel.dist`).  Both run
each shard's body, the reference's:

  1. route locally (the port's ``moe._router``, so ``moe.routing_hook``
     sees one call per held shard per layer, in shard order),
  2. pack per-destination send buffers ``[M, cap, d]`` (capacity ``cap``,
     overflow dropped in the reference's stable argsort / searchsorted
     order; the dropped slots are not renormalised away),
  3. all_to_all over the model axis (rows, local expert ids, valid flags),
  4. the shard's ``E/M`` experts through the grouped-matmul kernel (K5,
     ``moe._gmm_ffn``) on views of their weight slices, invalid slots as
     zero rows in the last local group, as the reference lays them out,
  5. all_to_all back, and the weighted combine at the source.

The reference scatters every sorted entry into the send buffer, dropped
ones at slot 0 of their destination with a zero row and ``valid =
False``; XLA applies duplicate scatter indices in order, so where a
destination overflows, its slot 0 ends up invalid and the entry kept
there contributes nothing.  The port computes that outcome without a
scatter of duplicates: such a first entry is dropped too.

``MoeAux`` is formed with the reference's psum / pmean over the model and
data axes.  The output is all-gathered over the same axes, so every shard
holds the whole ``[B, S, d]`` and the layers around the MoE run
replicated, as GSPMD runs them outside the reference's ``shard_map``.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F

from ..models import moe as _moe
from .collectives import Shards, shards
from .sharding import dp_axes, dp_size

# The caller publishes the mesh here before running the model (the model
# code only knows axis names), as the reference's launcher does.
_SHARDS: Shards | None = None


def set_mesh(mesh) -> None:
    """Publish what the ep layers run over: a bare ``Mesh`` (every shard
    in this process), a ``DeviceMesh`` or ``RankShards`` (this rank's
    shard), or None."""
    global _SHARDS
    _SHARDS = None if mesh is None else shards(mesh)


def get_shards() -> Shards:
    if _SHARDS is None:
        raise RuntimeError("ep_moe.set_mesh(mesh) must be called before "
                           "running an ep MoE layer")
    return _SHARDS


#: ``fn(keep [t_loc * k] bool) -> None`` or None; set by
#: :func:`dispatch_hook`.
_dispatch_hook: Callable | None = None


@contextlib.contextmanager
def dispatch_hook(fn: Callable):
    """Inside the block each held shard's dispatch passes ``fn`` its
    kept-slot mask over its ``t_loc · k`` routed slots (token-major, as
    routed), in shard order, one call per held shard per layer."""
    global _dispatch_hook
    prev, _dispatch_hook = _dispatch_hook, fn
    try:
        yield
    finally:
        _dispatch_hook = prev


def capacity(t_loc: int, k: int, M: int, capacity_factor: float) -> int:
    """Slots per destination shard, the reference's rounding."""
    return int((t_loc * k) / M * capacity_factor + 0.999)


def dispatch_plan(experts: torch.Tensor, e_local: int, M: int, cap: int):
    """The reference's packing of one shard's routed slots.  ``experts``
    ``[t_loc, k]``.  Returns ``(order, keep, slot)`` over the sorted
    slots: ``order`` the stable sort of the flat slots by destination
    shard, ``keep`` whether a sorted slot reaches its destination's buffer
    (its position within the destination below ``cap``, and not slot 0 of a
    destination that overflows: see the module's docstring), ``slot`` its
    row in the ``[M * cap]`` send buffer (meaningful where kept)."""
    flat = experts.reshape(-1)
    n = flat.numel()
    dest = flat // e_local
    order = torch.argsort(dest, stable=True)
    dest_s = dest[order]
    first = torch.searchsorted(dest_s, dest_s, side="left")
    pos = torch.arange(n, device=flat.device) - first
    count = torch.zeros(M, dtype=torch.int64, device=flat.device)
    count.index_add_(0, dest_s, torch.ones_like(dest_s))
    keep = (pos < cap) & ~((pos == 0) & (count[dest_s] > cap))
    slot = dest_s * cap + torch.where(pos < cap, pos, 0)
    return order, keep, slot


def _shard_dispatch(pw, xt, cfg, M: int, cap: int):
    """Steps 1–2 for one shard: its send blocks (rows, local expert ids,
    valid flags, ``M`` of each) and what the combine needs."""
    E, k = cfg.moe_experts, cfg.moe_top_k
    e_local = E // M
    t_loc, d = xt.shape
    logits, probs, experts, weights = _moe._router(pw, xt, cfg)
    order, keep, slot = dispatch_plan(experts, e_local, M, cap)
    if _dispatch_hook is not None:
        kept = torch.zeros_like(keep)
        kept[order] = keep
        _dispatch_hook(kept)
    exp_s, tok_s = experts.reshape(-1)[order], order // k
    # Kept slots have rows of their own; the dropped ones all go to one
    # spare row past the buffer, which is cut off (no host read of keep).
    rows = torch.where(keep, slot, M * cap)
    send_x = xt.new_zeros((M * cap + 1, d))
    send_x[rows] = xt[tok_s]
    send_exp = torch.zeros(M * cap + 1, dtype=torch.int64, device=xt.device)
    send_exp[rows] = exp_s % e_local
    send_valid = torch.zeros(M * cap + 1, dtype=torch.bool,
                             device=xt.device)
    send_valid[rows] = True
    stats = {"load": F.one_hot(experts, E).float().sum(dim=(0, 1)),
             "importance": probs.mean(dim=0),
             "z": torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))}
    combine = (order, keep, slot, weights)
    return ([t[:M * cap].view(M, cap, *t.shape[1:])
             for t in (send_x, send_exp, send_valid)], combine, stats)


def _shard_experts(pw, x_rows, exp_rows, valid_rows, shard: int,
                   e_local: int):
    """Step 4 on the rows a shard received (a block from each shard): its
    local experts' FFN over them, invalid rows as zeros in the last local
    group."""
    recv_x, recv_exp = torch.cat(x_rows), torch.cat(exp_rows)
    recv_valid = torch.cat(valid_rows)
    eid = torch.where(recv_valid, recv_exp, e_local - 1)
    r_order = torch.argsort(eid, stable=True)
    xr = torch.where(recv_valid[r_order, None], recv_x[r_order], 0)
    sizes = torch.zeros(e_local, dtype=torch.int64, device=xr.device)
    sizes.index_add_(0, eid, torch.ones_like(eid))
    lo, hi = shard * e_local, (shard + 1) * e_local
    local = {n: pw[n][lo:hi] for n in ("w_gate", "w_up", "w_down")}
    yr = _moe._gmm_ffn(local, xr, sizes, xr.dtype)
    y_back = torch.empty_like(yr)
    y_back[r_order] = yr
    return y_back


def _combine(back_rows, combine, k: int, dtype) -> torch.Tensor:
    """Step 5 at the source: ``[t_loc, d]`` from the rows that came back
    (a block from each shard) and the shard's dispatch plan."""
    order, keep, slot, weights = combine
    back = torch.cat(back_rows)                          # [M * cap, d]
    contrib = torch.where(keep[:, None], back[slot], 0)
    per_slot = torch.empty_like(contrib)
    per_slot[order] = contrib                            # token-major again
    t_loc = weights.shape[0]
    return torch.einsum("tkd,tk->td", per_slot.view(t_loc, k, -1),
                        weights.to(dtype))


def ep_moe_apply(p, x, cfg, capacity_factor: float = 1.25):
    """``x [B, S, d]``, the same on every rank: the batch split over the
    mesh's data axes, the sequence over its ``model`` axis of ``M``
    shards.  Returns ``(y, MoeAux)`` like ``moe.moe_apply``, the whole
    ``y`` on every rank.  Raises ``ValueError`` where the reference
    asserts (``E`` or ``S`` not a multiple of ``M``, or ``B`` not a
    multiple of the data-parallel size), before any collective, so every
    rank raises and none waits."""
    sh = get_shards()
    data = dp_axes(sh.mesh)
    M, dp = sh.mesh.shape["model"], dp_size(sh.mesh)
    E, k = cfg.moe_experts, cfg.moe_top_k
    B, S, d = x.shape
    if E % M or S % M or B % dp:
        raise ValueError(f"expert parallelism over {M} model shards and "
                         f"{dp} data shards needs E ({E}) and S ({S}) "
                         f"multiples of {M}, B ({B}) of {dp}")
    e_local, b = E // M, B // dp
    cap = capacity(b * S // M, k, M, capacity_factor)
    xs = [x.chunk(dp, dim=0)[i].chunk(M, dim=1)[m].reshape(-1, d)
          for i, m in zip(sh.flat_index(data), sh.index("model"))]
    sends, combines, stats = zip(*(_shard_dispatch(p, xt, cfg, M, cap)
                                   for xt in xs))
    recv = [sh.all_to_all([s[n] for s in sends], "model") for n in range(3)]
    y_back = [_shard_experts(p, recv[0][i], recv[1][i], recv[2][i], m,
                             e_local).view(M, cap, d)
              for i, m in enumerate(sh.index("model"))]
    ret = sh.all_to_all(y_back, "model")
    ys = [_combine(back, c, k, x.dtype).view(b, S // M, d)
          for back, c in zip(ret, combines)]
    axes = (*data, "model")
    y = sh.all_gather(ys, axes)[0]                       # [dp · M, b, S/M, d]
    y = y.view(dp, M, b, S // M, d).transpose(1, 2).reshape(B, S, d)
    load = sh.psum([s["load"] for s in stats], axes)[0]
    load = load / load.sum().clamp_min(1.0)
    importance = sh.pmean([s["importance"] for s in stats], axes)[0]
    lb = E * torch.sum(load * importance)
    z = sh.pmean([s["z"] for s in stats], axes)[0]
    return y, _moe.MoeAux(lb, z, load)
