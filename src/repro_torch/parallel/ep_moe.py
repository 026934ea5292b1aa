"""Expert parallelism: the MoE layer with capacity-based all_to_all dispatch.

The JAX package's ``parallel/ep_moe.py`` runs this under ``shard_map``:
experts live on the ``model`` axis, tokens are sequence-sharded into the
block, and dispatch is the GShard/Switch capacity all_to_all.  The port
runs each shard's body, the reference's, in two forms:

- :func:`ep_moe_apply`, the unsharded model's layer (``moe_impl="ep"``
  without ``shards=``): it reads the mesh the caller published with
  :func:`set_mesh` (:func:`get_shards`) and is given the whole ``[B, S,
  d]`` and the whole weights.  With a bare ``Mesh`` every shard runs in
  this process, a list on one device; with a ``DeviceMesh`` each rank runs
  its own and the collectives cross processes
  (:mod:`repro_torch.parallel.dist`).  The output is all-gathered over
  the data axes and ``"model"``, so every shard holds the whole ``[B, S,
  d]``, as GSPMD holds it outside the reference's ``shard_map``.
- :func:`ep_moe_apply_sharded`, the sharded model's layer
  (``Model.loss`` / ``forward`` / ``prefill`` with ``shards=``): one
  participant, the :class:`~repro_torch.parallel.tensor.Participant`
  passed down with ``part``, on its data block of the rows ``[b, S, d]``
  (replicated over ``"model"``) and its block ``[E@model, ...]`` of the
  experts that ``shard_tree`` cut.  It reads no published mesh.  It enters
  its sequence block and leaves by an all-gather over ``"model"`` only
  (``parallel/tensor.py``: ``enter_sequence_block`` /
  ``leave_sequence_block``), and its all_to_alls carry a gradient.

Each shard's body:

  1. route locally (the port's ``moe._router``, so ``moe.routing_hook``
     sees one call per held shard per layer, in shard order),
  2. pack per-destination send buffers ``[M, cap, d]`` (capacity ``cap``,
     overflow dropped in the reference's stable argsort / searchsorted
     order; the dropped slots are not renormalised away),
  3. all_to_all over the model axis (rows, local expert ids, valid flags),
  4. the shard's ``E/M`` experts through the grouped-matmul kernel (K5,
     ``moe._gmm_ffn``), invalid slots as zero rows in the last local
     group, as the reference lays them out,
  5. all_to_all back, and the weighted combine at the source.

The reference scatters every sorted entry into the send buffer, dropped
ones at slot 0 of their destination with a zero row and ``valid =
False``; XLA applies duplicate scatter indices in order, so where a
destination overflows, its slot 0 ends up invalid and the entry kept
there contributes nothing.  The port computes that outcome without a
scatter of duplicates: such a first entry is dropped too.

``MoeAux`` is formed with the reference's psum / pmean over the model and
data axes.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F

from ..models import moe as _moe
from .collectives import Shards, shards
from .sharding import dp_axes, dp_size
from .tensor import (
    Participant,
    all_to_all_model,
    enter_sequence_block,
    leave_sequence_block,
    mean_over_mesh,
)

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


def _expert_ffn(local, recv_x, recv_exp, recv_valid, e_local: int):
    """Step 4 on the ``M · cap`` rows a shard received: its ``e_local``
    experts' FFN (``local``: their weights) over them, invalid rows as
    zeros in the last local group."""
    eid = torch.where(recv_valid, recv_exp, e_local - 1)
    r_order = torch.argsort(eid, stable=True)
    xr = torch.where(recv_valid[r_order, None], recv_x[r_order], 0)
    sizes = torch.zeros(e_local, dtype=torch.int64, device=xr.device)
    sizes.index_add_(0, eid, torch.ones_like(eid))
    yr = _moe._gmm_ffn(local, xr, sizes, xr.dtype)
    y_back = torch.empty_like(yr)
    y_back[r_order] = yr
    return y_back


def _shard_experts(pw, x_rows, exp_rows, valid_rows, shard: int,
                   e_local: int):
    """:func:`_expert_ffn` of shard ``shard`` on the blocks it received
    (one from each shard), its experts sliced from the whole weights."""
    lo, hi = shard * e_local, (shard + 1) * e_local
    local = {n: pw[n][lo:hi] for n in ("w_gate", "w_up", "w_down")}
    return _expert_ffn(local, torch.cat(x_rows), torch.cat(exp_rows),
                       torch.cat(valid_rows), e_local)


def _combine(back, combine, k: int, dtype) -> torch.Tensor:
    """Step 5 at the source: ``[t_loc, d]`` from the ``[M * cap, d]`` rows
    that came back (a block from each shard) and the shard's dispatch
    plan."""
    order, keep, slot, weights = combine
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
    ys = [_combine(torch.cat(back), c, k, x.dtype).view(b, S // M, d)
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


def check_sharded(cfg, part: Participant, seq_len: int) -> None:
    """Raise ``ValueError`` where :func:`ep_moe_apply_sharded` cannot run
    ``part``'s rows of ``seq_len`` positions, as the reference asserts
    (``E`` or ``S`` not a multiple of the model axis; a decode step's one
    position at a model axis above one), and where the participant holds
    every row (the fully-seq layout: the reference's ``P(dp, ...)`` needs
    the batch split over the data axes).  The model calls it before its
    first collective, so every rank raises and none waits."""
    M, E = part.m, cfg.moe_experts
    if E % M or seq_len % M or not part.rows_split:
        raise ValueError(
            f"expert parallelism over {M} model participants needs E ({E}) "
            f"and S ({seq_len}) multiples of {M} and the rows split over "
            f"the data axes ({'split' if part.rows_split else 'whole'})")


def ep_moe_apply_sharded(p, x, cfg, part: Participant,
                         capacity_factor: float = 1.25):
    """The sharded model's ep layer on participant ``part`` (module doc):
    ``x [b, S, d]`` its rows, replicated over ``"model"``; ``p`` its block
    of the experts ``[E / M, ...]`` and the replicated router.  Returns
    ``(y [b, S, d], MoeAux)`` like ``moe.moe_apply``, ``y`` replicated
    over ``"model"`` and the aux terms the whole batch's, the same on
    every participant.  The router's gradient is partial over
    ``"model"`` (the participant's block of the tokens), the aux terms'
    included (:func:`~repro_torch.parallel.tensor.mean_over_mesh`)."""
    check_sharded(cfg, part, x.shape[1])
    M, E, k = part.m, cfg.moe_experts, cfg.moe_top_k
    b, S, d = x.shape
    e_local = E // M
    cap = capacity(b * S // M, k, M, capacity_factor)
    xt = enter_sequence_block(x, part).reshape(-1, d)
    (send_x, send_exp, send_valid), combine, stats = _shard_dispatch(
        p, xt, cfg, M, cap)
    recv_x = all_to_all_model(send_x, part)
    recv_exp = part.all_to_all_model(send_exp)
    recv_valid = part.all_to_all_model(send_valid)
    y_back = _expert_ffn(p, recv_x.reshape(M * cap, d),
                         recv_exp.reshape(-1), recv_valid.reshape(-1),
                         e_local)
    back = all_to_all_model(y_back.view(M, cap, d), part)
    y = _combine(back.reshape(M * cap, d), combine, k, x.dtype)
    y = leave_sequence_block(y.view(b, S // M, d), part)
    load = part.psum_mesh(stats["load"])
    load = load / load.sum().clamp_min(1.0)
    importance = mean_over_mesh(stats["importance"], part)
    lb = E * torch.sum(load * importance)
    z = mean_over_mesh(stats["z"], part)
    return y, _moe.MoeAux(lb, z, load)
