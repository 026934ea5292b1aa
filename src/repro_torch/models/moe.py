"""Mixture-of-Experts layer: top-k router + expert SwiGLU FFNs.

The JAX package's ``models/moe.py`` over PyTorch tensors, with one more
execution path.  ``cfg.moe_impl`` picks it:

- ``gmm`` (the port's default): rows sorted by expert, then the expert FFN
  as three launches of the hand-written grouped-matmul kernel
  (:func:`repro_torch.kernels.ops.moe_gmm_ffn`).  The group sizes stay on
  the device: nothing on this path reads them on the host.
- ``ragged`` (the reference's default): the same sort, then one plain
  ``torch.matmul`` per expert — the reference's ``jax.lax.ragged_dot``;
  it reads the group sizes on the host.
- ``dense``: every expert processes every token, combined by routing
  weight (E/k the FLOPs).
- ``gathered``: each token gathers its k experts' weights (tiny batches).
- ``ep``: expert parallelism over the mesh's ``model`` axis
  (:mod:`repro_torch.parallel.ep_moe`): capacity-packed dispatch, each
  shard's experts through the grouped-matmul kernel.  Without ``part``
  over the mesh published with ``ep_moe.set_mesh`` (every shard in this
  process, or one a rank given the whole batch); with ``part``, one
  participant of the sharded model (below).

Each returns ``(output, MoeAux)``: the load-balancing and router-z losses
and the expert load vector, as the reference computes them.

Given a :class:`~repro_torch.parallel.tensor.Participant` (``part``),
``gmm`` and ``ragged`` run its block of the experts (``[E@model, ...]``)
inside a model region: the router is replicated, so every model
participant routes all ``T·k`` slots alike; each keeps the slots of its
``E / m`` experts, runs the expert FFN over them (three K5 launches on
``gmm``) and combines them by routing weight into a partial output that
:func:`~repro_torch.parallel.tensor.leave_model_region` sums.  The aux
terms come from the replicated router, equal on every model participant:
their load is the mean over the data axes (the reference's global batch)
and their gradient is taken on model participant 0 alone, so that the
sum of the router's partial gradients over ``"model"`` counts it once.
``ep`` runs the reference's ``shard_map`` body on the participant's
sequence block of its rows and its block of the experts
(:func:`~repro_torch.parallel.ep_moe.ep_moe_apply_sharded`): each model
participant routes other tokens, so its aux terms are means over the
whole mesh whose gradient it takes a ``1 / m`` share of, on every
participant (:func:`~repro_torch.parallel.tensor.mean_over_mesh`).

:func:`routing_hook` lets a caller see every routing decision and replace
it, to hold two runs to one routing (top-k is discontinuous: two runs that
differ only by rounding pick other experts wherever two router
probabilities nearly tie).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.moe_gmm import grouped_matmul_torch
from ..parallel.tensor import enter_model_region, leave_model_region_product
from .layers import _kept, _normal, dtype_of

Params = dict[str, Any]


class MoeAux(NamedTuple):
    load_balance_loss: torch.Tensor   # scalar
    router_z_loss: torch.Tensor       # scalar
    expert_load: torch.Tensor         # [E] fraction of routed (token, k) slots


def moe_shapes(cfg) -> dict[str, tuple]:
    E, d, ffe = cfg.moe_experts, cfg.d_model, cfg.expert_d_ff
    return {"norm_scale": (d,), "router": (d, E), "w_gate": (E, d, ffe),
            "w_up": (E, d, ffe), "w_down": (E, ffe, d)}


def moe_init(gen, cfg, n_blocks: int, device, leaf=_kept) -> Params:
    """Parameters of ``n_blocks`` MoE layers, stacked on axis 0: N(0, 0.02)
    weights and unit norm scales, as the reference draws them (each
    through ``leaf``, as ``layers.attention_init``)."""
    pdt = dtype_of(cfg.param_dtype)
    p: Params = {}
    for name, shape in moe_shapes(cfg).items():
        shape = (n_blocks, *shape)
        if name == "norm_scale":
            t = torch.ones(shape, dtype=pdt, device=device)
        else:
            t = _normal(gen, shape, 0.02, pdt, device)
        p[name] = leaf(name, t)
    return p


#: ``fn(probs [T, E] float32, experts [T, k]) -> experts [T, k]`` or None;
#: set by :func:`routing_hook`.
_routing_hook: Callable | None = None


@contextlib.contextmanager
def routing_hook(fn: Callable):
    """Inside the block every router call passes ``fn`` its probabilities
    and its own top-k experts, in call order, and routes to the experts
    ``fn`` returns, weighted by their renormalised probabilities.  ``fn``
    may keep what it is given (to record a run) or return other experts
    (to replay one).  Without a hook, routing is the reference's."""
    global _routing_hook
    prev, _routing_hook = _routing_hook, fn
    try:
        yield
    finally:
        _routing_hook = prev


def _router(p: Params, x2d: torch.Tensor, cfg):
    """Router logits and probabilities ``[T, E]`` (float32), top-k expert
    ids ``[T, k]`` (through :func:`routing_hook`) and their renormalised
    weights ``[T, k]``.  x2d: ``[T, d]``."""
    logits = (x2d @ p["router"].to(x2d.dtype)).float()          # [T, E]
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, cfg.moe_top_k, dim=-1)
    if _routing_hook is not None:
        experts = _routing_hook(probs, experts)
        weights = probs.gather(-1, experts)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, experts, weights


def _route(p: Params, x2d: torch.Tensor, cfg, part=None):
    """Router: top-k expert ids ``[T, k]`` and renormalised weights
    ``[T, k]`` (float32), and the aux losses.  x2d: ``[T, d]``.  With
    ``part``, the load is the mean over the data axes (where the rows are
    split over them), ``lb`` this data participant's part of the whole
    batch's (their mean is it), and the aux losses carry no gradient off
    model participant 0."""
    logits, probs, experts, weights = _router(p, x2d, cfg)
    E = cfg.moe_experts
    onehot = F.one_hot(experts, E).float()                      # [T, k, E]
    load = onehot.sum(dim=(0, 1)) / onehot.sum().clamp_min(1.0)
    if part is not None and part.rows_split:
        load = part.pmean_dp(load)
    importance = probs.mean(dim=0)
    lb = E * torch.sum(load * importance)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    if part is not None and part.mi != 0:
        lb, z = lb.detach(), z.detach()
    return experts, weights, MoeAux(lb, z, load)


def _ragged_ffn(p: Params, xs, group_sizes, cdt):
    """The reference's ``_ragged_ffn``: one plain product per expert."""
    g = grouped_matmul_torch(xs, p["w_gate"].to(cdt), group_sizes)
    u = grouped_matmul_torch(xs, p["w_up"].to(cdt), group_sizes)
    return grouped_matmul_torch(F.silu(g) * u, p["w_down"].to(cdt),
                                group_sizes)


def _gmm_ffn(p: Params, xs, group_sizes, cdt):
    return ops.moe_gmm_ffn(xs, group_sizes, p["w_gate"].to(cdt),
                           p["w_up"].to(cdt), p["w_down"].to(cdt))


def _sorted_apply(p: Params, x, cfg, ffn, part=None):
    """Token-sorted MoE: route, sort the ``T·k`` routed slots by expert
    (stable, as ``jnp.argsort``), run ``ffn`` over the sorted rows, put the
    rows back and combine them by routing weight.  With ``part``, over
    its experts' slots (module doc)."""
    if part is not None:
        return _sorted_apply_local(p, x, cfg, ffn, part)
    shape = x.shape
    d = shape[-1]
    x2d = x.reshape(-1, d)
    T, k = x2d.shape[0], cfg.moe_top_k
    experts, weights, aux = _route(p, x2d, cfg)
    flat_expert = experts.reshape(T * k)
    order = torch.argsort(flat_expert, stable=True)
    xs = x2d[order // k]                                    # [T·k, d] sorted
    # torch.bincount(minlength=E), counted without it: on CUDA bincount
    # reads the largest id on the host to size its output.
    group_sizes = torch.zeros(cfg.moe_experts, dtype=torch.int64,
                              device=x.device).index_add_(
        0, flat_expert, torch.ones_like(flat_expert))
    ys = ffn(p, xs, group_sizes, x.dtype)
    out_rows = torch.empty_like(ys)
    out_rows[order] = ys                                    # back to (t, k)
    out = torch.einsum("tkd,tk->td", out_rows.reshape(T, k, d),
                       weights.to(x.dtype))
    return out.reshape(shape), aux


def _sorted_apply_local(p: Params, x, cfg, ffn, part):
    """:func:`_sorted_apply` over ``part``'s experts ``[e0, e1)``: the
    slots routed to them, sorted by expert, and the rest dropped.  Their
    count is read on the host (one read a layer; :func:`local_rows`): the
    kernel's rows are the sum of its groups.  The combine's partial is
    summed over ``"model"`` by
    :func:`~repro_torch.parallel.tensor.leave_model_region_product`.
    The prefill and every decode step of sharded serving run here too; a
    step routes few slots (granite-moe: 64 over
    32 experts), so a participant may hold none, and the grouped-matmul
    kernel does not launch on zero rows: ``gmm`` launches it three times
    in each layer whose local row count is non-zero, and not at all in
    the others."""
    x = enter_model_region(x, part)
    shape = x.shape
    d = shape[-1]
    x2d = x.reshape(-1, d)
    T, k = x2d.shape[0], cfg.moe_top_k
    experts, weights, aux = _route(p, x2d, cfg, part)
    e0, e1 = part.block(cfg.moe_experts)
    flat = experts.reshape(T * k)
    mine = (flat >= e0) & (flat < e1)
    key = torch.where(mine, flat - e0, e1 - e0)             # others last
    order = torch.argsort(key, stable=True)[:local_rows(
        mine, T * k, e1 - e0, cfg.moe_experts)]
    group_sizes = torch.zeros(e1 - e0, dtype=torch.int64,
                              device=x.device).index_add_(
        0, key[order], torch.ones_like(order))
    ys = ffn(p, x2d[order // k], group_sizes, x.dtype)
    out_rows = torch.zeros((T * k, d), dtype=ys.dtype, device=x.device)
    out_rows[order] = ys
    out = leave_model_region_product(
        lambda r, w: torch.einsum("tkd,tk->td", r, w), part,
        out_rows.reshape(T, k, d), weights.to(x.dtype))
    return out.reshape(shape), aux


def local_rows(mine: torch.Tensor, slots: int, local_experts: int,
               experts: int) -> int:
    """The count of routed slots a participant's experts take: read on the
    host from ``mine``, or, where it lies on ``meta`` (the dry run, which
    holds no routing), the participant's even share of the ``slots``,
    ``ceil(slots · local_experts / experts)``.  The collectives do not
    depend on it: the region end sums ``[T, d]``."""
    if mine.device.type == "meta":
        return -(-slots * local_experts // experts)
    return int(mine.sum())


def moe_apply_ragged(p: Params, x, cfg):
    """Token-sorted grouped-matmul MoE, plain products. x: [B, S, d]."""
    return _sorted_apply(p, x, cfg, _ragged_ffn)


def moe_apply_gmm(p: Params, x, cfg):
    """Token-sorted MoE through the grouped-matmul kernel (three launches;
    no host read of the group sizes)."""
    return _sorted_apply(p, x, cfg, _gmm_ffn)


def moe_apply_dense(p: Params, x, cfg):
    """All-experts dense MoE (E/k FLOPs inflation)."""
    shape = x.shape
    d = shape[-1]
    x2d = x.reshape(-1, d)
    T = x2d.shape[0]
    experts, weights, aux = _route(p, x2d, cfg)
    cdt = x.dtype
    comb = torch.zeros((T, cfg.moe_experts), dtype=torch.float32,
                       device=x.device)
    comb.scatter_add_(1, experts, weights)
    g = torch.einsum("td,edf->tef", x2d, p["w_gate"].to(cdt))
    u = torch.einsum("td,edf->tef", x2d, p["w_up"].to(cdt))
    y = torch.einsum("tef,efd->ted", F.silu(g) * u, p["w_down"].to(cdt))
    out = torch.einsum("ted,te->td", y, comb.to(cdt))
    return out.reshape(shape), aux


def moe_apply_gathered(p: Params, x, cfg):
    """Tiny-batch decode path: gather only the top-k experts' weights."""
    shape = x.shape
    d = shape[-1]
    x2d = x.reshape(-1, d)
    experts, weights, aux = _route(p, x2d, cfg)          # [T, k]
    cdt = x.dtype
    wg = p["w_gate"].to(cdt)[experts]                    # [T, k, d, f]
    wu = p["w_up"].to(cdt)[experts]
    wd = p["w_down"].to(cdt)[experts]                    # [T, k, f, d]
    g = torch.einsum("td,tkdf->tkf", x2d, wg)
    u = torch.einsum("td,tkdf->tkf", x2d, wu)
    y = torch.einsum("tkf,tkfd->tkd", F.silu(g) * u, wd)
    out = torch.einsum("tkd,tk->td", y, weights.to(cdt))
    return out.reshape(shape), aux


_BY_IMPL = {"gmm": moe_apply_gmm, "ragged": moe_apply_ragged,
            "dense": moe_apply_dense, "gathered": moe_apply_gathered}


def check_part(cfg, part, seq_len: int) -> None:
    """Raise ``ValueError`` where ``part`` cannot run ``cfg``'s ``ep`` MoE
    layers on rows of ``seq_len`` positions
    (:func:`~repro_torch.parallel.ep_moe.check_sharded`); nothing for the
    other forms.  The model calls it before its first collective."""
    if cfg.moe_experts and cfg.moe_impl == "ep":
        from ..parallel.ep_moe import check_sharded

        check_sharded(cfg, part, seq_len)


def moe_apply(p: Params, x, cfg, part=None):
    if part is not None:
        if cfg.moe_impl == "ep":
            from ..parallel.ep_moe import ep_moe_apply_sharded

            return ep_moe_apply_sharded(p, x, cfg, part)
        if cfg.moe_impl not in ("gmm", "ragged"):
            raise NotImplementedError(
                f"moe_impl={cfg.moe_impl!r} does not run on a participant's "
                "experts: the sharded layers take 'gmm', 'ragged' or 'ep'")
        ffn = _gmm_ffn if cfg.moe_impl == "gmm" else _ragged_ffn
        return _sorted_apply(p, x, cfg, ffn, part)
    if cfg.moe_impl == "ep":
        from ..parallel.ep_moe import ep_moe_apply

        return ep_moe_apply(p, x, cfg)
    return _BY_IMPL[cfg.moe_impl](p, x, cfg)

