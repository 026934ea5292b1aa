"""Train-step builder: forward + backward + AdamW, with optional gradient
accumulation and int8 gradient compression (error feedback).

The JAX package's ``train/step.py`` on tensors.  The gradient is
``torch.autograd.grad`` of ``model.loss`` over every parameter leaf,
without ``allow_unused``: a parameter the loss does not reach (a kernel
whose output carried no gradient, say) raises instead of training the
wrong function.  :func:`abstract_state` gives the state as ``meta``
tensors and :func:`state_shardings` its shardings on a mesh
(:mod:`repro_torch.parallel.sharding`), ZeRO-1 included.

Given the mesh's shards and those shardings, :func:`make_train_step`
builds the step that the JAX package jits with them, for one participant
of a data × model mesh, on its block of the state
(:func:`~repro_torch.parallel.sharding.shard_tree`): the collectives XLA
would insert are written out (:mod:`repro_torch.parallel.tensor` in the
model, :func:`sharded_grads` and :func:`psum_partial` here).
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import tracing, tree
from ..models.api import Model
from ..models.lm import rows_part
from ..models.moe import check_part
from ..parallel.compress import ef_compress, ef_compress_sharded, ef_init
from ..parallel.sharding import (
    NamedSharding,
    batch_specs,
    dp_axes,
    dp_size,
    entry_axes,
    param_shardings,
    shard_tree,
    spec,
)
from ..parallel.tensor import Participant, participant
from .optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_step,
    adamw_update,
    clip_by_global_norm,
)

TrainState = dict  # {"params": ..., "opt": AdamWState, ["ef": residual]}


def init_state(model: Model, generator: torch.Generator | None,
               opt_cfg: AdamWConfig, compress: bool = False, *,
               device=None) -> TrainState:
    """Fresh parameters (:meth:`Model.init`), zero AdamW moments and, with
    ``compress``, a zero error-feedback residual."""
    params = model.init(generator, device=device)
    state: TrainState = {"params": params, "opt": adamw_init(params)}
    if compress:
        state["ef"] = ef_init(params)
    return state


def abstract_state(model: Model, opt_cfg: AdamWConfig,
                   compress: bool = False) -> TrainState:
    """:func:`init_state`'s tree as ``meta`` tensors (shapes and dtypes, no
    allocation)."""
    params = model.abstract_params()

    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    state: TrainState = {"params": params, "opt": AdamWState(
        m=tree.map(f32, params), v=tree.map(f32, params),
        step=torch.empty((), dtype=torch.int32, device="meta"))}
    if compress:
        state["ef"] = tree.map(f32, params)
    return state


def state_shardings(abstract: TrainState, cfg, mesh, zero_opt: bool = False):
    """Shardings of the whole train state.

    Default: AdamW's ``m`` / ``v`` follow their parameters (sharded over
    the model axis only, replicated across data).  ``zero_opt=True`` also
    shards ``m`` / ``v`` over the data axes (ZeRO-1): each data-parallel
    rank owns a slice of the optimizer state — memory ÷ dp size, at the
    cost of a gather / scatter around the update."""
    def zero_shard(shardings, moments):
        """The dp axes on the first unsharded, divisible dim of each leaf."""
        dp, n = dp_axes(mesh), dp_size(mesh)

        def one(s: NamedSharding, leaf):
            entries = list(s.spec) + [None] * (leaf.dim() - len(s.spec))
            for i, (ax, dim) in enumerate(zip(entries, leaf.shape)):
                if ax is None and dim % n == 0 and dim > 0:
                    entries[i] = dp
                    return NamedSharding(mesh, spec(*entries))
            return s
        return tree.map(one, shardings, moments)

    m_sh = param_shardings(abstract["opt"].m, cfg, mesh)
    v_sh = param_shardings(abstract["opt"].v, cfg, mesh)
    if zero_opt:
        m_sh = zero_shard(m_sh, abstract["opt"].m)
        v_sh = zero_shard(v_sh, abstract["opt"].v)
    out: TrainState = {
        "params": param_shardings(abstract["params"], cfg, mesh),
        "opt": AdamWState(m=m_sh, v=v_sh,
                          step=NamedSharding(mesh, spec())),
    }
    if "ef" in abstract:
        out["ef"] = param_shardings(abstract["ef"], cfg, mesh)
    return out


def _microbatches(batch: dict, accum: int) -> list[dict]:
    """``batch`` split into ``accum`` microbatches along its first axis."""
    return [{k: v.reshape((accum, v.shape[0] // accum)
                          + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(accum)]


def _accumulate(grad_fn: Callable, batch: dict, accum: int):
    """``grad_fn(batch)`` (``(metrics, grad leaves)``), or with ``accum >
    1`` the mean over the microbatches of its float32 gradients and of its
    metrics."""
    if accum <= 1:
        return grad_fn(batch)
    grads = metrics = None
    for mb in _microbatches(batch, accum):
        m, g = grad_fn(mb)
        grads = ([b.float() for b in g] if grads is None
                 else [a + b.float() for a, b in zip(grads, g)])
        metrics = m if metrics is None else {k: metrics[k] + m[k]
                                             for k in metrics}
    return ({k: v / accum for k, v in metrics.items()},
            [g / accum for g in grads])


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    accum: int = 1,
    compress: bool = False,
    *,
    shards=None,
    shardings: TrainState | None = None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Returns ``train_step(state, batch) → (state, metrics)``.

    ``accum > 1`` splits the batch into ``accum`` microbatches along its
    first axis, one forward and backward each, and sums their float32
    gradients and their metrics before dividing by ``accum``.
    ``compress=True`` quantize-dequantizes the gradients (int8 + error
    feedback) before the optimizer.  The state is not modified: the step
    returns a new one.  It records the spans (:mod:`repro_torch.tracing`)
    ``train.step`` and inside it ``train.forward`` and ``train.backward``
    for each microbatch and ``train.optimizer`` around the clip and the
    update.

    With ``shards`` (this process's shard of a data × model mesh: a
    :class:`~repro_torch.parallel.collectives.Shards`, a ``DeviceMesh`` or
    a :class:`~repro_torch.parallel.tensor.Participant`) and
    ``shardings`` (:func:`state_shardings` on that mesh, ``zero_opt`` as
    wanted), the step is the sharded one: ``state`` is this participant's
    block of the state (``shard_tree(state, shardings, coord)``), ``batch``
    the whole batch (each microbatch's rows are cut by ``batch_specs``),
    and the metrics are the whole batch's, the same on every participant.
    Its gradients are pmeaned over the data axes and those of
    :func:`partial_grad_leaves` summed over ``"model"``; the clipping norm
    counts a model-sharded leaf's squares over its blocks and a
    replicated one's once; under ZeRO-1 (``m`` / ``v`` sharded over the
    data axes) each participant updates its data slice of ``m``, ``v`` and
    the parameter and the parameters are all-gathered over the data axes.
    ``compress=True`` quantize-dequantizes the summed gradients before the
    clip, as the unsharded step does, with the int8 blocks and scales of
    each whole leaf (:func:`~repro_torch.parallel.compress.ef_compress_sharded`):
    ``state["ef"]`` is the participant's block of the residual."""
    if shards is not None:
        return _sharded_train_step(model, opt_cfg, accum, compress,
                                   participant(shards), shardings)

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        with tracing.span("train.forward"):
            loss, metrics = model.loss(tree.unflatten(params, leaves), batch)
        with tracing.span("train.backward"):
            grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, list(grads)

    def train_step(state: TrainState, batch: dict):
        with tracing.span("train.step"):
            params = state["params"]
            metrics, grads = _accumulate(lambda b: grad_fn(params, b), batch,
                                         accum)
            grads = tree.unflatten(params, grads)
            new_state: TrainState = {}
            if compress:
                grads, new_state["ef"] = ef_compress(grads, state["ef"])
            with tracing.span("train.optimizer"):
                new_params, new_opt, opt_metrics = adamw_update(
                    grads, state["opt"], params, opt_cfg)
            new_state["params"] = new_params
            new_state["opt"] = new_opt
            return new_state, {**metrics, **opt_metrics}

    return train_step


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------
#: Leaves replicated over ``"model"`` that the forward reads before a model
#: region begins (``rmsnorm(x, norm_scale)`` ahead of each slot,
#: ``final_norm`` ahead of the head, the encoder-decoder's
#: ``enc_final_norm`` ahead of every cross-attention, which takes the
#: encoder's output into its region): their gradient arrives whole through
#: ``enter_model_region``.
AHEAD_OF_REGION = ("norm_scale", "final_norm", "enc_final_norm")


def _model_sharded(sh: NamedSharding) -> bool:
    return any("model" in entry_axes(e) for e in sh.spec)


def partial_grad_leaves(param_sh) -> list[bool]:
    """Per parameter leaf (flatten order): whether a participant's gradient
    of it is partial over ``"model"``, to be summed over it.

    The rule, from the model's code: a leaf replicated over ``"model"``
    is read inside a model region, where each participant uses it only
    for its own heads, experts or columns (and the MoE aux losses count on
    model participant 0 alone), except the norm scales ahead of a region
    (:data:`AHEAD_OF_REGION`).  In the decoder-only model that is the
    router, the SSD's ``wbc``, ``wdt``, ``conv_bc_*``, ``A_log``, ``D`` and
    ``dt_bias``, and ``wk`` / ``wv`` / ``bk`` / ``bv`` where the kv heads
    do not divide the model axis; in the encoder-decoder's
    ``enc_blocks`` / ``dec_blocks`` the same names by the same rule (its
    cross-attention's ``wk`` / ``wv`` included).  A model-sharded leaf's
    gradient is its block's whole.

    Under ``moe_impl="ep"`` the router is partial by another route: each
    model participant routes its own sequence block of the tokens, so its
    gradient through the routing weights is its block's, and the aux
    terms are means over the whole mesh (the reference's ``pmean`` over
    ``("model", *dp)``) held by every participant, not only model
    participant 0.  Their backward hands each participant ``1 / m`` of
    the gradient that arrives (``parallel/tensor.py`` ``mean_over_mesh``):
    every participant's loss holds the same aux terms, so the sum over
    ``"model"`` adds ``m`` shares of the data participant's whole, and the
    mean over the data axes takes the rest of the pmean's ``1 / (m ·
    dp)``.  The router's gradient is then the whole batch's, counted once,
    as the reference's ``shard_map`` transposes."""
    return [not _model_sharded(sh) and str(path[-1]) not in AHEAD_OF_REGION
            for path, sh in tree.leaves_with_path(param_sh)]


def _flat_reduce(ts: list, fn: Callable) -> list:
    """``fn`` over the tensors ``ts`` flattened into one per dtype (one
    collective each), split back to their shapes."""
    out = list(ts)
    by_dtype: dict = {}
    for i, t in enumerate(ts):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = fn(torch.cat([ts[i].reshape(-1) for i in idx]))
        for i, part in zip(idx, flat.split([ts[i].numel() for i in idx])):
            out[i] = part.view(ts[i].shape)
    return out


def batch_rows(batch: dict, cfg, part: Participant) -> dict:
    """``part``'s rows of ``batch`` by ``batch_specs`` (all of them where
    the batch does not divide over the data axes)."""
    specs = batch_specs(cfg, part.mesh, batch["tokens"].shape[0],
                        has_embeds="embeds" in batch,
                        encdec="enc_embeds" in batch)
    return shard_tree(batch, {k: NamedSharding(part.mesh, specs[k])
                              for k in batch}, part.coord)


def sharded_grads(model: Model, params, batch: dict, part: Participant,
                  accum: int = 1):
    """``(metrics, grads)`` of the sharded step before its sums over
    ``"model"``: this participant's gradients of its parameter block
    (``params``), for its rows of each microbatch of ``batch``, pmeaned
    over the data axes; the whole batch's metrics."""
    rows, seq = batch["tokens"].shape[0] // accum, batch["tokens"].shape[1]
    # expert parallelism's refusal of a micro-batch whose rows do not
    # split over the data axes, before the step's first collective
    check_part(model.cfg, rows_part(part, rows),
               seq + (batch["embeds"].shape[1] if "embeds" in batch else 0))

    def grad_fn(mb):
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        with tracing.span("train.forward"):
            loss, metrics = model.loss(tree.unflatten(params, leaves),
                                       batch_rows(mb, model.cfg, part),
                                       shards=part)
        with tracing.span("train.backward"):
            grads = torch.autograd.grad(loss, leaves)
        return {k: v.detach() for k, v in metrics.items()}, list(grads)

    metrics, grads = _accumulate(grad_fn, batch, accum)
    return metrics, tree.unflatten(params, _flat_reduce(grads,
                                                        part.pmean_dp))


def psum_partial(grads, partial: list[bool], part: Participant):
    """``grads`` with the leaves flagged in ``partial``
    (:func:`partial_grad_leaves`) summed over ``"model"``."""
    leaves = tree.leaves(grads)
    idx = [i for i, p in enumerate(partial) if p]
    if idx:
        for i, g in zip(idx, _flat_reduce([leaves[i] for i in idx],
                                          part.psum_model)):
            leaves[i] = g
    return tree.unflatten(grads, leaves)


def _zero_cuts(shardings: TrainState) -> list:
    """Per parameter leaf, ``(dim, axes)`` where ZeRO-1 shards its ``m``
    over the data axes ``axes`` along ``dim`` (its parameter's entry
    there is None), else None."""
    out = []
    for p_sh, m_sh in zip(tree.leaves(shardings["params"]),
                          tree.leaves(shardings["opt"].m), strict=True):
        cut = None
        for d, (pe, me) in enumerate(zip(list(p_sh.spec) + [None] * len(
                m_sh.spec), m_sh.spec)):
            if pe is None and me is not None:
                cut = (d, entry_axes(me))
        out.append(cut)
    return out


def _sharded_train_step(model: Model, opt_cfg: AdamWConfig, accum: int,
                        compress: bool, part: Participant, shardings):
    if shardings is None:
        raise ValueError("the sharded step needs the state's shardings "
                         "(state_shardings)")
    p_sh = shardings["params"]
    partial = partial_grad_leaves(p_sh)
    sharded = [_model_sharded(sh) for sh in tree.leaves(p_sh)]
    cuts = _zero_cuts(shardings)
    mesh = part.mesh
    like = model.abstract_params()

    def reduce_sums(sums: list) -> list:
        """A model-sharded leaf's squares summed over its blocks."""
        idx = [i for i, s in enumerate(sharded) if s]
        if not idx:
            return sums
        whole = part.psum_model(torch.stack([sums[i] for i in idx]))
        sums = list(sums)
        for j, i in enumerate(idx):
            sums[i] = whole[j]
        return sums

    def cut(t, c):
        """This participant's data slice of a leaf under ZeRO-1."""
        if c is None:
            return t
        d, axes = c
        n, i = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            i = i * mesh.shape[a] + part.coord[a]
        size = t.shape[d] // n
        return t.narrow(d, i * size, size)

    def gather_cut(slices: list) -> list:
        """The ZeRO-1 slices of every participant of the data axes put
        together along their dims, one all-gather for all leaves."""
        idx = [i for i, c in enumerate(cuts) if c is not None]
        out = list(slices)
        if not idx:
            return out
        flat = torch.cat([slices[i].reshape(-1) for i in idx])
        everyone = part.all_gather_dp(flat)
        off = 0
        for i in idx:
            t, (d, _axes) = slices[i], cuts[i]
            blocks = everyone[:, off:off + t.numel()].reshape(-1, *t.shape)
            out[i] = torch.cat(list(blocks.unbind(0)), dim=d)
            off += t.numel()
        return out

    def train_step(state: TrainState, batch: dict):
        with tracing.span("train.step"):
            params = state["params"]
            metrics, grads = sharded_grads(model, params, batch, part, accum)
            grads = psum_partial(grads, partial, part)
            new_state: TrainState = {}
            if compress:
                grads, new_state["ef"] = ef_compress_sharded(
                    grads, state["ef"], p_sh, like, part)
            with tracing.span("train.optimizer"):
                grads, gnorm = clip_by_global_norm(
                    grads, opt_cfg.grad_clip, reduce_sums)
                g_cut = [cut(g, c) for g, c in zip(tree.leaves(grads), cuts)]
                p_cut = [cut(p, c) for p, c in zip(tree.leaves(params),
                                                   cuts)]
                new_cut, new_opt, lr = adamw_step(
                    tree.unflatten(params, g_cut), state["opt"],
                    tree.unflatten(params, p_cut), opt_cfg)
                new_params = tree.unflatten(params,
                                            gather_cut(tree.leaves(new_cut)))
            new_state["params"] = new_params
            new_state["opt"] = new_opt
            return new_state, {**metrics, "grad_norm": gnorm, "lr": lr}

    return train_step
