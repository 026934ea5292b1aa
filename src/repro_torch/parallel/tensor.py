"""Tensor parallelism written out: the collectives GSPMD inserts into the
JAX package's sharded train step, as ``torch.autograd.Function`` s over a
:class:`~repro_torch.parallel.collectives.Shards`.

The JAX package jits its train step with ``in_shardings`` from its
sharding rules and lets XLA insert the collectives.  Here each participant
of a ``("data", "model")`` mesh (``("pod", "data", "model")`` too) runs the
model on its block of every parameter (:func:`.sharding.shard_tree`) and
its rows of the batch, and the model layers call these functions where a
sharded region begins or ends:

- :func:`enter_model_region` (Megatron's *f*): identity forward, psum of
  the gradient over ``"model"`` backward.  A replicated activation enters
  a region whose participants each use it for their own heads, experts,
  columns or vocabulary rows, so each holds a part of its gradient.
- :func:`leave_model_region` (*g*): psum forward, identity backward.  The
  participants' partial outputs add up to the replicated activation, whose
  gradient every participant holds whole.
- :func:`sum_over_model`: psum both ways, for a sum whose result each
  participant reads inside its own region (the sharded ``inner_norm``'s
  mean of squares).
- :func:`gather_vocab` and :func:`vocab_parallel_cross_entropy`: the
  vocabulary-sharded logits whole, and the loss over them without
  gathering them (max, sum of exponents and the label's logit, each
  reduced over ``"model"``; the max carries no gradient).
- :func:`enter_sequence_block` / :func:`leave_sequence_block`,
  :func:`all_to_all_model` and :func:`mean_over_mesh`: expert
  parallelism's region (``parallel/ep_moe.py``), which the reference
  enters through ``shard_map(in_specs=P(dp, "model", None))``.  A
  participant takes its block of the sequence (backward: the blocks'
  gradients all-gathered over ``"model"``, so each holds the whole
  gradient of the replicated activation), exchanges rows with the other
  model participants (backward: the same exchange of the gradients), and
  leaves with the blocks all-gathered over ``"model"`` (backward: its
  own block of the whole gradient).  Its aux statistics are means over
  the whole mesh, whose gradient each model participant takes a ``1 /
  m`` share of (:func:`mean_over_mesh`).

Every reduction is the parallel layers' own: a gather reduced in shard
order (:meth:`Shards.psum`), never ``dist.all_reduce``, so the replicated
activations hold the same bits on every model participant.  The MoE
routers depend on it: participants that routed differently would run
other collectives or train another function.  Over an axis of one shard
nothing moves (the sum or mean of one is itself), so on a 1 × 1 mesh
each function is the identity and the sharded model gives the unsharded
model's bits.
"""
from __future__ import annotations

import copy

import torch

from .collectives import shards as as_shards
from .sharding import dp_axes


class Participant:
    """This process's place in a data × model mesh: its :class:`Shards`
    (one held shard), its index ``mi`` of ``m`` along ``"model"`` and ``di``
    of ``dp`` over the data axes, and the collectives the model layers
    take over each.  ``shards`` may be a :class:`Shards`, a
    ``DeviceMesh`` or a :class:`~repro_torch.launch.mesh.Mesh` (one shard
    only, the list form of a 1 × 1 mesh).  ``rows_split``: whether the
    participant holds its data block of the batch's rows (the default), or
    every row (:meth:`whole_rows`)."""

    rows_split = True

    def __init__(self, shards) -> None:
        sh = as_shards(shards)
        if len(sh.coords) != 1:
            raise ValueError(f"a participant holds one shard; these hold "
                             f"{len(sh.coords)} (run one process a shard)")
        self.shards = sh
        self.mesh = sh.mesh
        self.coord = dict(sh.coords[0])
        names = self.mesh.axis_names
        self.m = self.mesh.shape["model"] if "model" in names else 1
        self.mi = self.coord.get("model", 0)
        self.dp_axes = dp_axes(self.mesh)
        self.dp = 1
        self.di = 0
        for a in self.dp_axes:
            self.dp *= self.mesh.shape[a]
            self.di = self.di * self.mesh.shape[a] + self.coord[a]

    def block(self, n: int) -> tuple[int, int]:
        """``[lo, hi)``: this participant's block of a dimension of ``n``
        split over ``"model"`` (ceil-divided, as ``shard_tree`` cuts it)."""
        c = -(-n // self.m)
        return min(self.mi * c, n), min((self.mi + 1) * c, n)

    def dp_block(self, n: int) -> tuple[int, int]:
        """``[lo, hi)``: this participant's block of a dimension of ``n``
        split over the data axes (ceil-divided, as ``shard_tree`` cuts
        it)."""
        c = -(-n // self.dp)
        return min(self.di * c, n), min((self.di + 1) * c, n)

    def whole_rows(self) -> "Participant":
        """This participant given every row of the batch, as
        ``batch_specs`` replicates a batch that does not divide over the
        data axes: a mean over those axes of what the rows give is what
        this participant holds already."""
        out = copy.copy(self)
        out.rows_split = False
        return out

    def _model(self, op: str, x: torch.Tensor) -> torch.Tensor:
        if self.m == 1:                  # the sum of one: nothing moves
            return x
        return getattr(self.shards, op)([x], "model")[0]

    def psum_model(self, x: torch.Tensor) -> torch.Tensor:
        return self._model("psum", x)

    def max_model(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over ``"model"`` (no gradient)."""
        if self.m == 1:
            return x
        return self.shards.all_gather([x.detach()], "model")[0].amax(0)

    def all_gather_model(self, x: torch.Tensor) -> torch.Tensor:
        """``[m, ...]``: every model participant's ``x``, in model order."""
        if self.m == 1:
            return x[None]
        return self.shards.all_gather([x], "model")[0]

    def _dp(self, op: str, x: torch.Tensor) -> torch.Tensor:
        if self.dp == 1:
            return x
        return getattr(self.shards, op)([x], self.dp_axes)[0]

    def psum_dp(self, x: torch.Tensor) -> torch.Tensor:
        return self._dp("psum", x)

    def pmean_dp(self, x: torch.Tensor) -> torch.Tensor:
        return self._dp("pmean", x)

    def all_to_all_model(self, x: torch.Tensor) -> torch.Tensor:
        """``x [m, ...]``: block ``j`` sent to model participant ``j``;
        returns ``[m, ...]``, block ``i`` from participant ``i``."""
        if self.m == 1:
            return x
        return torch.stack(self.shards.all_to_all([x], "model")[0])

    def _mesh(self, op: str, x: torch.Tensor) -> torch.Tensor:
        if self.m * self.dp == 1:
            return x
        return getattr(self.shards, op)([x], (*self.dp_axes, "model"))[0]

    def psum_mesh(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the data axes and ``"model"``."""
        return self._mesh("psum", x)

    def pmean_mesh(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the data axes and ``"model"``."""
        return self._mesh("pmean", x)

    def all_gather_dp(self, x: torch.Tensor) -> torch.Tensor:
        """``[dp, ...]``: every data participant's ``x``, in row-major
        order over the data axes."""
        if self.dp == 1:
            return x[None]
        return self.shards.all_gather([x], self.dp_axes)[0]


def participant(shards) -> Participant | None:
    """``shards`` as a :class:`Participant` (None stays None)."""
    if shards is None or isinstance(shards, Participant):
        return shards
    return Participant(shards)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, part):
        ctx.part = part
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.part.psum_model(g), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, part):
        return part.psum_model(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, part):
        ctx.part = part
        return part.psum_model(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.part.psum_model(g), None


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, part, n):
        c = -(-n // part.m)
        ctx.part, ctx.width, ctx.block = part, x.shape[-1], c
        x = torch.nn.functional.pad(x, (0, c - x.shape[-1]))
        parts = part.all_gather_model(x)
        return torch.cat(list(parts.unbind(0)), dim=-1)[..., :n]

    @staticmethod
    def backward(ctx, g):
        c, lo = ctx.block, ctx.part.mi * ctx.block
        g = torch.nn.functional.pad(g, (0, ctx.part.m * c - g.shape[-1]))
        return g[..., lo:lo + ctx.width], None, None


def _join_blocks(x: torch.Tensor, part: Participant) -> torch.Tensor:
    """Every model participant's block ``x [b, s, ...]`` of the sequence,
    joined in model order: ``[b, m · s, ...]``."""
    parts = part.all_gather_model(x.contiguous())        # [m, b, s, ...]
    return parts.movedim(0, 1).reshape(x.shape[0], -1, *x.shape[2:])


def _own_block(x: torch.Tensor, part: Participant) -> torch.Tensor:
    n = x.shape[1] // part.m
    return x[:, part.mi * n:(part.mi + 1) * n]


class _EnterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, part):
        ctx.part = part
        return _own_block(x, part)

    @staticmethod
    def backward(ctx, g):
        return _join_blocks(g, ctx.part), None


class _LeaveSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, part):
        ctx.part = part
        return _join_blocks(x, part)

    @staticmethod
    def backward(ctx, g):
        return _own_block(g, ctx.part), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, part):
        ctx.part = part
        return part.all_to_all_model(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.part.all_to_all_model(g), None


class _MeanOverMesh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, part):
        ctx.m = part.m
        return part.pmean_mesh(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.m, None


def enter_sequence_block(x: torch.Tensor, part: Participant) -> torch.Tensor:
    """A replicated ``x [b, S, ...]``'s block ``mi`` of ``m`` along the
    sequence (``S % m == 0``); its gradient every model participant's
    block's, all-gathered and joined: the whole gradient of ``x``, as
    every participant holds a replicated activation's.  With ``part.m ==
    1``, ``x`` as it is."""
    if part.m == 1:
        return x
    return _EnterSeq.apply(x, part)


def leave_sequence_block(x: torch.Tensor, part: Participant) -> torch.Tensor:
    """Every model participant's sequence block ``x [b, s, ...]`` joined:
    ``[b, m · s, ...]``, replicated over ``"model"``; the gradient this
    participant's block of the whole one."""
    if part.m == 1:
        return x
    return _LeaveSeq.apply(x, part)


def all_to_all_model(x: torch.Tensor, part: Participant) -> torch.Tensor:
    """:meth:`Participant.all_to_all_model` with its gradient: the same
    exchange of the gradients, backward (the tiled all_to_all is its own
    transpose)."""
    if part.m == 1:
        return x
    return _AllToAll.apply(x, part)


def mean_over_mesh(x: torch.Tensor, part: Participant) -> torch.Tensor:
    """The mean of ``x`` over the data axes and ``"model"``, each
    participant's ``x`` a statistic of its own block of the tokens.  The
    gradient is ``1 / m`` of what arrives: every participant's loss holds
    the replicated mean, the step sums a replicated leaf's partial
    gradients over ``"model"`` (``m`` shares of the data participant's
    whole) and means them over the data axes (the data axes' ``1 /
    dp``), so the mean's gradient reaches each block once, as the
    reference's ``pmean`` transposes."""
    if part.m * part.dp == 1:
        return x
    return _MeanOverMesh.apply(x, part)


def enter_model_region(x: torch.Tensor, part: Participant) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``"model"``."""
    return _Enter.apply(x, part)


def leave_model_region(x: torch.Tensor, part: Participant) -> torch.Tensor:
    """The sum of every model participant's ``x``; the gradient as it
    is."""
    return _Leave.apply(x, part)


def leave_model_region_product(fn, part: Participant,
                               *operands: torch.Tensor) -> torch.Tensor:
    """The region end of a product: ``fn(*operands)`` (each participant's
    partial, e.g. its rows of ``wo`` times its heads' columns) summed over
    ``"model"``, as :func:`leave_model_region` sums it.  With ``part.m >
    1`` the partials are formed in float32 (the operands upcast, which is
    exact for bf16), summed in shard order and rounded once to the first
    operand's dtype: the reference's bf16 all-reduce sums partials each
    rounded to bf16 first, so this is more exact than it.  With ``part.m
    == 1`` it is ``leave_model_region(fn(*operands))``, the unsharded
    bits."""
    if part.m == 1:
        return leave_model_region(fn(*operands), part)
    dtype = operands[0].dtype
    partial = fn(*(o.float() for o in operands))
    return leave_model_region(partial, part).to(dtype)


def sum_over_model(x: torch.Tensor, part: Participant) -> torch.Tensor:
    """The sum of every model participant's ``x``, each participant's
    gradient summed too (the result is read inside a region)."""
    return _Sum.apply(x, part)


def gather_vocab(logits: torch.Tensor, part: Participant,
                 vocab: int) -> torch.Tensor:
    """Vocabulary-sharded logits ``[..., ceil(vocab / m)]`` whole: ``[...,
    vocab]``, the blocks in model order (the last one's padding cut)."""
    return _GatherVocab.apply(logits, part, vocab)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 part: Participant,
                                 vocab: int) -> torch.Tensor:
    """:func:`repro_torch.models.lm.cross_entropy` over this participant's
    block of the vocabulary (``logits [..., V_local]``, columns
    ``part.block(vocab)``): the row max over ``"model"`` (no gradient), the
    sum of exponents and the label's logit (selected by comparing the
    global column index with the label) each summed over ``"model"``.  Every
    model participant returns the same bits."""
    logits32 = logits.float()
    m = part.max_model(logits32.amax(dim=-1, keepdim=True).detach())
    total = leave_model_region(torch.exp(logits32 - m).sum(dim=-1), part)
    lse = torch.log(total) + m[..., 0]
    lo, hi = part.block(vocab)
    col = lo + torch.arange(hi - lo, device=logits.device)
    label_logit = leave_model_region(
        torch.where(col == labels[..., None], logits32, 0.0).sum(dim=-1),
        part)
    return lse - label_logit
