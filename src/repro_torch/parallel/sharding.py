"""Sharding rules: parameter path → partition spec for the production meshes.

The JAX package's ``parallel/sharding.py`` without JAX: the same rules
give the same specs, entry for entry.  A spec is a tuple of per-dimension
entries, as ``jax.sharding.PartitionSpec`` holds them — ``None``
(replicated), an axis name, or a tuple of axis names (one-name tuples are
written as the name, and an empty one as ``None``, as ``PartitionSpec``
normalises them).  A mesh is a :class:`repro_torch.launch.mesh.Mesh` (or
anything with ``.shape`` and ``.axis_names``).  :class:`NamedSharding`
binds a spec to a mesh, and :func:`placements` turns a spec into the
``torch.distributed.tensor`` placements of a ``DeviceMesh``.
:func:`shard_tree` cuts one participant's block of every leaf of a tree by
its spec, and :func:`gather_tree` puts the blocks together again over a
:class:`~repro_torch.parallel.collectives.Shards`.

Axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod.  Batch shards over pod×data; attention heads / FFN hidden /
experts / vocab shard over model (tensor/expert parallelism); KV projections
replicate when ``n_kv_heads`` doesn't divide the model axis (glm4 kv=2,
granite kv=8 on a 16-way axis) — the grouped-replication standard.

Decode caches pick one of three layouts:
  - head-sharded   [nb, B@dp, S, KV@model, hd]   when KV divides model
  - hd-sharded     [nb, B@dp, S, KV, hd@model]   when it doesn't
  - fully-seq      [nb, B, S@dp, KV, hd@model]   when batch < dp size
:func:`cache_layout` names the one a batch takes (the fully-seq layout in
two forms: whole heads at a model axis of one, ``head_dim`` blocks
above).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from .. import tree

Spec = tuple


def spec(*entries) -> Spec:
    """A partition spec with ``PartitionSpec``'s normalisation of its
    entries: a one-name tuple becomes the name, an empty one ``None``."""
    def norm(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else e
        return e
    return tuple(norm(e) for e in entries)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``
    (a leaf of :mod:`repro_torch.tree`, as the reference's is of
    ``jax.tree``)."""
    mesh: Any
    spec: Spec

    def placements(self, device_mesh) -> list:
        return placements(self.spec, device_mesh)


def placements(spec_: Spec, mesh) -> list:
    """``torch.distributed.tensor`` placements of a spec on a mesh whose
    dims are named (a ``DeviceMesh`` built with ``mesh_dim_names``, or a
    :class:`~repro_torch.launch.mesh.Mesh`): for each mesh dim, ``Shard(i)``
    where tensor dim ``i``'s entry names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(getattr(mesh, "mesh_dim_names", None)
                  or mesh.axis_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec_):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis not in names:
                raise ValueError(f"spec {spec_} names {axis!r}, not an axis "
                                 f"of {names}")
            if not isinstance(out[names.index(axis)], Replicate):
                raise ValueError(f"spec {spec_} uses axis {axis!r} twice")
            out[names.index(axis)] = Shard(dim)
    return out


def entry_axes(entry) -> tuple[str, ...]:
    """The axes one spec entry names (none for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _entries(sharding: NamedSharding, ndim: int) -> list:
    return list(sharding.spec) + [None] * (ndim - len(sharding.spec))


def shard_shape(shape, sharding: NamedSharding) -> tuple[int, ...]:
    """One device's block of a leaf: each dimension ceil-divided by the
    product of the sizes of the axes its spec entry names (XLA pads an
    uneven shard)."""
    mesh = sharding.mesh
    return tuple(-(-dim // math.prod(mesh.shape[a] for a in entry_axes(e)))
                 for dim, e in zip(shape, _entries(sharding, len(shape))))


def shard_slices(shape, sharding: NamedSharding,
                 coord: dict[str, int]) -> tuple[slice, ...]:
    """The block of a ``shape`` leaf that the participant at ``coord``
    (``{axis: index}``) holds: along each dimension whose entry names axes,
    the ``i``-th of ``n`` runs of ``ceil(dim / n)`` elements, ``i`` the
    participant's row-major index over those axes and ``n`` the product of
    their sizes.  An uneven dimension leaves the last blocks shorter (or
    empty), where XLA pads them."""
    mesh = sharding.mesh
    out = []
    for dim, e in zip(shape, _entries(sharding, len(shape))):
        i = 0
        for a in entry_axes(e):
            i = i * mesh.shape[a] + coord[a]
        n = math.prod(mesh.shape[a] for a in entry_axes(e))
        c = -(-dim // n)
        out.append(slice(min(i * c, dim), min((i + 1) * c, dim)))
    return tuple(out)


def shard_tree(tree_: Any, shardings: Any, coord: dict[str, int]) -> Any:
    """The participant at ``coord``'s block of every leaf of ``tree_``
    (:func:`shard_slices`), by the :class:`NamedSharding` at the same
    place in ``shardings``: contiguous copies, which hold nothing of the
    whole tree."""
    return tree.map(lambda leaf, sh: leaf[shard_slices(
        leaf.shape, sh, coord)].clone(memory_format=torch.contiguous_format),
                    tree_, shardings)


def param_block(cfg, mesh, coord: dict[str, int], dtype=None):
    """A ``leaf`` for ``Model.init`` (``lm.init_params``): each leaf, as it
    is drawn, cut to the block that the participant at ``coord`` holds
    (``param_spec`` of its path, :func:`shard_slices`), in ``dtype(path,
    leaf)`` where that is given: a copy that holds nothing of the whole
    leaf.  The tree it gives is :func:`shard_tree`'s cut of the whole
    tree, which never exists: a device holds this participant's block and
    one whole leaf at a time."""
    def leaf(path: tuple, t: torch.Tensor) -> torch.Tensor:
        sh = NamedSharding(mesh, param_spec(list(path), t.dim(), cfg, mesh))
        block = t[shard_slices(t.shape, sh, coord)]
        want = t.dtype if dtype is None else dtype(path, t)
        if want != t.dtype:
            return block.to(want, memory_format=torch.contiguous_format)
        return block.clone(memory_format=torch.contiguous_format)
    return leaf


def gather_tree(local: Any, shardings: Any, shards, like: Any) -> Any:
    """:func:`shard_tree`'s inverse: the whole leaves, from the blocks the
    participants of ``shards`` (a :class:`~.collectives.Shards`) hold.
    ``local`` is this process's block tree, or a list of them in the order
    of ``shards.coords`` (the list form); ``like`` a tree of the whole
    leaves' shapes (``meta`` tensors will do).  Each sharded dimension is
    padded to its ceil-divided block, all-gathered over its entry's axes
    and cut back to the whole length, the minor dimension first; every
    participant receives the same whole tree."""
    parts = local if isinstance(local, list) else [local]
    if len(parts) != len(shards.coords):
        raise ValueError(f"{len(parts)} block trees for "
                         f"{len(shards.coords)} held shards")
    mesh_axes = tuple(shards.mesh.axis_names)

    def whole(sh: NamedSharding, ref, *blocks):
        blocks = list(blocks)
        entries = _entries(sh, len(ref.shape))
        for d in reversed(range(len(ref.shape))):
            axes = entry_axes(entries[d])
            if not axes:
                continue
            if axes != tuple(a for a in mesh_axes if a in axes):
                raise ValueError(f"spec {sh.spec}: the axes of an entry "
                                 "must be in the mesh's order")
            c = shard_shape(ref.shape, sh)[d]
            padded = [b if b.shape[d] == c else torch.nn.functional.pad(
                b, [0, 0] * (b.dim() - 1 - d) + [0, c - b.shape[d]])
                for b in blocks]
            stacked = shards.all_gather(padded, axes)
            blocks = [torch.cat(list(s.unbind(0)), dim=d).narrow(
                d, 0, ref.shape[d]) for s in stacked]
        return blocks[0]

    return tree.map(whole, shardings, like, *parts)


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------
def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh, *axes: str) -> int:
    return int(math.prod(mesh.shape[a] for a in axes
                         if a in mesh.axis_names))


def dp_size(mesh) -> int:
    return axis_size(mesh, *dp_axes(mesh))


def model_size(mesh) -> int:
    return axis_size(mesh, "model")


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------
def kv_shardable(cfg, m: int) -> bool:
    """Whether ``wk`` / ``wv`` (and ``bk`` / ``bv``) shard over a model
    axis of ``m``: where the kv heads divide it."""
    return cfg.n_kv_heads > 0 and cfg.n_kv_heads % m == 0


def param_spec(path_names: list[str], ndim: int, cfg, mesh) -> Spec:
    """Partition spec of one parameter leaf (rules above)."""
    name = path_names[-1]
    kv_ok = kv_shardable(cfg, model_size(mesh))

    def last_dims(*s):
        """Pad with None on the left for stacked (block) leading dims."""
        return spec(*([None] * (ndim - len(s)) + list(s)))

    if name == "embed":
        return spec("model", None)
    if name == "head":
        return spec(None, "model")
    if "norm" in name:                      # all norm vectors except inner
        if name == "inner_norm":
            return last_dims("model")
        return last_dims(None)
    if name in ("wq", "bq"):
        return last_dims(None, "model") if name == "wq" else last_dims("model")
    if name in ("wk", "wv"):
        return last_dims(None, "model") if kv_ok else last_dims(None, None)
    if name in ("bk", "bv"):
        return last_dims("model") if kv_ok else last_dims(None)
    if name == "wo":
        return last_dims("model", None)
    if name in ("w_gate", "w_up"):
        if ndim >= 4:                       # MoE stacked experts [nb,E,d,f]
            return last_dims("model", None, None)
        return last_dims(None, "model")
    if name == "w_down":
        if ndim >= 4:
            return last_dims("model", None, None)
        return last_dims("model", None)
    if name == "router":
        return last_dims(None, None)
    if name in ("wz", "wx"):
        return last_dims(None, "model")
    if name in ("wbc", "wdt"):
        return last_dims(None, None)
    if name == "conv_x_w":
        return last_dims(None, "model")
    if name == "conv_x_b":
        return last_dims("model")
    if name in ("conv_bc_w", "conv_bc_b", "A_log", "D", "dt_bias"):
        return last_dims(*([None] * min(ndim, 1)))
    if name == "out_proj":
        return last_dims("model", None)
    return spec()  # replicate anything unmatched (scalars, counters)


def _assign(tree_, fn):
    """``tree_``'s structure with ``fn(path names, leaf)`` at every leaf."""
    return tree.unflatten(tree_, [fn([str(k) for k in path], leaf)
                                  for path, leaf in
                                  tree.leaves_with_path(tree_)])


def param_shardings(abstract_params: Any, cfg, mesh):
    """:class:`NamedSharding` tree matching an abstract (``meta``) or
    concrete parameter tree."""
    return _assign(abstract_params, lambda path, leaf: NamedSharding(
        mesh, param_spec(path, len(leaf.shape), cfg, mesh)))


# ---------------------------------------------------------------------------
# batch / activation / cache rules
# ---------------------------------------------------------------------------
def batch_specs(cfg, mesh, batch_size: int, *, has_embeds: bool = False,
                encdec: bool = False) -> dict[str, Spec]:
    dp = dp_axes(mesh)
    shardable = batch_size % dp_size(mesh) == 0
    bspec = spec(dp) if shardable else spec()
    specs = {
        "tokens": spec(*bspec, None),
        "labels": spec(*bspec, None),
    }
    if has_embeds:
        specs["embeds"] = spec(*bspec, None, None)
    if encdec:
        specs["enc_embeds"] = spec(*bspec, None, None)
    return specs


def cache_spec_for_kv(cfg, mesh, batch_size: int) -> Spec:
    """Spec of ``[nb, B, S, KV, hd]`` attention caches (layouts above).
    Sharding the cache's sequence dim would make the per-step cache write
    un-partitionable, so where KV heads don't divide the model axis
    ``head_dim`` is sharded instead; the sequence shards over dp only
    where the batch can't."""
    dp = dp_axes(mesh)
    kv_ok = cfg.n_kv_heads % model_size(mesh) == 0
    hd_ok = cfg.head_dim % model_size(mesh) == 0
    batch_ok = batch_size % dp_size(mesh) == 0
    if batch_ok and kv_ok:
        return spec(None, dp, None, "model", None)
    if batch_ok:
        return spec(None, dp, None, None, "model" if hd_ok else None)
    return spec(None, None, dp, None, "model" if hd_ok else None)


def cache_layout(cfg, mesh, batch_size: int) -> str:
    """The layout :func:`cache_spec_for_kv` gives a batch of
    ``batch_size``, read off the spec: ``"head"`` (the batch over dp, the
    kv heads over model), ``"hd"`` (the batch over dp, ``head_dim`` over
    model), ``"seq"`` (the sequence over dp, whole heads: a model axis of
    one) or ``"seq_hd"`` (the sequence over dp, ``head_dim`` over a model
    axis of more than one).  Raises ``NotImplementedError`` for the spec
    that keeps whole heads on a model axis of more than one (neither the
    kv heads nor ``head_dim`` divide it): the sharded layers do not run
    it."""
    s = cache_spec_for_kv(cfg, mesh, batch_size)
    m = model_size(mesh)
    if s[2] is None:
        if s[3] == "model":
            return "head"
        if s[4] == "model" and m > 1:
            return "hd"
    elif m == 1:
        return "seq"
    elif s[4] == "model":
        return "seq_hd"
    raise NotImplementedError(
        f"{cfg.name}: neither {cfg.n_kv_heads} kv heads nor head_dim "
        f"{cfg.head_dim} divide a model axis of {m}")


def cache_shardings(cfg, mesh, abstract_cache: Any, batch_size: int):
    """Shardings of an ``lm.init_cache`` tree (attention and SSM slots)."""
    dp = dp_axes(mesh)
    batch_ok = batch_size % dp_size(mesh) == 0
    bax = dp if batch_ok else None
    kv_spec = cache_spec_for_kv(cfg, mesh, batch_size)
    h_ok = cfg.ssm_state and cfg.ssm_heads % model_size(mesh) == 0
    di_ok = cfg.ssm_state and cfg.d_inner % model_size(mesh) == 0

    def assign(path, leaf):
        name = path[-1]
        if name in ("k", "v"):
            s = kv_spec
        elif name == "conv_x":
            s = spec(None, bax, None, "model" if di_ok else None)
        elif name == "conv_bc":
            s = spec(None, bax, None, None)
        elif name == "ssm":
            s = spec(None, bax, "model" if h_ok else None, None, None)
        else:
            s = spec()
        return NamedSharding(mesh, s)

    return _assign(abstract_cache, assign)


def logits_spec(cfg, mesh, batch_size: int) -> Spec:
    dp = dp_axes(mesh)
    shardable = batch_size % dp_size(mesh) == 0
    return spec(dp if shardable else None, None, "model")
