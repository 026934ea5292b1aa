"""Nested containers of tensors, walked in the JAX package's order.

The port keeps parameters, optimizer state and checkpoints as nested
dicts, tuples and NamedTuples of tensors (or numpy arrays), as the JAX
package keeps its pytrees.  These functions walk them in ``jax.tree``'s
flatten order — dict keys sorted, sequences and NamedTuples in order,
``None`` an empty subtree — so a leaf's position in a checkpoint or a
norm's sum is the reference's.
"""
from __future__ import annotations

from typing import Any, Callable


def _children(node) -> list | None:
    """The child nodes of a container in flatten order, or None for a
    leaf."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    return None


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if hasattr(node, "_fields"):          # NamedTuple
        return type(node)(*children)
    return type(node)(children)


def leaves_with_path(tree, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf)]`` in flatten order; a path holds the dict keys, the
    NamedTuple field names and the sequence indices from the root."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    if isinstance(tree, dict):
        keys = sorted(tree)
    elif hasattr(tree, "_fields"):
        keys = list(tree._fields)
    else:
        keys = list(range(len(kids)))
    out = []
    for key, kid in zip(keys, kids):
        out += leaves_with_path(kid, path + (key,))
    return out


def leaves(tree) -> list:
    """The leaves in flatten order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    if any(o is None or len(o) != len(kids) for o in others):
        raise ValueError("trees of different structure")
    return _rebuild(tree, [map(fn, k, *(o[i] for o in others))
                           for i, k in enumerate(kids)])


def unflatten(template, new_leaves: list):
    """``template``'s structure filled with ``new_leaves`` in flatten
    order; raises when their number differs from its leaves'."""
    new_leaves = list(new_leaves)
    want = len(leaves(template))
    if len(new_leaves) != want:
        raise ValueError(f"{len(new_leaves)} leaves for a template of "
                         f"{want}")
    it = iter(new_leaves)
    return map(lambda _: next(it), template)
