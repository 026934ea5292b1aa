"""A model's weights, made from the seed on the device in a few large
draws, in the dtype they are trained or served in.

The configuration's reference (``ref``, the module its ``"reference"``
key names) gives the tree of shapes (``ref.shapes(m)``) and how each leaf
is made (``ref.init(m, path)``): every leaf with a std is a view of one
normal draw over those leaves in the tree's order, scaled in place; then
one uniform draw gives every ``"dt_bias"`` leaf, in the same order, the
inverse softplus of a log-uniform dt in [1e-3, 1e-1]; ``"ones"`` and
``"zeros"`` are filled, ``"A_log"`` is ``log(1..H)`` over its last axis.
"""
from __future__ import annotations

import math

import torch


def flat(tree: dict, prefix: str = "") -> dict[str, object]:
    """``{"a/b/c": leaf}`` in the tree's order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflat(items: dict[str, object]) -> dict:
    tree: dict = {}
    for path, v in items.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def make(ref, m: dict, seed: int, device, dtype: torch.dtype,
         keep_f32: bool = False) -> dict:
    """The weights of configuration ``m`` from ``seed`` on ``device``, in
    ``dtype`` (``keep_f32``: the leaves ``ref.keeps_f32`` names in
    float32)."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    leaves = flat(ref.shapes(m))
    rule = {p: ref.init(m, p) for p in leaves}

    def leaf_dtype(path: str) -> torch.dtype:
        return torch.float32 if keep_f32 and ref.keeps_f32(path) else dtype

    normal = [p for p in leaves if not isinstance(rule[p], str)]
    total = sum(math.prod(leaves[p]) for p in normal)
    buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out: dict[str, torch.Tensor] = {}
    off = 0
    for p in normal:
        n = math.prod(leaves[p])
        out[p] = buf[off:off + n].view(leaves[p]).mul_(rule[p])
        off += n
    dt_paths = [p for p in leaves if rule[p] == "dt_bias"]
    u = torch.rand(sum(math.prod(leaves[p]) for p in dt_paths),
                   generator=gen, device=device, dtype=torch.float32)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(u * (hi - lo) + lo)
    inv = dt + torch.log(-torch.expm1(-dt))
    off = 0
    for p in leaves:
        shape = leaves[p]
        if rule[p] == "ones":
            out[p] = torch.ones(shape, device=device, dtype=leaf_dtype(p))
        elif rule[p] == "zeros":
            out[p] = torch.zeros(shape, device=device, dtype=leaf_dtype(p))
        elif rule[p] == "A_log":
            h = shape[-1]
            out[p] = torch.log(torch.arange(
                1, h + 1, dtype=torch.float32, device=device)).expand(
                    shape).to(leaf_dtype(p)).contiguous()
        elif rule[p] == "dt_bias":
            n = math.prod(shape)
            out[p] = inv[off:off + n].view(shape).to(leaf_dtype(p))
            off += n
        elif p not in out:
            raise ValueError(f"{p}: no rule {rule[p]!r}")
    return unflat({p: out[p] for p in leaves})
