"""A model's weights, made from the seed on the device in a few large
draws, in the dtype they are trained or served in.

The tree is the decoder-only layout ``{"embed" [V', d], "final_norm" [d],
["head" [d, V']], "blocks": {"L<i>_<kind>": {name: [n_blocks, ...]}}}``
(``V'`` the vocabulary rounded up to 128).  Every random matrix is a view
of one normal draw, scaled in place: N(0, 0.02), output projections of
attention and dense FFNs N(0, 0.02 / sqrt(2 n_layers)), conv weights
N(0, 0.1); norm scales and D are ones, biases zeros, ``A_log = log(1..H)``,
``dt_bias`` the inverse softplus of a log-uniform dt in [1e-3, 1e-1].
"""
from __future__ import annotations

import math

import torch

from ..reference.lm import n_blocks, slot_keys, vocab_padded
from ..yardstick.work import head_dim

#: Leaves served in float32 whatever the compute dtype (the model reads
#: them in float32).
KEEP_F32 = ("norm_scale", "final_norm", "inner_norm", "A_log", "dt_bias")
ONES = ("norm_scale", "final_norm", "inner_norm", "D")
ZEROS = ("bq", "bk", "bv", "conv_x_b", "conv_bc_b")


def slot_shapes(m: dict, kind: str) -> dict[str, tuple]:
    d = m["d_model"]
    if kind == "attn":
        h, kv, hd = m["n_heads"], m["n_kv_heads"], head_dim(m)
        out = {"norm_scale": (d,), "wq": (d, h * hd), "wk": (d, kv * hd),
               "wv": (d, kv * hd), "wo": (h * hd, d)}
        if m.get("qkv_bias"):
            out.update(bq=(h * hd,), bk=(kv * hd,), bv=(kv * hd,))
        return out
    if kind == "mlp":
        f = m["d_ff"]
        return {"norm_scale": (d,), "w_gate": (d, f), "w_up": (d, f),
                "w_down": (f, d)}
    if kind == "moe":
        e, f = m["moe_experts"], m.get("moe_d_ff") or m["d_ff"]
        return {"norm_scale": (d,), "router": (d, e), "w_gate": (e, d, f),
                "w_up": (e, d, f), "w_down": (e, f, d)}
    di = m.get("ssm_expand", 2) * d
    h = di // m.get("ssm_head_dim", 64)
    gn2 = 2 * m.get("ssm_groups", 1) * m["ssm_state"]
    k = m.get("ssm_conv", 4)
    return {"norm_scale": (d,), "wz": (d, di), "wx": (d, di),
            "wbc": (d, gn2), "wdt": (d, h), "conv_x_w": (k, di),
            "conv_x_b": (di,), "conv_bc_w": (k, gn2), "conv_bc_b": (gn2,),
            "A_log": (h,), "D": (h,), "dt_bias": (h,), "inner_norm": (di,),
            "out_proj": (di, d)}


def shapes(m: dict) -> dict:
    vp, d, nb = vocab_padded(m), m["d_model"], n_blocks(m)
    out: dict = {"embed": (vp, d), "final_norm": (d,), "blocks": {}}
    if not m.get("tie_embeddings"):
        out["head"] = (d, vp)
    for key, kind in slot_keys(m):
        out["blocks"][key] = {n: (nb, *s)
                              for n, s in slot_shapes(m, kind).items()}
    return out


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


def std_of(m: dict, path: str) -> float:
    name = path.rsplit("/", 1)[-1]
    if name.startswith("conv"):
        return 0.1
    if name == "wo" or (name == "w_down" and path.split("/")[-2].endswith(
            "_mlp")):
        return 0.02 / math.sqrt(2 * m["n_layers"])
    return 0.02


def make(m: dict, seed: int, device, dtype: torch.dtype,
         keep_f32: bool = False) -> dict:
    """The weights of configuration ``m`` from ``seed`` on ``device``, in
    ``dtype`` (``keep_f32``: the ``KEEP_F32`` leaves in float32)."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    leaves = flat(shapes(m))

    def leaf_dtype(path: str) -> torch.dtype:
        return torch.float32 if keep_f32 and path.rsplit("/", 1)[-1] \
            in KEEP_F32 else dtype

    normal = [p for p in leaves if p.rsplit("/", 1)[-1] not in
              ONES + ZEROS + ("A_log", "dt_bias")]
    total = sum(math.prod(leaves[p]) for p in normal)
    buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out: dict[str, torch.Tensor] = {}
    off = 0
    for p in normal:
        n = math.prod(leaves[p])
        out[p] = buf[off:off + n].view(leaves[p]).mul_(std_of(m, p))
        off += n
    dt_paths = [p for p in leaves if p.endswith("/dt_bias")]
    u = torch.rand(sum(math.prod(leaves[p]) for p in dt_paths),
                   generator=gen, device=device, dtype=torch.float32)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(u * (hi - lo) + lo)
    inv = dt + torch.log(-torch.expm1(-dt))
    off = 0
    for p in leaves:
        name = p.rsplit("/", 1)[-1]
        shape = leaves[p]
        if name in ONES:
            out[p] = torch.ones(shape, device=device, dtype=leaf_dtype(p))
        elif name in ZEROS:
            out[p] = torch.zeros(shape, device=device, dtype=leaf_dtype(p))
        elif name == "A_log":
            h = shape[-1]
            out[p] = torch.log(torch.arange(
                1, h + 1, dtype=torch.float32, device=device)).expand(
                    shape).to(leaf_dtype(p)).contiguous()
        elif name == "dt_bias":
            n = math.prod(shape)
            out[p] = inv[off:off + n].view(shape).to(leaf_dtype(p))
            off += n
    return unflat({p: out[p] for p in leaves})
