"""Plain decoder-only language model: dense and grouped-query attention,
top-k mixture of experts, SSD (Mamba2) mixers and hybrids of them.

Written from the architecture's equations in plain PyTorch, in float32,
with no kernel, cache or batching of the program:

- a block is RMSNorm ahead of each slot and a residual after it; slots
  follow the configuration's layer pattern (mixer, then FFN);
- attention: q, k, v projections, rotary positions (rotate-half, theta
  from the configuration), causal softmax over grouped kv heads;
- SSD mixer: z, x, B|C and dt projections, causal depthwise conv (SiLU),
  dt = softplus(dt + dt_bias), A = -exp(A_log), the chunked dual form of
  the scan, D skip, RMSNorm of y * SiLU(z), out projection;
- MoE: float32 softmax router, top-k renormalised, SwiGLU experts;
  auxiliary load-balance and router z terms as the training loss adds them.
  A :class:`Routing` records each MoE layer's top-k choices, or routes
  to given ones (top-k is discontinuous: two runs that differ by rounding
  pick other experts wherever router probabilities nearly tie, so a
  gradient is compared at one routing) and measures how far those lie
  outside the layer's own top k.

Parameters are a dict tree ``{"embed", "final_norm", ["head"], "blocks":
{slot key: {name: [n_blocks, ...]}}}``.  ``mm`` is the matrix product
every projection goes through: :func:`mm_f32` (float32, TF32 off) or a
control's lower-precision product.

Beside the model, what the harness needs of a configuration that names
this reference (``portbench/reference/__init__.py`` lists it): the weight
tree (:func:`shapes`), how each leaf is made (:func:`init`,
:func:`keeps_f32`) and the parameter count the model FLOPs read
(:func:`param_count`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LB_COEF = 0.01
Z_COEF = 1e-3


def mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w.float()


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude maps to 448), returned in float32."""
    t = t.float()
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm_bf16(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The product with both operands rounded to bf16, accumulated in
    float32: the configuration's own precision, as a witness."""
    a = a.float()
    aq = a + (a.to(torch.bfloat16).float() - a).detach()
    wf = w.float()
    wq = wf + (wf.to(torch.bfloat16).float() - wf).detach()
    return aq @ wq


def mm_fp8(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The product with both operands rounded to float8 (straight-through
    for autograd), accumulated in float32: the precision below bf16."""
    a = a.float()
    aq = a + (fp8(a) - a).detach()
    wf = w.float()
    wq = wf + (fp8(wf) - wf).detach()
    return aq @ wq


def pattern(m: dict) -> list[tuple[str, str | None]]:
    """The repeating (mixer, ffn) slots of a decoder-only configuration."""
    if m["family"] == "ssm":
        return [("ssm", None)]
    period = 1
    if m.get("attn_period"):
        period = math.lcm(period, m["attn_period"])
    if m.get("moe_experts") and m.get("moe_period", 1) > 1:
        period = math.lcm(period, m["moe_period"])
    slots = []
    for i in range(period):
        mixer = "attn"
        if m.get("attn_period"):
            mixer = "attn" if i % m["attn_period"] == m["attn_offset"] \
                else "ssm"
        moe = m.get("moe_experts") and \
            i % m.get("moe_period", 1) == m.get("moe_offset", 0) % m.get(
                "moe_period", 1)
        slots.append((mixer, "moe" if moe else "mlp"))
    return slots


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def slot_keys(m: dict) -> list[tuple[str, str]]:
    out = []
    for i, (mixer, ffn) in enumerate(pattern(m)):
        out.append((f"L{i}_{mixer}", mixer))
        if ffn:
            out.append((f"L{i}_{ffn}", ffn))
    return out


def n_blocks(m: dict) -> int:
    return m["n_layers"] // len(pattern(m))


def vocab_padded(m: dict) -> int:
    return (m["vocab"] + 127) // 128 * 128


def rmsnorm(x, scale, eps):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, pos, theta):
    """x [B, S, H, D] float32, pos [S] absolute positions."""
    half = x.shape[-1] // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = pos.float()[:, None] * freq
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, budget: int = 1 << 28):
    """q [B, S, H, D], k / v [B, S, KV, D] float32; softmax over keys
    ``j <= i``, computed in blocks of queries so the scores stay under
    ``budget`` elements."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    rep = H // KV
    qg = q.reshape(B, S, KV, rep, D) / math.sqrt(D)
    rows = max(1, min(S, budget // max(1, B * H * S)))
    outs = []
    for s0 in range(0, S, rows):
        s1 = min(S, s0 + rows)
        sc = torch.einsum("bqgrd,bkgd->bgrqk", qg[:, s0:s1], k[:, :s1])
        qi = torch.arange(s0, s1, device=q.device)[:, None]
        kj = torch.arange(s1, device=q.device)[None, :]
        sc = sc.masked_fill(kj > qi, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        outs.append(torch.einsum("bgrqk,bkgd->bqgrd", p, v[:, :s1]))
    return torch.cat(outs, dim=1).reshape(B, S, H * D)


def attention(p, h, m, mm):
    B, S, _ = h.shape
    H, KV, hd = m["n_heads"], m["n_kv_heads"], head_dim(m)
    q = mm(h, p["wq"]).reshape(B, S, H, hd)
    k = mm(h, p["wk"]).reshape(B, S, KV, hd)
    v = mm(h, p["wv"]).reshape(B, S, KV, hd)
    if "bq" in p:
        q = q + p["bq"].float().reshape(H, hd)
        k = k + p["bk"].float().reshape(KV, hd)
        v = v + p["bv"].float().reshape(KV, hd)
    pos = torch.arange(S, device=h.device)
    theta = m.get("rope_theta", 1e4)
    out = causal_attention(rope(q, pos, theta), rope(k, pos, theta), v)
    return mm(out, p["wo"])


def causal_conv(x, w, b):
    """Depthwise causal conv: x [B, S, C], w [K, C], b [C]."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    S = x.shape[1]
    out = b.float() + sum(xp[:, i:i + S] * w[i].float() for i in range(K))
    return out


def ssd_scan(x, dt, A, Bm, Cm, Q: int = 256, budget: int = 1 << 27):
    """The SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t, in its chunked dual form (chunks of ``Q`` steps; the
    sequence padded at the end with steps of dt = 0).  x [B, S, H, P],
    dt [B, S, H], A [H], Bm / Cm [B, S, G, N]; float32 throughout."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    pad = -S % Q
    if pad:
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                         for t in (x, dt, Bm, Cm))
    nc = (S + pad) // Q
    per_chunk = B_ * Q * Q * H
    group = max(1, min(nc, budget // per_chunk))
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, nc, group):
        c1 = min(nc, c0 + group)
        c = c1 - c0
        sl = slice(c0 * Q, c1 * Q)
        xc = x[:, sl].reshape(B_, c, Q, H, P)
        dtc = dt[:, sl].reshape(B_, c, Q, H)
        Bc = Bm[:, sl].reshape(B_, c, Q, G, N).repeat_interleave(rep, dim=3)
        Cc = Cm[:, sl].reshape(B_, c, Q, G, N).repeat_interleave(rep, dim=3)
        seg = torch.cumsum(dtc * A, dim=2)                   # [B,c,Q,H]
        diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]
        decay = torch.exp(diff.masked_fill(~mask[None, None, :, :, None],
                                           float("-inf")))
        scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * decay \
            * dtc[:, :, None, :, :]
        y = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)
        last = seg[:, :, -1, :]                              # [B,c,H]
        w = dtc * torch.exp(last[:, :, None, :] - seg)
        states = torch.einsum("bcjhn,bcjhp->bchpn", Bc, xc * w[..., None])
        befores = []
        for j in range(c):
            befores.append(h)
            h = h * torch.exp(last[:, j])[:, :, None, None] + states[:, j]
        hb = torch.stack(befores, dim=1)                     # [B,c,H,P,N]
        y = y + torch.einsum("bcihn,bchpn->bcihp",
                             Cc * torch.exp(seg)[..., None], hb)
        ys.append(y.reshape(B_, c * Q, H, P))
    return torch.cat(ys, dim=1)[:, :S]


def ssm(p, h, m, mm):
    B, S, d = h.shape
    di = m.get("ssm_expand", 2) * d
    P = m.get("ssm_head_dim", 64)
    H = di // P
    G, N = m.get("ssm_groups", 1), m["ssm_state"]
    z = mm(h, p["wz"])
    xr = mm(h, p["wx"])
    bc = mm(h, p["wbc"])
    dt = mm(h, p["wdt"])
    xc = F.silu(causal_conv(xr, p["conv_x_w"], p["conv_x_b"]))
    bcc = F.silu(causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"]))
    xs = xc.reshape(B, S, H, P)
    Bm = bcc[..., :G * N].reshape(B, S, G, N)
    Cm = bcc[..., G * N:].reshape(B, S, G, N)
    dt = F.softplus(dt + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y = ssd_scan(xs, dt, A, Bm, Cm, m.get("ssm_chunk", 256))
    y = y + p["D"].float()[None, None, :, None] * xs
    y = rmsnorm(y.reshape(B, S, di) * F.silu(z), p["inner_norm"],
                m.get("norm_eps", 1e-5))
    return mm(y, p["out_proj"])


def mlp(p, h, mm, rows: int = 16384):
    """SwiGLU over the rows of ``h``, ``rows`` at a time."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    out = [mm(F.silu(mm(c, p["w_gate"])) * mm(c, p["w_up"]), p["w_down"])
           for c in x.split(rows)]
    return torch.cat(out).reshape(shape)


class Routing:
    """Top-k expert choices ``[T, k]`` by MoE layer (``(block, slot key)``).
    ``chosen`` records the choices each layer made; with ``forced``, each
    layer routes to ``forced[layer]`` instead, and ``outside[layer]``
    holds, for every routed slot, how far its expert's router logit lies
    below the layer's own k-th best (0 where it is among the top k)."""

    def __init__(self, forced: dict | None = None) -> None:
        self.forced = forced
        self.chosen: dict = {}
        self.outside: dict = {}


def moe_layer_keys(m: dict) -> list[tuple[int, str]]:
    """The MoE layers in the order a forward pass reaches them."""
    return [(i, key) for i in range(n_blocks(m))
            for key, kind in slot_keys(m) if kind == "moe"]


def moe(p, h, m, mm, routing: Routing | None = None, layer=None):
    """``(y, lb, z)``: the top-k mixture and its two auxiliary terms."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    T, E, k = x.shape[0], m["moe_experts"], m["moe_top_k"]
    logits = mm(x, p["router"])
    probs = torch.softmax(logits, dim=-1)
    top, experts = torch.topk(probs, k, dim=-1)
    if routing is not None:
        routing.chosen[layer] = experts.detach()
        if routing.forced is not None:
            forced = routing.forced[layer].to(x.device).long()
            lg = logits.detach()
            kth = lg.topk(k, dim=-1).values[:, -1:]
            routing.outside[layer] = (kth - lg.gather(-1, forced)
                                      ).clamp_min(0)
            experts = forced
            top = probs.gather(-1, experts)
    weights = top / top.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = experts.reshape(-1)
    token = torch.arange(T, device=x.device).repeat_interleave(k)
    wflat = weights.reshape(-1)
    out = torch.zeros_like(x)
    for e in range(E):
        sel = (flat == e).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        rows = x[token[sel]]
        y = mlp({"w_gate": p["w_gate"][e], "w_up": p["w_up"][e],
                 "w_down": p["w_down"][e]}, rows, mm)
        out = out.index_add(0, token[sel], y * wflat[sel, None])
    load = F.one_hot(experts, E).float().sum(dim=(0, 1)) / (T * k)
    lb = E * torch.sum(load * probs.mean(dim=0))
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return out.reshape(shape), lb, z


def block(params, m, i: int, x, mm, routing: Routing | None = None):
    """Block ``i`` of the pattern on the residual stream: ``(x, lb, z)``."""
    eps = m.get("norm_eps", 1e-5)
    lb = z = torch.zeros((), device=x.device)
    for key, kind in slot_keys(m):
        p = {n: t[i] for n, t in params["blocks"][key].items()}
        h = rmsnorm(x, p["norm_scale"], eps)
        if kind == "attn":
            x = x + attention(p, h, m, mm)
        elif kind == "ssm":
            x = x + ssm(p, h, m, mm)
        elif kind == "mlp":
            x = x + mlp(p, h, mm)
        else:
            y, a, b = moe(p, h, m, mm, routing, (i, key))
            x, lb, z = x + y, lb + a, z + b
    return x, lb, z


def hidden(params, m, tokens, mm=mm_f32, remat: bool = False,
           routing: Routing | None = None):
    """The final normed hidden states [B, S, d] and the MoE terms summed
    over the MoE layers."""
    x = params["embed"][tokens.long()].float()
    lb = z = torch.zeros((), device=x.device)
    for i in range(n_blocks(m)):
        if remat:
            x, a, b = checkpoint(block, params, m, i, x, mm, routing,
                                 use_reentrant=False)
        else:
            x, a, b = block(params, m, i, x, mm, routing)
        lb, z = lb + a, z + b
    return rmsnorm(x, params["final_norm"], m.get("norm_eps", 1e-5)), lb, z


def head(params, m):
    return params["embed"].T if m.get("tie_embeddings") else params["head"]


def moe_layers(m: dict) -> int:
    return sum(f == "moe" for _, f in pattern(m)) * n_blocks(m)


def loss(params, m, batch, mm=mm_f32, routing: Routing | None = None):
    """Next-token cross-entropy over the real vocabulary, plus the MoE
    terms as the configuration's training loss weighs them."""
    x, lb, z = hidden(params, m, batch["tokens"], mm, remat=True,
                      routing=routing)
    logits = mm(x, head(params, m))[..., :m["vocab"]]
    labels = batch["labels"].long()
    nll = torch.logsumexp(logits, dim=-1) \
        - logits.gather(-1, labels[..., None])[..., 0]
    ce = nll.mean()
    n = moe_layers(m)
    if n:
        return ce + LB_COEF * lb / n + Z_COEF * z / n
    return ce


@torch.no_grad()
def logits_at(params, m, tokens, first: int, mm=mm_f32):
    """Logits [B, S - first, vocab] of positions ``first ..`` of ``tokens``
    [B, S] (each position's prediction of the next token)."""
    x, _, _ = hidden(params, m, tokens, mm)
    return mm(x[:, first:], head(params, m))[..., :m["vocab"]]


# -- the weight tree, how each leaf is made, the parameter count --------------

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
    """The weight tree's shapes, in the order the leaves are drawn."""
    vp, d, nb = vocab_padded(m), m["d_model"], n_blocks(m)
    out: dict = {"embed": (vp, d), "final_norm": (d,), "blocks": {}}
    if not m.get("tie_embeddings"):
        out["head"] = (d, vp)
    for key, kind in slot_keys(m):
        out["blocks"][key] = {n: (nb, *s)
                              for n, s in slot_shapes(m, kind).items()}
    return out


def std_of(m: dict, path: str) -> float:
    name = path.rsplit("/", 1)[-1]
    if name.startswith("conv"):
        return 0.1
    if name == "wo" or (name == "w_down" and path.split("/")[-2].endswith(
            "_mlp")):
        return 0.02 / math.sqrt(2 * m["n_layers"])
    return 0.02


def init(m: dict, path: str) -> float | str:
    """How leaf ``path`` ("blocks/L0_attn/wq") is made: its normal draw's
    std, or ``"ones"``, ``"zeros"``, ``"A_log"`` (log 1..H) or
    ``"dt_bias"`` (the inverse softplus of a log-uniform dt)."""
    name = path.rsplit("/", 1)[-1]
    if name in ONES:
        return "ones"
    if name in ZEROS:
        return "zeros"
    if name in ("A_log", "dt_bias"):
        return name
    return std_of(m, path)


def keeps_f32(path: str) -> bool:
    """Leaf ``path`` is served in float32 whatever the compute dtype."""
    return path.rsplit("/", 1)[-1] in KEEP_F32


def param_count(m: dict, active_only: bool = False) -> int:
    """Parameters (or those active per token), embeddings included."""
    d, ff = m["d_model"], m.get("d_ff", 0)
    hd = head_dim(m) if m.get("n_heads") else 0
    n = m["vocab"] * d * (1 if m.get("tie_embeddings") else 2)
    e_ff = m.get("moe_d_ff") or ff
    di = m.get("ssm_expand", 2) * d
    groups, state = m.get("ssm_groups", 1), m.get("ssm_state", 0)
    ssm_heads = di // m.get("ssm_head_dim", 64)
    conv_dim = di + 2 * groups * state
    in_proj = 2 * di + 2 * groups * state + ssm_heads
    attn = (d * m.get("n_heads", 0) * hd + 2 * d * m.get("n_kv_heads", 0) * hd
            + m.get("n_heads", 0) * hd * d + d)
    mlp = 3 * d * ff + d
    experts = m.get("moe_top_k", 0) if active_only else m.get("moe_experts", 0)
    moe = d * m.get("moe_experts", 0) + experts * 3 * d * e_ff + d
    ssm = (d * in_proj + conv_dim * m.get("ssm_conv", 4) + conv_dim
           + 3 * ssm_heads + di * d + di + d)
    slots = pattern(m)
    blocks = m["n_layers"] // len(slots)
    for mixer, ffn in slots:
        n += blocks * (attn if mixer == "attn" else ssm)
        if ffn == "mlp":
            n += blocks * mlp
        elif ffn == "moe":
            n += blocks * moe
    return n + d
