"""Model configuration covering all assigned architecture families.

One frozen dataclass describes dense / GQA / MoE / SSM / hybrid / enc-dec /
VLM-backbone LMs.  A config compiles to a *layer pattern*: a short list of
(mixer, ffn) slot specs that repeats every ``period`` layers; parameters are
stacked per slot over pattern repetitions (blocks), and the assemblies loop
over the blocks.

The same dataclass as the JAX package's, with one deliberate difference:
the implementation switches default to the hand-written Hopper kernels, so
that the normal entry points run them.

- ``attention_impl`` takes ``"cuda" | "blocked" | "dense"`` and defaults to
  ``"cuda"`` (flash attention for the prefill, split-K decode attention for
  each decode step).  ``"pallas"``, the JAX package's name for its kernel
  path, is read as ``"cuda"``.
- ``moe_impl`` takes ``"gmm" | "ragged" | "dense" | "gathered" | "ep"`` and
  defaults to ``"gmm"``, the grouped-matmul kernel over expert-sorted rows
  (the reference defaults to ``"ragged"``, which reaches no kernel).
  ``"ep"`` is expert parallelism over the ``model`` axis, its experts
  through the same kernel: unsharded, over the mesh given to
  :func:`repro_torch.parallel.ep_moe.set_mesh` (a ``Mesh``: every shard in
  this process; a ``DeviceMesh``: one shard a rank); sharded (``shards=``),
  one participant a rank over its own mesh.
- ``ssm_impl`` (new) takes ``"cuda" | "chunked"`` and defaults to
  ``"cuda"``, the SSD intra-chunk kernel; ``"chunked"`` is the reference's
  plain chunked form.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

#: ``"cuda"``: the hand-written kernels; the other two are plain PyTorch.
ATTENTION_IMPLS = ("cuda", "blocked", "dense")
#: ``"gmm"`` and ``"ep"``: the hand-written grouped matmul; the others are
#: plain PyTorch.
MOE_IMPLS = ("gmm", "ragged", "dense", "gathered", "ep")
#: ``"cuda"``: the hand-written SSD intra-chunk kernel; ``"chunked"`` plain.
SSM_IMPLS = ("cuda", "chunked")


@dataclass(frozen=True)
class LayerSlot:
    mixer: str          # "attn" | "ssm"
    ffn: str | None     # "mlp" | "moe" | None (mamba2 blocks have no FFN)

    @property
    def name(self) -> str:
        return f"{self.mixer}+{self.ffn or 'none'}"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0            # 0 → d_model // n_heads
    rope_theta: float = 1e4
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0            # per-expert hidden; 0 → d_ff
    moe_period: int = 1          # MoE every `period` layers...
    moe_offset: int = 0          # ...at indices ≡ offset (mod period)
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (Jamba): attention layers at period/offset, else SSM ---
    attn_period: int = 0
    attn_offset: int = 0
    # --- encoder-decoder ---
    enc_layers: int = 0          # >0 ⇒ enc-dec; n_layers is the decoder depth
    # --- modality frontend stubs (DESIGN.md: precomputed embeddings) ---
    frontend: str | None = None  # "patch_embed" | "frame_embed"
    frontend_tokens: int = 0     # e.g. 1024 ViT patches prepended to text
    # --- numerics / implementation switches ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attention_impl: str = "cuda"     # cuda | blocked | dense
    moe_impl: str = "gmm"            # gmm | ragged | dense | gathered | ep
    ssm_impl: str = "cuda"           # cuda | chunked
    remat: bool = True
    # Dry-run cost extraction: XLA cost analysis counts while-loop bodies
    # once, so depth-linear extrapolation compiles small UNROLLED variants
    # (scan_blocks=False, attention_unroll=True) — see launch/dryrun.py.
    scan_blocks: bool = True
    attention_unroll: bool = False

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.attention_impl == "pallas":
            object.__setattr__(self, "attention_impl", "cuda")
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- derived dims ----------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Vocab rounded to a 128 multiple: TPU-lane friendly and divisible
        by the 16-way model axis (embedding/head sharding).  Padded logit
        columns are masked to -inf in the loss/sampling paths."""
        return (self.vocab + 127) // 128 * 128

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def in_proj_dim(self) -> int:
        # [z, x, B, C, dt]
        return 2 * self.d_inner + 2 * self.ssm_groups * self.ssm_state + self.ssm_heads

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    # -- layer pattern -----------------------------------------------------
    def pattern(self) -> list[LayerSlot]:
        """The repeating slot pattern; len(pattern) divides n_layers."""
        if self.family == "ssm":
            return [LayerSlot("ssm", None)]
        period = 1
        if self.attn_period:
            period = math.lcm(period, self.attn_period)
        if self.moe_experts and self.moe_period > 1:
            period = math.lcm(period, self.moe_period)
        slots = []
        for i in range(period):
            if self.attn_period:
                mixer = "attn" if i % self.attn_period == self.attn_offset else "ssm"
            else:
                mixer = "attn"
            if self.moe_experts and i % self.moe_period == self.moe_offset % self.moe_period:
                ffn = "moe"
            else:
                ffn = "mlp"
            slots.append(LayerSlot(mixer, ffn))
        return slots

    @property
    def n_blocks(self) -> int:
        period = len(self.pattern())
        if self.n_layers % period:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern period={period}"
            )
        return self.n_layers // period

    def validate(self) -> "ModelConfig":
        _ = self.n_blocks
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"{self.name}: attention_impl={self.attention_impl!r} is not "
                f"one of {ATTENTION_IMPLS}"
            )
        for name, value, allowed in (("moe_impl", self.moe_impl, MOE_IMPLS),
                                     ("ssm_impl", self.ssm_impl, SSM_IMPLS)):
            if value not in allowed:
                raise ValueError(f"{self.name}: {name}={value!r} is not one "
                                 f"of {allowed}")
        if self.family in ("dense", "moe", "hybrid", "encdec", "vlm") and not self.n_heads:
            raise ValueError(f"{self.name}: attention family requires n_heads")
        if self.n_heads and self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads must be divisible by n_kv_heads")
        if self.moe_experts and not self.moe_top_k:
            raise ValueError(f"{self.name}: MoE requires top_k")
        return self

    # -- parameter counts (roofline MODEL_FLOPS = 6·N·D) --------------------
    def param_count(self, active_only: bool = False) -> int:
        """Total (or active-per-token) parameter count, embeddings included."""
        d, ff = self.d_model, self.d_ff
        n = 0
        embed = self.vocab * d
        n += embed if self.tie_embeddings else 2 * embed

        def attn_params() -> int:
            qkv = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim
            out = self.n_heads * self.head_dim * d
            return qkv + out + d  # + norm

        def mlp_params(hidden: int) -> int:
            return 3 * d * hidden + d

        def moe_params() -> int:
            e = self.moe_top_k if active_only else self.moe_experts
            return d * self.moe_experts + e * 3 * d * self.expert_d_ff + d

        def ssm_params() -> int:
            return (
                d * self.in_proj_dim
                + self.conv_dim * self.ssm_conv + self.conv_dim
                + 3 * self.ssm_heads       # A_log, D, dt_bias
                + self.d_inner * d
                + self.d_inner + d          # inner norm + layer norm
            )

        per_slot = {"attn": attn_params, "ssm": ssm_params}
        for slot in self.pattern():
            blocks = self.n_blocks
            n += blocks * per_slot[slot.mixer]()
            if slot.ffn == "mlp":
                n += blocks * mlp_params(ff)
            elif slot.ffn == "moe":
                n += blocks * moe_params()
        if self.enc_layers:
            # encoder: self-attn + mlp per layer; decoder adds cross-attn.
            n += self.enc_layers * (attn_params() + mlp_params(ff))
            n += self.n_layers * attn_params()  # cross-attention in decoder
        n += d  # final norm
        return n


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (instantiates + steps)."""
    pattern_len = len(cfg.pattern())
    layers = max(pattern_len, 2 if pattern_len == 1 else pattern_len)
    overrides = dict(
        n_layers=layers,
        d_model=64,
        vocab=256,
        d_ff=128 if cfg.d_ff else 0,
        rope_theta=1e4,
        dtype="float32",
        param_dtype="float32",
        attention_impl="dense",
        moe_impl="ragged",
        ssm_impl="chunked",
        remat=False,
    )
    if cfg.n_heads:
        overrides.update(n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)), head_dim=16)
    if cfg.moe_experts:
        overrides.update(moe_experts=4, moe_top_k=min(cfg.moe_top_k, 2), moe_d_ff=32)
    if cfg.ssm_state:
        overrides.update(ssm_state=16, ssm_head_dim=8, ssm_chunk=8, ssm_expand=2)
    if cfg.enc_layers:
        overrides.update(enc_layers=2)
    if cfg.frontend_tokens:
        overrides.update(frontend_tokens=8)
    return replace(cfg, name=cfg.name + "-smoke", **overrides).validate()
