"""Architecture registry: the 10 assigned configs + input-shape sets.

Every (arch × shape) cell of the dry-run matrix is defined here; shapes are
the LM-family set (train_4k / prefill_32k / decode_32k / long_500k) with the
sub-quadratic gate on long_500k (DESIGN.md §4).
"""
from __future__ import annotations

from dataclasses import dataclass
from importlib import import_module

from ..models.config import ModelConfig

ARCH_IDS = [
    "codeqwen1_5_7b",
    "glm4_9b",
    "granite_3_8b",
    "granite_8b",
    "seamless_m4t_medium",
    "granite_moe_1b_a400m",
    "olmoe_1b_7b",
    "mamba2_130m",
    "jamba_v0_1_52b",
    "internvl2_26b",
]

# CLI-facing ids (dashes) → module names (underscores)
def _norm(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    mod = import_module(f"repro_torch.configs.{_norm(arch)}")
    return mod.CONFIG.validate()


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Archs with sub-quadratic sequence mixing (may run long_500k).
SUBQUADRATIC = {"mamba2_130m", "jamba_v0_1_52b"}


def shapes_for(arch: str) -> list[ShapeSpec]:
    arch = _norm(arch)
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if arch in SUBQUADRATIC:
        out.append(SHAPES["long_500k"])
    return out


def cells() -> list[tuple[str, ShapeSpec]]:
    """All runnable (arch, shape) dry-run cells; skipped cells are the
    long_500k rows of pure full-attention archs (DESIGN.md §4)."""
    return [(a, s) for a in ARCH_IDS for s in shapes_for(a)]


def skipped_cells() -> list[tuple[str, str, str]]:
    return [
        (a, "long_500k", "pure full-attention arch: 500k dense decode is the "
                          "quadratic regime the shape excludes")
        for a in ARCH_IDS if a not in SUBQUADRATIC
    ]
