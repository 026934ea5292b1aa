"""Hand-written Hopper kernels for the package's compute hot spots.

Each kernel ships a CUDA C++ source under ``csrc/`` (plain C interface,
built with ``nvcc`` for ``sm_90a`` by :mod:`repro_torch.kernels.build` at
first use) and a module with its wrapper, its launch counter and its
plain PyTorch version.  Nothing is compiled when a module is imported.
The attention modules keep their wrapper's name (``flash_attention``,
``decode_attention``), so the package attribute of that name is the
module, with its ``LAUNCHES`` counter; the model-layout entry points are
:func:`mha_flash` and :func:`mha_decode`.
"""
from . import decode_attention, flash_attention
from .bigroots_gates import eval_gates, eval_gates_torch, gates_launch
from .decode_attention import decode_attention_torch
from .flash_attention import flash_attention_torch
from .ops import mha_decode, mha_flash

__all__ = ["decode_attention", "decode_attention_torch", "eval_gates",
           "eval_gates_torch", "flash_attention", "flash_attention_torch",
           "gates_launch", "mha_decode", "mha_flash"]
