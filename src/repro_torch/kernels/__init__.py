"""Hand-written Hopper kernels for the package's compute hot spots.

Each kernel ships a CUDA C++ source under ``csrc/`` (plain C interface,
built with ``nvcc`` for ``sm_90a`` by :mod:`repro_torch.kernels.build` at
first use) and a module with its wrapper, its launch counter and its
plain PyTorch version.  Nothing is compiled when a module is imported.
The attention modules keep their wrapper's name (``flash_attention``,
``decode_attention``), so the package attribute of that name is the
module, with its ``LAUNCHES`` counter, as are ``moe_gmm`` (function
``grouped_matmul``) and ``ssd_scan`` (function ``ssd_intra_chunk``); the
model-layout entry points are :func:`mha_flash`, :func:`mha_decode`,
:func:`moe_gmm_ffn` and :func:`ssd_chunked_cuda`.  The forward kernels of
the training path (flash attention, the SSD intra-chunk, the grouped
matmul) are differentiable: their gradient is their plain version's
(:mod:`.grad`), but for the grouped matmul's on bfloat16 CUDA tensors, which
is two backward kernels of its own (``moe_gmm.KernelGradient``).
"""
from . import decode_attention, flash_attention, moe_gmm, ssd_scan
from .bigroots_gates import eval_gates, eval_gates_torch, gates_launch
from .decode_attention import decode_attention_torch
from .flash_attention import flash_attention_torch
from .moe_gmm import grouped_matmul_torch
from .ops import mha_decode, mha_flash, moe_gmm_ffn, ssd_chunked_cuda
from .ssd_scan import ssd_intra_chunk_torch

__all__ = ["decode_attention", "decode_attention_torch", "eval_gates",
           "eval_gates_torch", "flash_attention", "flash_attention_torch",
           "gates_launch", "grouped_matmul_torch", "mha_decode", "mha_flash",
           "moe_gmm", "moe_gmm_ffn", "ssd_chunked_cuda", "ssd_intra_chunk_torch",
           "ssd_scan"]
