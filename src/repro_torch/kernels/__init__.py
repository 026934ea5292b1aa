"""Hand-written Hopper kernels for the package's compute hot spots.

Each kernel ships a CUDA C++ source under ``csrc/`` (plain C interface,
built with ``nvcc`` for ``sm_90a`` by :mod:`repro_torch.kernels.build` at
first use) and a module with its wrapper, its launch counter and its
plain PyTorch version.  Nothing is compiled when a module is imported.
"""
from .bigroots_gates import eval_gates, eval_gates_torch, gates_launch

__all__ = ["eval_gates", "eval_gates_torch", "gates_launch"]
