"""BigRoots straggler root-cause analysis — the PyTorch/CUDA package.

The per-tick fleet diagnosis sweep on an NVIDIA Hopper GPU: telemetry
wire format and transport, merged sliding windows, the batched Eq. 5
gate kernel (hand-written CUDA, :mod:`repro_torch.kernels`), the
host-side Eq. 6/7 finish, the what-if replay and the forecast recurrent
step; and the workload it diagnoses, served (:mod:`repro_torch.serve`)
and trained (:mod:`repro_torch.launch.train`).  Entry points run on the
GPU unless the caller names the CPU
(:func:`repro_torch.device.resolve_device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
