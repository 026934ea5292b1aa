"""Distribution: gradient compression.

Only what is ported: int8 block quantization with error feedback.  The
reference's sharding rules, ``compressed_allreduce_mean`` and pipeline
parallelism wait for a later slice of the port."""
from .compress import (
    Quantized,
    dequantize,
    ef_compress,
    ef_init,
    quantization_error,
    quantize,
)

__all__ = [
    "Quantized",
    "dequantize",
    "ef_compress",
    "ef_init",
    "quantization_error",
    "quantize",
]
