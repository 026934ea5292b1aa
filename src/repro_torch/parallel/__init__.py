"""Distribution: sharding rules, gradient compression, pipeline parallelism
and expert-parallel MoE.

On one device the parallel layers run the reference's per-shard bodies over
a list of the shards' tensors (:mod:`.collectives`); a form over
``torch.distributed`` process groups waits for a machine with more than
one card."""
from .compress import (
    Quantized,
    compressed_allreduce_mean,
    dequantize,
    ef_compress,
    ef_init,
    quantization_error,
    quantize,
)
from .sharding import (
    NamedSharding,
    batch_specs,
    cache_shardings,
    cache_spec_for_kv,
    dp_axes,
    dp_size,
    model_size,
    param_shardings,
    param_spec,
    placements,
)

__all__ = [
    "NamedSharding",
    "Quantized",
    "batch_specs",
    "cache_shardings",
    "cache_spec_for_kv",
    "compressed_allreduce_mean",
    "dequantize",
    "dp_axes",
    "dp_size",
    "ef_compress",
    "ef_init",
    "model_size",
    "param_shardings",
    "param_spec",
    "placements",
    "quantization_error",
    "quantize",
]
