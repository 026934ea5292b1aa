"""Distribution: sharding rules, gradient compression, pipeline parallelism
and expert-parallel MoE.

The parallel layers run the reference's per-shard bodies over the shards
they are given (:mod:`.collectives`): a bare ``Mesh`` runs every shard in
this process, a list of their tensors on one device (the list form); a
``torch.distributed`` ``DeviceMesh`` runs one shard a rank, the
collectives over its process groups (the rank form, :mod:`.dist`; ranks
join with :func:`repro_torch.launch.mesh.init_ranks`).  Both forms give
the same bits."""
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
