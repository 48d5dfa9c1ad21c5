"""The device mesh, chain sharding, tensor parallelism over the mesh's
model axis and the process group of data-parallel training: the JAX
package's parallel/."""
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, data_sharding,
                   replicated, shard_batch, replicate, pad_to_multiple,
                   tp_sharding, shard_tp)
from .ensemble import (repeat_measurement, ensemble_keys, shard_chain_axis,
                       run_sharded_ensemble, ensemble_mean_std)
from .distributed import (initialize_distributed, is_primary,
                          local_batch_slice)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "make_mesh", "data_sharding", "replicated",
    "shard_batch", "replicate", "pad_to_multiple", "tp_sharding",
    "shard_tp", "repeat_measurement", "ensemble_keys", "shard_chain_axis",
    "run_sharded_ensemble", "ensemble_mean_std", "initialize_distributed",
    "is_primary", "local_batch_slice",
]
