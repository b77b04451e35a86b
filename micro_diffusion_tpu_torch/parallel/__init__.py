"""The parallel layer of the port (counterpart of micro_diffusion_tpu/parallel/):
the (data, fsdp, tensor) process mesh, the sharding rules and ZeRO-2."""

from .mesh import (AXES, BATCH_AXES, DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, Mesh, Shard,
                   batch_sharding, init_distributed, make_mesh, make_multislice_mesh,
                   replicated_sharding)
from .sharding import (Zero2, gather_full, local_slice, opt_state_shardings,
                       opt_state_spec, param_shardings, param_spec, shard_params)

__all__ = [
    "AXES", "BATCH_AXES", "DATA_AXIS", "FSDP_AXIS", "TENSOR_AXIS", "Mesh", "Shard",
    "batch_sharding", "init_distributed", "make_mesh", "make_multislice_mesh",
    "replicated_sharding", "Zero2", "gather_full", "local_slice", "opt_state_shardings",
    "opt_state_spec", "param_shardings", "param_spec", "shard_params",
]
