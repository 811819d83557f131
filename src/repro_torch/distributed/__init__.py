"""The distribution layer on torch.distributed: layouts (`sharding`: the
sharded reservoir's `reservoir_specs`, the LM's `param_specs`,
`batch_specs`, `cache_spec_for`), the explicit collectives
(`collectives`) and the LM's tensor parallelism over a mesh's "model" axis
(`tensor_parallel`: the Megatron collectives with their gradients, a rank's
blocks of whole leaves, what the axis does not run yet). A mesh is a `torch.distributed.device_mesh.DeviceMesh`
with `mesh_dim_names`, built by the caller after `init_process_group`
(launch/mesh.make_mesh), or an `AbstractMesh` for layouts alone."""

from repro_torch.distributed.sharding import (
    AbstractMesh,
    axis_size,
    axis_sizes,
    batch_specs,
    cache_spec_for,
    param_specs,
    reservoir_specs,
)
from repro_torch.distributed import tensor_parallel
from repro_torch.distributed.tensor_parallel import (
    check_supported,
    copy_to_model,
    gather_from_model,
    gather_leaf,
    reduce_from_model,
    shard_params,
)

__all__ = [
    "AbstractMesh", "axis_size", "axis_sizes", "batch_specs", "cache_spec_for",
    "check_supported", "copy_to_model", "gather_from_model", "gather_leaf", "param_specs",
    "reduce_from_model", "reservoir_specs", "shard_params", "tensor_parallel",
]
