"""The distribution layer on torch.distributed: layouts (`sharding`: the
sharded reservoir's `reservoir_specs`, the LM's `param_specs`,
`batch_specs`, `cache_spec_for`) and the explicit collectives
(`collectives`). A mesh is a `torch.distributed.device_mesh.DeviceMesh`
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

__all__ = [
    "AbstractMesh", "axis_size", "axis_sizes", "batch_specs", "cache_spec_for", "param_specs",
    "reservoir_specs",
]
