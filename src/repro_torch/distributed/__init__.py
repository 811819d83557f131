"""The distribution layer on torch.distributed: the sharded reservoir's
layouts (`sharding.reservoir_specs`) and the explicit collectives
(`collectives`). A mesh is a `torch.distributed.device_mesh.DeviceMesh`
with `mesh_dim_names`, built by the caller after `init_process_group`."""

from repro_torch.distributed.sharding import axis_size, reservoir_specs

__all__ = ["axis_size", "reservoir_specs"]
