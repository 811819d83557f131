"""Meshes for the port's data-parallel training and sharded plans.

`make_mesh(shape, axes, device_type)` builds a DeviceMesh over the ranks of
the process group the caller has initialised (torch.distributed; under
`torchrun` that is `init_process_group` with the RANK / WORLD_SIZE /
LOCAL_RANK it sets). It is a function, so importing this module touches no
device or process group.

The reference's `make_production_mesh` (a 16 x 16 TPU pod, two with
multi_pod) and `HW` (TPU v5e peak rates for its roofline) are not carried:
they describe TPU hardware. The card's own numbers come with the roofline
of ROADMAP queue 1 item 13i.
"""

from __future__ import annotations


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A DeviceMesh of `shape` with dim names `axes` over the current
    process group's ranks, in rank order."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
