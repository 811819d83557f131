"""Meshes for the port's data-parallel training, sharded plans and dry run,
and the card's rates for the roofline.

`make_mesh(shape, axes, device_type)` builds a DeviceMesh over the ranks of
the process group the caller has initialised (torch.distributed; under
`torchrun` that is `init_process_group` with the RANK / WORLD_SIZE /
LOCAL_RANK it sets; in a dry run, the fake group of launch/dryrun.fake_world).
`make_production_mesh` is the production layout: 256 H100s, 32 HGX nodes of 8
cards, with the "model" axis inside a node's NVLink domain. Both are
functions, so importing this module touches no device or process group.

`HW` holds one H100 SXM5 80 GB's dense rates (no sparsity) for
launch/roofline.py, and HW_VARIANTS the PCIe and NVL parts, keyed by a
fragment of the name `torch.cuda.get_device_name` gives (`hw_for`). A
cluster has two link tiers, so there are two link rates: collectives over
the "model" group run on NVLink (`nvlink_bw`), over "data" or "pod" on the
nodes' network (`net_bw`).
"""

from __future__ import annotations


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A DeviceMesh of `shape` with dim names `axes` over the current
    process group's ranks, in rank order."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False):
    """(shape, axes) of the production mesh: 32 nodes x 8 cards, two such
    clusters with multi_pod."""
    if multi_pod:
        return (2, 32, 8), ("pod", "data", "model")
    return (32, 8), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh (`production_shape`) over the current process
    group, which must have 256 ranks (512 with multi_pod)."""
    return make_mesh(*production_shape(multi_pod), device_type=device_type)


# NVIDIA H100 Tensor Core GPU data sheet, SXM5 80 GB, dense rates.
HW = {
    "peak_flops_bf16": 989e12,  # bf16 / fp16 tensor cores, FLOP/s
    "peak_flops_f32": 67e12,  # FP32 outside the tensor cores, FLOP/s
    "hbm_bw": 3.35e12,  # HBM3, bytes/s
    "hbm_bytes": 80e9,  # HBM3 capacity, bytes
    "nvlink_bw": 450e9,  # NVLink 4: 900 GB/s a card in both directions, bytes/s each way
    # NVIDIA DGX / HGX H100 reference design: one ConnectX-7 NIC of 400 Gb/s a GPU
    "net_bw": 50e9,
}

# The other two parts, from the same data sheet; the network is the HGX
# design's for all three.
HW_VARIANTS = {
    "PCIe": dict(HW, peak_flops_bf16=756e12, peak_flops_f32=51.2e12, hbm_bw=2.0e12,
                 hbm_bytes=80e9, nvlink_bw=300e9),  # HBM2e; NVLink bridge 600 GB/s both ways
    "NVL": dict(HW, peak_flops_bf16=835e12, peak_flops_f32=60e12, hbm_bw=3.9e12,
                hbm_bytes=94e9, nvlink_bw=300e9),  # HBM3 94 GB; NVLink bridge 600 GB/s
    "": HW,  # SXM5
}


def hw_for(name: str) -> dict:
    """The rates of the part whose name fragment `name` contains (the SXM5
    part's when none does)."""
    for fragment, hw in HW_VARIANTS.items():
        if fragment in name:
            return hw
    raise AssertionError("unreachable: the empty fragment matches every name")
