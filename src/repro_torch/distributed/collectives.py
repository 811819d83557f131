"""Explicit collective helpers on torch.distributed process groups.

The reference's distributed/collectives.py (shard_map level), on the groups
of a DeviceMesh (`mesh.get_group(name)`):

  - compressed_psum: int8-quantized all-reduce (a quarter of f32's wire
    bytes) with one shared scale: a MAX all-reduce of the per-rank scales,
    then a SUM all-reduce of the int32 quanta, which is exact;
  - dp_mean_grads_compressed: the data-parallel mean of a tree of tensors
    through compressed_psum on the mesh's data group;
  - ring_allgather: an all-gather as a ring of point-to-point exchanges
    (batch_isend_irecv), the sharded integrator's building block where a
    monolithic all-gather cannot overlap with compute.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def compressed_psum(x: torch.Tensor, group=None, num_devices=None) -> torch.Tensor:
    """int8 all-reduce with a per-tensor scale, over `group` (the default
    group when None), divided by num_devices (the group's size when None).

    Each rank quantizes its contribution to int8 steps of the largest of the
    ranks' scales (max |x| / 127, f32), so the int32 sum is exact for up to
    2^23 / 127 ranks; the result is dequantized with that scale. Returns f32."""
    n = dist.get_world_size(group) if num_devices is None else num_devices
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)  # shared scale
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return (q.to(torch.float32) * scale) / n


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def dp_mean_grads_compressed(mesh, grads, axis_name: str = "data"):
    """Data-parallel mean of `grads` (a dict / list / tuple tree of tensors,
    each rank holding its local sum) with an int8 wire format over the mesh
    dim `axis_name`. Returns the dequantized mean on every rank, one
    compressed_psum per leaf in the tree's order."""
    group = mesh.get_group(axis_name)
    n = int(mesh.shape[tuple(mesh.mesh_dim_names).index(axis_name)])
    return _tree_map(lambda t: compressed_psum(t, group, n), grads)


def ring_allgather(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-gather along `group` as a ring: n - 1 rounds, each sending the
    block received last to the next group rank and receiving from the
    previous one. Returns (n, *x.shape), block j from group rank j: the
    blocks arrive in the order i, i-1, ... and are rotated to that order."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n) if group is not None else (me + 1) % n
    prv = dist.get_global_rank(group, (me - 1) % n) if group is not None else (me - 1) % n
    chunks, buf = [x], x.contiguous()
    for _ in range(n - 1):
        recv = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, nxt, group), dist.P2POp(dist.irecv, recv, prv, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        chunks.append(recv)
        buf = recv
    # chunks[s] came from group rank (me - s) % n
    order = [(me - j) % n for j in range(n)]
    return torch.stack([chunks[s] for s in order])
