"""Tensor parallelism over a mesh's "model" axis, in the Megatron pattern.

The reference shards its LM over "model" with GSPMD (param_shardings and
with_sharding_constraint); the port runs the same layouts with explicit
collectives on the mesh's "model" group. Each rank holds its BLOCK of every
parameter (`shard_params`: the slice `sharding.param_specs` gives it) as a
plain tensor, and the model code reads its local widths (q and kv heads,
d_ff, experts, vocab rows) from its blocks' shapes. Collectives:

  copy_to_model       the identity forward, an all-reduce of the gradient
                      backward: the input of a column-parallel region (and a
                      replicated tensor that a region consumes in part, such
                      as a q / k / v bias sliced to the rank's columns)
  reduce_from_model   an all-reduce forward, the identity backward: the
                      output of a row-parallel region
  gather_from_model   an all-gather forward, the rank's slice of the
                      gradient backward (the whole result is then
                      replicated; a rank-partial consumer puts copy_to_model
                      after it): only where a layout splits a head (k / v
                      when the kv heads do not divide the axis) or the
                      embedding falls back to d_model

Every sum runs in f32 and casts once: a row-parallel product's partials are
each one GEMM in the operands' dtype (rounded to bf16 on a bf16 model), then
summed in f32, so a bf16 result carries one rounding more than one rank's
GEMM. No reduce-scatter, all-to-all or point-to-point is issued, so gloo
runs every step on CUDA tensors too.

The active axis is set by `using(mesh)` for a block, and the previous one
restored after it: every entry of a model built on a mesh (its loss,
forward, prefill and decode) and every step made on one (whose forward and
backward run in the block, so that a remat period recomputed in the
backward sees it) enters it. A mesh without a "model" dim, one of size 1, or
an AbstractMesh (layouts only) leaves it inactive, and then every function
here is the identity on its input: the one-rank path is unchanged, bit for
bit. Collectives are counted by launch/costs.CostMode, per mesh dim.

Layouts that a contiguous block does not fit are computed otherwise:

  a column-parallel product whose output splits into parts (Mamba's
  in_proj and the mLSTM's up_proj: x | z; the sLSTM's w_gates: i, f, z, o)
  is gathered whole over the axis (`whole_cols`), and each consumer takes
  its block of it (`local_slice`): a rank's contiguous block of such a leaf
  holds x on one rank and z on the other, so the blocks stay the
  reference's slices and the checkpoint, shard and convert code stays leaf
  agnostic, at the cost of one all-gather of the output a layer;
  a layout that replicates heads the axis does not divide (xlstm-125m's 4
  heads on 8 ranks) computes every head on every rank and takes the rank's
  block of d_inner for the row-parallel product;
  a KV cache laid out over the sequence (sharding.cache_spec_for under
  REPRO_KV_SEQ_SHARD) is combined flash-decode style (models/attention.py:
  a MAX and a SUM all-reduce of each rank's partial softmax).

`check_supported(cfg, mesh, serving)` refuses, before any collective, what
the port does not lay out: a config whose q heads, k / v columns, d_ff,
experts, d_inner or MLA heads the axis does not divide (the layout would
replicate what the port computes in blocks), and (serving) a cache over the
sequence whose fallback widths the axis does not divide either, whose
block could not then be told from a replicated cache by its shape. None of
the ten registered archs at model axes 2 and 8.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.distributed import sharding as shd

class ModelAxis(NamedTuple):
    """A mesh's "model" group, this rank's coordinate on it and its size."""

    group: object
    rank: int
    size: int


_AXIS: Optional[ModelAxis] = None


def axis_of(mesh) -> Optional[ModelAxis]:
    """The mesh's model axis, or None where it runs on one rank (no mesh, no
    "model" dim, a size of 1, or an AbstractMesh without process groups)."""
    if mesh is None or "model" not in tuple(mesh.mesh_dim_names):
        return None
    size = shd.axis_sizes(mesh)["model"]
    if size == 1 or not hasattr(mesh, "get_group"):
        return None
    coord = mesh.get_coordinate()
    return ModelAxis(mesh.get_group("model"), int(coord[list(mesh.mesh_dim_names).index("model")]),
                     size)


def active() -> Optional[ModelAxis]:
    return _AXIS


@contextlib.contextmanager
def using(mesh):
    """The mesh's model axis active inside the block (the previous one
    restored after it); `mesh` None leaves the enclosing block's axis."""
    global _AXIS
    before = _AXIS
    if mesh is not None:
        _AXIS = axis_of(mesh)
    try:
        yield _AXIS
    finally:
        _AXIS = before


def size() -> int:
    return 1 if _AXIS is None else _AXIS.size


def rank() -> int:
    return 0 if _AXIS is None else _AXIS.rank


# ---------------------------------------------------------------------------
# what this slice carries
# ---------------------------------------------------------------------------


def _widths(cfg, m) -> dict:
    """{what: width} of the widths the port splits over the model axis, for
    cfg's layer kinds, that an axis of m does not divide."""
    kinds = {s.mixer for s in cfg.layer_kinds()}
    mlps = {s.mlp for s in cfg.layer_kinds()}
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    widths = {}
    if kinds & {"attn", "swa"} or cfg.encoder_layers:
        widths.update({"q heads": h, "k / v columns": kvh * hd})
    if "mla" in kinds:
        widths["MLA heads"] = h
    if "mlp" in mlps or cfg.encoder_layers:
        widths["d_ff"] = cfg.d_ff
    if "mamba" in kinds:
        widths["Mamba d_inner"] = cfg.mamba.expand * cfg.d_model
    if "mlstm" in kinds:
        widths["mLSTM d_inner"] = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
    if cfg.moe is not None and "moe" in mlps:
        widths["experts or expert d_ff"] = (
            cfg.moe.num_experts if cfg.moe.num_experts % m == 0 else cfg.moe.d_ff_expert)
        if cfg.moe.num_shared:
            widths["shared expert d_ff"] = cfg.moe.d_ff_expert * cfg.moe.num_shared
    odd = {k: v for k, v in widths.items() if v % m}
    g, local = h // kvh, h // m
    if "q heads" in widths and kvh % m and local % g and g % local:
        odd["q heads a rank against the GQA group"] = local
    return odd


def check_supported(cfg, mesh, serving: bool = False) -> None:
    """Raise NotImplementedError for a config (or, serving, a KV layout)
    that a model axis wider than 1 would lay out in a way the port does not
    compute (see the module's docstring)."""
    m = 1 if mesh is None else shd.axis_sizes(mesh).get("model", 1)
    if m == 1:
        return
    odd = _widths(cfg, m)
    if odd:
        raise NotImplementedError(
            f"{cfg.name} on a model axis of {m}: {odd} not a multiple of it (the layout would "
            f"replicate or split what the port computes in blocks)")
    if not serving:
        return
    kinds = {s.mixer for s in cfg.layer_kinds()}
    mode = shd.kv_seq_mode()
    if (kinds & {"attn", "swa"} or cfg.encoder_layers) and kv_seq(cfg.num_kv_heads, m) and (
            cfg.num_kv_heads % m and cfg.head_dim % m):
        raise NotImplementedError(
            f"{cfg.name}: a KV cache over the sequence (REPRO_KV_SEQ_SHARD={mode}) whose "
            f"{cfg.num_kv_heads} kv heads and head_dim {cfg.head_dim} a model axis of {m} does "
            f"not divide: a prompt it does not divide either would be replicated")
    if "mla" in kinds and kv_seq(0, m) and (
            cfg.mla.kv_lora_rank % m or cfg.mla.qk_rope_head_dim % m):
        raise NotImplementedError(
            f"{cfg.name}: a latent cache over the sequence (REPRO_KV_SEQ_SHARD={mode}) whose "
            f"kv_lora_rank {cfg.mla.kv_lora_rank} or rope dims {cfg.mla.qk_rope_head_dim} a "
            f"model axis of {m} does not divide")


def kv_seq(kv_heads: int, m: Optional[int] = None) -> bool:
    """sharding.want_kv_seq_shard on a model axis of m (the active axis's
    size by default): whether a KV cache of kv_heads heads (0: MLA's latent
    cache) is laid out over the sequence where the axis divides it."""
    return shd.want_kv_seq_shard(kv_heads, _model_only(size() if m is None else m))


def _model_only(m: int):
    return shd.AbstractMesh((m,), ("model",))


class _Leaf(NamedTuple):
    shape: tuple


def cache_dim(key: str, shape, stacked: bool = False) -> Optional[int]:
    """The dim sharding.cache_spec_for splits over the active model axis in
    a whole cache leaf `key` ("k", "c_kv", "h", ...) of `shape` (batch first;
    stacked: the periods first), or None (no axis, or a layout that keeps it
    whole)."""
    if _AXIS is None:
        return None
    path = ("stack/0/self/" if stacked else "self/") + key
    return model_dim(shd.cache_spec_for(path, _Leaf(tuple(shape)), _model_only(_AXIS.size)))


def cache_block(t: torch.Tensor, key: str, stacked: bool = False) -> torch.Tensor:
    """The rank's block (a new tensor) of a whole cache leaf `key` under
    sharding.cache_spec_for; t itself where the layout keeps it whole."""
    dim = cache_dim(key, t.shape, stacked)
    if dim is None:
        return t
    return local_slice(t, t.shape[dim] // size(), dim).clone()


# ---------------------------------------------------------------------------
# collectives with their gradients
# ---------------------------------------------------------------------------


def _sum_f32(t: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The sum of `t` over the axis, in f32, cast back once (a new tensor)."""
    f = t.to(torch.float32, copy=True)
    dist.all_reduce(f, op=dist.ReduceOp.SUM, group=axis.group)
    return f.to(t.dtype)


def _all_gather(t: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim`, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return torch.cat(parts, dim=dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _sum_f32(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return x if _AXIS is None else _CopyToModel.apply(x, _AXIS)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return x if _AXIS is None else _ReduceFromModel.apply(x, _AXIS)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The blocks of every rank concatenated along `dim`, in rank order."""
    return x if _AXIS is None else _GatherFromModel.apply(x, _AXIS, dim % x.dim())


def local_slice(x: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """This rank's n entries of a replicated x along `dim` (block rank), its
    gradient summed over the axis; x itself where n is its whole length."""
    if n == x.shape[dim]:
        return x
    return copy_to_model(x).narrow(dim, rank() * n, n)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the axis, no gradient (a new tensor)."""
    x = x.detach().clone()
    if _AXIS is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_AXIS.group)
    return x


def argmax_over_model(logits: torch.Tensor) -> torch.Tensor:
    """torch.argmax(logits, -1) of the whole last dim, from each rank's
    block of it (blocks in rank order): the first index of the largest
    value, as on one rank."""
    idx = torch.argmax(logits, dim=-1)
    if _AXIS is None:
        return idx
    best = logits.gather(-1, idx[..., None])[..., 0]
    top = max_over_model(best)
    n = logits.shape[-1]
    cand = torch.where(best == top, idx + rank() * n, torch.full_like(idx, n * size()))
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=_AXIS.group)
    return cand


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the axis in f32, no gradient (a new f32 tensor)."""
    x = x.detach().float().clone()
    if _AXIS is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=_AXIS.group)
    return x


def gather_whole(x: torch.Tensor, whole: int, dim: int = -1) -> torch.Tensor:
    """x whole along `dim`: gather_from_model where x is the rank's block of
    `whole` entries, x itself where it already holds them all."""
    return x if x.shape[dim] == whole else gather_from_model(x, dim)


@contextlib.contextmanager
def local():
    """No axis inside the block: a layer whose layout replicated every leaf
    it reads computes as one rank does, with no collective."""
    global _AXIS
    before, _AXIS = _AXIS, None
    try:
        yield
    finally:
        _AXIS = before


# ---------------------------------------------------------------------------
# blocks of whole leaves
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _index(mesh, axes) -> int:
    """This rank's block index over the mesh dims `axes`, row-major."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    sizes = shd.axis_sizes(mesh)
    index = 0
    for a in axes:
        index = index * sizes[a] + int(coord[names.index(a)])
    return index


def block(t, layout, mesh):
    """This rank's block of a whole leaf `t` under a layout tuple."""
    for dim, entry in enumerate(layout):
        axes = _entry_axes(entry)
        if axes:
            n = t.shape[dim] // shd.axis_size(mesh, axes)
            t = t.narrow(dim, _index(mesh, axes) * n, n)
    return t


def block_shape(shape, layout, mesh) -> tuple:
    """A block's shape of a whole leaf of `shape` under a layout tuple."""
    out = list(shape)
    for dim, entry in enumerate(layout):
        axes = _entry_axes(entry)
        if axes:
            out[dim] //= shd.axis_size(mesh, axes)
    return tuple(out)


def model_dim(layout) -> Optional[int]:
    """The dim a layout splits over "model" (None where it does not)."""
    for dim, entry in enumerate(layout):
        if "model" in _entry_axes(entry):
            return dim
    return None


def shard_params(params, mesh, specs):
    """Every leaf's block (contiguous) under a layout tree `specs`
    (sharding.param_specs of the whole tree)."""
    return tree.tree_map(lambda t, s: block(t, s, mesh).contiguous(), params, specs)


def gather_leaf(t: torch.Tensor, layout, mesh) -> torch.Tensor:
    """The whole leaf from every model rank's block `t` (one all-gather over
    the mesh's "model" group); t itself where the layout keeps it whole on
    the axis. Layouts over other mesh dims are not gathered here."""
    for entry in layout:
        if set(_entry_axes(entry)) - {"model"}:
            raise ValueError(f"gather_leaf gathers over 'model' only; layout {layout}")
    dim = model_dim(layout)
    axis = axis_of(mesh)
    if dim is None or axis is None:
        return t
    return _all_gather(t, axis, dim)
