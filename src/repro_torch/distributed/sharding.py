"""Layouts on a DeviceMesh: the coupled-STO ensemble's and the LM's.

The reference's distributed/sharding.py. A layout is a tuple with one entry
per tensor dim, the counterpart of a jax PartitionSpec (and normalised as
one is: a one-name tuple becomes the bare name): a mesh dim name, a tuple of
names (the dim split over those mesh dims, row-major in the order listed),
or None (replicated); () replicates every dim.

  reservoir_specs   the layout every sharded reservoir path of the package
                    uses (api/sharded.py)
  param_specs       the LM parameters' Megatron-style layouts (vocab, heads,
                    d_ff over "model"; a dim the axis does not divide falls
                    back to replication), the reference's param_shardings
  batch_specs       a batch's leading dim over ("pod", "data"), the
                    reference's batch_shardings
  cache_spec_for    a KV-cache leaf's layout (kv_seq_mode's policy)

A mesh here is anything with `mesh_dim_names` and `shape` (a DeviceMesh, or
an AbstractMesh for layouts alone). The port trains data-parallel only
(train/train_loop.py): it reads batch_specs to slice a batch, and a model
axis wider than 1 is refused (enable_constraints, constrain), ROADMAP queue
1 item 13b (tensor-parallel training). param_specs and cache_spec_for give
the layouts such a run would take.
"""

from __future__ import annotations

import os
import re
from typing import NamedTuple, Optional, Sequence, Tuple

from repro_torch import tree

TP_TODO = "a model axis wider than 1: ROADMAP queue 1 item 13b (tensor-parallel training)"


class AbstractMesh(NamedTuple):
    """A mesh's names and sizes without devices or process groups (layouts
    only): AbstractMesh((2, 4), ("data", "model"))."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def axis_sizes(mesh) -> dict:
    """{mesh dim name: size}, the reference's `mesh.shape`."""
    return dict(zip(tuple(mesh.mesh_dim_names), (int(n) for n in mesh.shape)))


def axis_size(mesh, axes) -> int:
    """How many ranks the mesh dims `axes` (a name, a tuple of names or None)
    span together."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for a in axes:
        n *= int(mesh.shape[names.index(a)])
    return n


def reservoir_specs(
    ensemble_axes: Sequence[str] = ("data",),
    model_axis: Optional[str] = "model",
) -> dict:
    """Layouts of the coupled-STO ensemble state, the reference's key for key.

    The ensemble axis E spans `ensemble_axes` (independent reservoirs), the
    oscillator axis N spans `model_axis` (W^cp row-sharded; each RK stage
    all-gathers the m^x slice). Keys:

      params  STOParams leaves (E, 1)
      w       coupling matrix (N, N), row-sharded
      w_in    input matrix (N, N_in), row-sharded like w
      m       magnetization (E, N, 3)
      u       shared input series (T, N_in), replicated
      u_e     per-lane input (T, E, N_in)
      u_tick  one tick's per-lane input rows (E, N_in)
      lane    per-lane vectors (E,): masks, gains
      lane_block  per-tick per-lane mask block (K, E): chunked serving
      states  collected node states (T, E, N)
      states_tick  one tick's states plane (E, N)
      learn_p  per-lane RLS inverse-Gram (E, S, S): lane-sharded, the
               (S, S) = (N+1, N+1) feature block replicated (the update
               consumes the all-gathered feature vector)
      learn_w  per-lane readout weights (E, S, n_out), sharded like learn_p
      y_block  per-tick per-lane targets / predictions (K, E, n_out)
    """
    ens = tuple(ensemble_axes)
    # a PartitionSpec keeps a one-name tuple as the bare name, () as None
    ens = ens[0] if len(ens) == 1 else (ens or None)
    return {
        "params": (ens, None),
        "w": (model_axis, None),
        "w_in": (model_axis, None),
        "m": (ens, model_axis, None),
        "u": (None, None),
        "u_e": (None, ens, None),
        "u_tick": (ens, None),
        "lane": (ens,),
        "lane_block": (None, ens),
        "states": (None, ens, model_axis),
        "states_tick": (ens, model_axis),
        "learn_p": (ens, None, None),
        "learn_w": (ens, None, None),
        "y_block": (None, ens, None),
    }


# ---------------------------------------------------------------------------
# activation constraints (the reference registers a mesh and model code
# calls constrain(x, BATCH, None, MODEL); the port's model code does not,
# and a registered mesh must leave activations where they are)
# ---------------------------------------------------------------------------

BATCH = "__batch__"  # placeholder resolved to ("pod", "data") / ("data",)
MODEL = "__model__"

_ACTIVE_MESH = None


def _spec(entries) -> tuple:
    """A layout normalised as a PartitionSpec is: one-name tuples become the
    name, empty tuples None."""
    out = []
    for e in entries:
        if isinstance(e, tuple):
            e = e[0] if len(e) == 1 else (e or None)
        out.append(e)
    return tuple(out)


def kv_seq_mode() -> str:
    """KV-cache layout policy, REPRO_KV_SEQ_SHARD (the reference's):
      "0"    heads / head_dim over the model axis
      "1"    force sequence sharding (flash-decode layout)
      "auto" (default) sequence sharding only when kv_heads doesn't divide
             the model axis."""
    return os.environ.get("REPRO_KV_SEQ_SHARD", "auto")


def want_kv_seq_shard(kv_heads: int, mesh=None) -> bool:
    mode = kv_seq_mode()
    if mode == "1":
        return True
    if mode == "0":
        return False
    mesh = mesh or _ACTIVE_MESH
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return False
    # MLA latent caches pass kv_heads=0: always prefer seq sharding there
    return kv_heads == 0 or kv_heads % axis_sizes(mesh)["model"] != 0


def _refuse_model_axis(mesh) -> None:
    if mesh is not None and axis_sizes(mesh).get("model", 1) > 1:
        raise NotImplementedError(TP_TODO)


def enable_constraints(mesh) -> None:
    """Register the mesh `constrain` resolves against (None disables).
    Raises NotImplementedError for a model axis wider than 1."""
    global _ACTIVE_MESH
    _refuse_model_axis(mesh)
    _ACTIVE_MESH = mesh


def constrain(x, *spec):
    """The reference's with_sharding_constraint: the identity without a
    registered mesh or with a model axis of 1 (activations stay whole on
    their rank); NotImplementedError for a wider model axis."""
    _refuse_model_axis(_ACTIVE_MESH)
    return x


# ---------------------------------------------------------------------------
# parameter layouts
# ---------------------------------------------------------------------------


def _ok(dim: int, mesh, axes) -> bool:
    return dim % axis_size(mesh, axes) == 0


# (path regex, candidate layouts tried in order; the first whose axes divide
# the dims wins), the reference's rules
_PARAM_RULES: Tuple[Tuple[str, Tuple[Tuple, ...]], ...] = (
    # embeddings: shard vocab; fall back to d_model
    (r"embed/embed$", ((("model",), None), (None, ("model",)))),
    (r"lm_head/kernel$", ((None, ("model",)),)),  # (d, vocab)
    (r"dec_pos$", ((None, None),)),
    # attention projections
    (r"(mixer|cross)/wq/kernel$", ((None, ("model",)),)),
    (r"(mixer|cross)/wk/kernel$", ((None, ("model",)),)),
    (r"(mixer|cross)/wv/kernel$", ((None, ("model",)),)),
    (r"(mixer|cross)/wo/kernel$", ((("model",), None),)),
    # MLA
    (r"mixer/wkv_a/kernel$", ((None, None),)),  # tiny latent proj: replicate
    (r"mixer/w_uk$", ((None, ("model",), None),)),  # (r, H, dn): shard heads
    (r"mixer/w_uv$", ((None, ("model",), None),)),
    # MoE: experts first, then expert-ff fallback
    (r"mlp/(w_gate|w_in)$", ((("model",), None, None), (None, None, ("model",)))),
    (r"mlp/w_out$", ((("model",), None, None), (None, ("model",), None))),
    (r"mlp/router/kernel$", ((None, None),)),
    (r"mlp/shared/(w_gate|w_in)/kernel$", ((None, ("model",)),)),
    (r"mlp/shared/w_out/kernel$", ((("model",), None),)),
    # dense MLP
    (r"mlp/(w_gate|w_in)/kernel$", ((None, ("model",)),)),
    (r"mlp/w_out/kernel$", ((("model",), None),)),
    # mamba
    (r"mixer/in_proj/kernel$", ((None, ("model",)),)),
    (r"mixer/out_proj/kernel$", ((("model",), None),)),
    (r"mixer/(conv_w|conv_b)$", ((None, ("model",)), (("model",),))),
    (r"mixer/x_proj/kernel$", ((("model",), None),)),
    (r"mixer/dt_proj/kernel$", ((None, ("model",)),)),
    (r"mixer/dt_proj/bias$", ((("model",),),)),
    (r"mixer/a_log$", ((("model",), None),)),
    (r"mixer/d_skip$", ((("model",),),)),
    # xlstm
    (r"mixer/up_proj/kernel$", ((None, ("model",)),)),
    (r"mixer/down_proj/kernel$", ((("model",), None),)),
    (r"mixer/(wq|wk|wv)/kernel$", ((None, ("model",)),)),
    (r"mixer/w_if/kernel$", ((None, None),)),
    (r"mixer/w_gates/kernel$", ((None, ("model",)),)),
    (r"mixer/r_gates$", ((None, ("model",), None, None),)),
    (r"mixer/b_gates$", ((None, None),)),
)


def _stacked(path: str) -> bool:
    return path.startswith("stack/") or "/stack/" in path


def _spec_for_param(path: str, shape, mesh, stacked: bool) -> tuple:
    """The first matching rule whose axis sizes divide the dims; else ()
    (replicated). stacked: the leaf carries a leading num_periods axis."""
    offset = 1 if stacked else 0
    for pat, candidates in _PARAM_RULES:
        if re.search(pat, path):
            for cand in candidates:
                if len(cand) != len(shape) - offset:
                    continue
                if all(axes is None or _ok(dim, mesh, axes)
                       for dim, axes in zip(shape[offset:], cand)):
                    return _spec((None,) * offset + tuple(cand))
            break
    return ()


def param_specs(mesh, params_or_specs, cfg=None):
    """A layout tree for a parameter tree (tensors or TensorSpecs)."""
    def assign(path, leaf):
        ps = tree.path_str(path)
        return _spec_for_param(ps, tuple(leaf.shape), mesh, _stacked(ps))

    return _map_with_path(assign, params_or_specs)


def _map_with_path(fn, t, path=()):
    if isinstance(t, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in t.items()}
    if isinstance(t, list):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(t)]
    return fn(path, t)


# ---------------------------------------------------------------------------
# batch / cache layouts
# ---------------------------------------------------------------------------


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def batch_specs(mesh, batch, seq_axis: Optional[str] = None):
    """A layout tree for a batch: the leading dim over (pod, data), or over
    data alone, or replicated where neither divides it; optionally the
    sequence dim over `seq_axis`. Cache leaves take cache_spec_for."""
    ba = _batch_axes(mesh)

    def assign(path, leaf):
        ps = tree.path_str(path)
        if "caches" in ps:
            return cache_spec_for(ps, leaf, mesh)
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return ()
        bspec = ba if shape[0] % axis_size(mesh, ba) == 0 else (
            ("data",) if shape[0] % axis_size(mesh, ("data",)) == 0 else None
        )
        spec = [bspec] + [None] * (len(shape) - 1)
        if seq_axis and len(shape) >= 2 and shape[1] % axis_size(mesh, (seq_axis,)) == 0:
            # only shard seq when batch is NOT absorbing that axis
            if bspec is None or seq_axis not in (bspec if isinstance(bspec, tuple) else (bspec,)):
                spec[1] = seq_axis
        return _spec(spec)

    return _map_with_path(assign, batch)


def cache_spec_for(path: str, leaf, mesh) -> tuple:
    """KV-cache layout: batch -> data (+pod), heads / head_dim -> model.

    Layouts: attention k/v (B, S, KVH, HD) [stacked: + lead]; MLA c_kv (B, S,
    r); mamba h (B, di, ds); conv_tail (B, K-1, di); xlstm c (B, H, dh, dh).
    """
    ba = _batch_axes(mesh)
    shape = tuple(leaf.shape)
    off = 1 if _stacked(path) else 0
    dims = shape[off:]
    spec = [None] * (off + len(dims))

    if dims and dims[0] % axis_size(mesh, ba) == 0:
        spec[off] = ba
    elif dims and dims[0] % axis_size(mesh, ("data",)) == 0:
        spec[off] = "data"

    def try_model(i):
        if dims[i] % axis_size(mesh, ("model",)) == 0:
            spec[off + i] = "model"
            return True
        return False

    if re.search(r"/(k|v)$", path) and len(dims) == 4:
        # (B, S, KVH, HD): heads -> model (fall back to head_dim), or the
        # sequence -> model where kv_seq_mode asks for it
        if want_kv_seq_shard(dims[2], mesh):
            if try_model(1):
                return _spec(spec)
        if not try_model(2):
            try_model(3)
    elif re.search(r"/(c_kv|k_rope)$", path) and len(dims) == 3:
        if want_kv_seq_shard(0, mesh):
            if try_model(1):
                return _spec(spec)
        try_model(2)
    elif re.search(r"/(h|conv_tail)$", path) and len(dims) == 3:
        try_model(1) if re.search(r"/h$", path) else try_model(2)
    elif re.search(r"/c$", path) and len(dims) == 4:
        try_model(1)
    elif re.search(r"/(n|m)$", path) and len(dims) >= 2:
        try_model(1)
    return _spec(spec)


def logical_summary(mesh, params) -> str:
    """Debug helper: one line per parameter, its path, shape and layout."""
    rows = []
    for path, leaf in tree.leaves_with_path(params):
        ps = tree.path_str(path)
        spec = _spec_for_param(ps, tuple(leaf.shape), mesh, _stacked(ps))
        rows.append(f"{ps:60s} {str(tuple(leaf.shape)):24s} {spec}")
    return "\n".join(rows)
