"""Sharded execution bodies for ExecPlan(mesh=...) plans, on torch.distributed.

The decomposition is the reference's (api/sharded.py): the ensemble axis E
spans the mesh's ensemble axes and the oscillator axis N spans its model
axis. W^cp is row-sharded and each RK stage all-gathers the m^x slice
(N * E_local floats, small next to the O(N^2 E) product). Layouts come from
`distributed.sharding.reservoir_specs`.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with
`mesh_dim_names`, and the program is SPMD: one process per rank, every rank
calling the same entry point with the same GLOBAL tensors, as the
reference's caller passes global jax arrays. Each body slices its rank's
block by the rank's mesh coordinate (`_local`), integrates it, and
all-gathers its results back to global tensors on every rank (`_gather`),
so every entry point keeps the unsharded shapes and contracts and every
rank returns the same bits. The reference's shard_map (core/compat.py) has
no torch counterpart: `_local` and `_gather` do its job. What the global
arguments cost on a multi-rank mesh (every rank holds every lane's state,
P included, and re-gathers it every call) is ROADMAP's open item "keep
lane-sharded state rank-local between calls".

Collectives run on the mesh's per-dim process groups (`mesh.get_group`).
A gather along a tensor dim is one flat dim-0 all-gather
(`all_gather_single`, or `all_gather_into_tensor` where the former is
absent) and a movedim; a dim split over several mesh dims is gathered one
mesh dim at a time, the last listed first (row-major). The coupling's
gather and the RLS feature gather run whatever the model axis's size, so a
(1, 1) mesh still goes through the collective; result assembly skips mesh
dims of size 1.

The local body is the scan oracle's step in the core (E, N, 3) layout with
the reference's op split, `_coupling_field` then `sto.effective_field_b`
then `sto.llg_rhs_from_b`: the ops of `sto.llg_field`, so a world-size-1
mesh is bit-equal to the unsharded impl="scan" wherever both run the same
input-field op (a shared (T, N_in) drive series is contracted once a
sample, 'ni,i->n', where scan contracts per lane).

`gather_dtype` (bf16) runs the coupling path in reduced precision: m^x is
cast before the all-gather (half the wire bytes) and the product takes
bf16 operands, widened exactly and multiplied in the state dtype with TF32
off, as `preferred_element_type=m.dtype` does (torch.matmul on bf16 tensors
would round its output to bf16). W is cast once a call. precision="mixed"
also runs the input field on bf16 operands (`ops.input_field_einsum`).
"""

from __future__ import annotations

import weakref
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import integrators, sto
from repro_torch.core.constants import STOParams
from repro_torch.device import require_full_f32_matmul
from repro_torch.distributed.sharding import reservoir_specs
from repro_torch.kernels import ops
from repro_torch.kernels import rls as krls


# ---------------------------------------------------------------------------
# slicing and gathering over the mesh
# ---------------------------------------------------------------------------


def _axes(entry) -> tuple:
    """A layout entry (a name, a tuple of names or None) as a tuple of names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _dim(mesh, name: str) -> int:
    return tuple(mesh.mesh_dim_names).index(name)


def _size(mesh, name: str) -> int:
    return int(mesh.shape[_dim(mesh, name)])


def _block(mesh, axes) -> tuple:
    """(index, count) of this rank's block along a tensor dim split over the
    mesh dims `axes`, row-major in the order listed (a PartitionSpec's axis
    tuple)."""
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for a in axes:
        d = _dim(mesh, a)
        index = index * int(mesh.shape[d]) + int(coord[d])
        count *= int(mesh.shape[d])
    return index, count


def _local(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the global tensor x under the layout `spec`."""
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if axes:
            index, count = _block(mesh, axes)
            b = x.shape[dim] // count
            x = x.narrow(dim, index * b, b)
    return x


#: all-gathers issued in this process (a stage's coupling gather, a learning
#: chunk's feature gather, result assembly over mesh dims wider than 1)
GATHERS = {"all_gather": 0}

# (id(mesh), name) -> (weakref to the mesh, order): a stage's gather reads
# it; the weakref tells a live mesh from another that took a dead one's id
_ORDERS: dict = {}


def _coordinate_order(mesh, name: str):
    """The group ranks of mesh dim `name` in the order of their coordinates
    along it, or None where the two orders agree (init_device_mesh's
    meshes). Computed once a mesh object, from the mesh's layout on the
    host, outside any dispatch mode (a dry run's fake tensors,
    launch/dryrun.py, describe the device and not the layout)."""
    from torch.utils._python_dispatch import _disable_current_modes

    hit = _ORDERS.get((id(mesh), name))
    if hit is not None and hit[0]() is mesh:
        return hit[1]
    ranks = dist.get_process_group_ranks(mesh.get_group(name))
    d = _dim(mesh, name)
    with _disable_current_modes():
        layout = np.asarray(mesh.mesh.tolist())
    coords = [int(np.argwhere(layout == r)[0][d]) for r in ranks]
    order = np.argsort(coords)
    order = None if (order == np.arange(len(order))).all() else tuple(int(i) for i in order)
    _ORDERS[(id(mesh), name)] = (weakref.ref(mesh), order)
    return order


def _all_gather_dim(x: torch.Tensor, mesh, name: str, dim: int) -> torch.Tensor:
    """Tiled all-gather of x along tensor dim `dim` over mesh dim `name`:
    the ranks' blocks concatenated in the order of their coordinates, as a
    contiguous tensor."""
    group = mesh.get_group(name)
    n = _size(mesh, name)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0], *xt.shape[1:]), dtype=xt.dtype, device=xt.device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, xt, group=group)
    GATHERS["all_gather"] += 1
    order = _coordinate_order(mesh, name)
    if order is not None:
        blocks = out.view(n, *xt.shape)
        out = torch.cat([blocks[j] for j in order])
    return out.movedim(0, dim).contiguous()


def _gather(x_local: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The global tensor from every rank's block under the layout `spec`;
    mesh dims of size 1 hold the whole dim already and are skipped."""
    x = x_local
    for dim, entry in enumerate(spec):
        for name in reversed(_axes(entry)):
            if _size(mesh, name) > 1:
                x = _all_gather_dim(x, mesh, name, dim)
    return x


def _local_params(params: STOParams, mesh, spec) -> STOParams:
    return STOParams(*(_local(x, mesh, spec) for x in params))


def torch_dtype(d) -> Optional[torch.dtype]:
    """A torch or numpy dtype (or None) as a torch dtype."""
    if d is None or isinstance(d, torch.dtype):
        return d
    return getattr(torch, np.dtype(d).name)


# ---------------------------------------------------------------------------
# the local body
# ---------------------------------------------------------------------------


def _input_field_local(params_l, win_l, u_t, precision, per_lane=True):
    """h_in = A_in * (W^in_local u_t) under the precision policy: per lane
    u_t (E_l, N_in) -> (E_l, N_l), or one shared row u_t (N_in,) -> (N_l,)."""
    eq = "ni,ei->en" if per_lane else "ni,i->n"
    return params_l.a_in * ops.input_field_einsum(eq, win_l, u_t, precision)


def _coupling_operand(w_l, gather_dtype, dtype):
    """W^cp's row block as the product consumes it: bf16 values widened
    exactly to the state dtype under a reduced gather dtype, cast once."""
    if gather_dtype is None:
        return w_l
    return w_l.to(gather_dtype).to(dtype)


def _coupling_field(params_l, w_mm, m, mesh, model_axis, gather_dtype):
    """h_x = A_cp * W^cp_local @ all-gather(m^x): the one collective a stage."""
    mx = m[..., 0]  # (E_l, N_l)
    if gather_dtype is not None:
        mx = mx.to(gather_dtype)
    if model_axis is not None:
        mx = _all_gather_dim(mx, mesh, model_axis, mx.ndim - 1)
    if gather_dtype is not None:
        mx = mx.to(m.dtype)
    if w_mm.is_cuda:
        require_full_f32_matmul()
    return params_l.a_cp * torch.einsum("ki,...i->...k", w_mm, mx)


def _make_step(params_l, w_mm, mesh, model_axis, gather_dtype, tableau_name):
    """The tableau's step over the LLG field split as the reference splits it
    (`_coupling_field`, `effective_field_b`, `llg_rhs_from_b`): the ops of
    `sto.llg_field`, which the unsharded scan steps over."""

    def field(m, h_in_x):
        h_x = _coupling_field(params_l, w_mm, m, mesh, model_axis, gather_dtype)
        if h_in_x is not None:
            h_x = h_x + h_in_x
        b = sto.effective_field_b(m, params_l, h_x)
        return sto.llg_rhs_from_b(m, b, params_l)

    return integrators.make_step(field, integrators.TABLEAUX[tableau_name])


def _hold(step, m, dt, h_in, hold_steps):
    for _ in range(hold_steps):
        m = step(m, dt, h_in)
    return m


class _Local:
    """One call's rank-local operands: params, W^cp / W^in row blocks and the
    step, sliced from the global arguments by `reservoir_specs`."""

    def __init__(self, mesh, params, w_cp, w_in, ensemble_axes, model_axis, tableau_name,
                 gather_dtype, dtype):
        self.mesh = mesh
        self.specs = reservoir_specs(ensemble_axes, model_axis)
        self.gather_dtype = torch_dtype(gather_dtype)
        self.params = _local_params(params, mesh, self.specs["params"])
        w_l = _local(w_cp, mesh, self.specs["w"])
        self.w_in = None if w_in is None else _local(w_in, mesh, self.specs["w_in"])
        w_mm = _coupling_operand(w_l, self.gather_dtype, dtype)
        self.step = _make_step(
            self.params, w_mm, mesh, model_axis, self.gather_dtype, tableau_name
        )

    def local(self, x, key):
        return _local(x, self.mesh, self.specs[key])

    def gather(self, x, key):
        return _gather(x, self.mesh, self.specs[key])


def _chunk_local(lo, m_l, u_l, mask_l, dt, hold_steps, precision):
    """K ticks on the rank's block: u_l (K, E_l, N_in), mask_l (K, E_l) ->
    (m (E_l, N_l, 3), states (K, E_l, N_l)); masked lanes bit-identical."""
    states = []
    for u_t, mask_t in zip(u_l, mask_l):
        h_in = _input_field_local(lo.params, lo.w_in, u_t, precision)
        m_new = _hold(lo.step, m_l, dt, h_in, hold_steps)
        m_l = torch.where(mask_t[:, None, None], m_new, m_l)
        states.append(m_l[..., 0])
    return m_l, torch.stack(states)


# ---------------------------------------------------------------------------
# entry points (global arguments and results on every rank)
# ---------------------------------------------------------------------------


def integrate_sharded(
    mesh,
    params: STOParams,  # leaves (E, 1)
    w_cp: torch.Tensor,  # (N, N)
    m0: torch.Tensor,  # (E, N, 3)
    dt,
    n_steps: int,
    ensemble_axes: Sequence[str] = ("data",),
    model_axis: Optional[str] = "model",
    tableau_name: str = "rk4",
    gather_dtype=None,
    precision=None,  # free-run has no input product; coupling rides gather_dtype
):
    """Free-running (u = 0) sharded ensemble integration -> final (E, N, 3)."""
    lo = _Local(mesh, params, w_cp, None, ensemble_axes, model_axis, tableau_name,
                gather_dtype, m0.dtype)
    m_l = lo.local(m0, "m").contiguous()
    dt = integrators.dt_tensor(dt, m_l)
    for _ in range(n_steps):
        m_l = lo.step(m_l, dt, None)
    return lo.gather(m_l, "m")


def drive_sharded(
    mesh,
    params: STOParams,  # leaves (E, 1)
    w_cp: torch.Tensor,  # (N, N)
    w_in: torch.Tensor,  # (N, N_in)
    m0: torch.Tensor,  # (E, N, 3)
    u_seq: torch.Tensor,  # (T, N_in) shared series OR (T, E, N_in) per lane
    dt,
    hold_steps: int,
    ensemble_axes: Sequence[str] = ("data",),
    model_axis: Optional[str] = "model",
    tableau_name: str = "rk4",
    gather_dtype=None,
    precision=None,
):
    """Reservoir drive (input on) for a sharded ensemble.

    Returns (mT (E, N, 3), states (T, E, N)), states being m^x after each
    hold window. The input field depends only on the local N rows, so the
    input path adds no collective. A shared series is contracted once a
    sample ('ni,i->n') and broadcast over the lanes."""
    per_lane = u_seq.ndim == 3
    lo = _Local(mesh, params, w_cp, w_in, ensemble_axes, model_axis, tableau_name,
                gather_dtype, m0.dtype)
    m_l = lo.local(m0, "m").contiguous()
    u_l = lo.local(u_seq, "u_e" if per_lane else "u")
    dt = integrators.dt_tensor(dt, m_l)
    states = []
    for u_t in u_l:
        h_in = _input_field_local(lo.params, lo.w_in, u_t, precision, per_lane)
        h_in = h_in.expand(m_l[..., 0].shape)
        m_l = _hold(lo.step, m_l, dt, h_in, hold_steps)
        states.append(m_l[..., 0])
    return lo.gather(m_l, "m"), lo.gather(torch.stack(states), "states")


def tick_chunk_sharded(
    mesh,
    params: STOParams,  # leaves (E, 1)
    w_cp: torch.Tensor,  # (N, N)
    w_in: torch.Tensor,  # (N, N_in)
    m: torch.Tensor,  # (E, N, 3)
    u_block: torch.Tensor,  # (K, E, N_in) input rows for K ticks
    mask_block: torch.Tensor,  # (K, E) bool; False = lane frozen that tick
    dt,
    hold_steps: int,
    ensemble_axes: Sequence[str] = ("data",),
    model_axis: Optional[str] = "model",
    tableau_name: str = "rk4",
    gather_dtype=None,
    precision=None,
):
    """K serving ticks for a sharded slot batch: the sharded counterpart of
    `CompiledSim.tick_chunk`. Per-tick lane masks support mid-chunk admit
    and retire (masked ticks bit-identical). Returns (m' (E, N, 3), states
    (K, E, N))."""
    lo = _Local(mesh, params, w_cp, w_in, ensemble_axes, model_axis, tableau_name,
                gather_dtype, m.dtype)
    m_l = lo.local(m, "m").contiguous()
    m_l, states = _chunk_local(
        lo, m_l, lo.local(u_block, "u_e"), lo.local(mask_block, "lane_block"),
        integrators.dt_tensor(dt, m_l), hold_steps, precision,
    )
    return lo.gather(m_l, "m"), lo.gather(states, "states")


def tick_chunk_sharded_rls(
    mesh,
    params: STOParams,  # leaves (E, 1)
    w_cp: torch.Tensor,  # (N, N)
    w_in: torch.Tensor,  # (N, N_in)
    m: torch.Tensor,  # (E, N, 3)
    u_block: torch.Tensor,  # (K, E, N_in)
    mask_block: torch.Tensor,  # (K, E) bool: integration lane mask
    y_block: torch.Tensor,  # (K, E, n_out) per-tick learning targets
    lmask_block: torch.Tensor,  # (K, E) bool: which lanes learn which ticks
    p0: torch.Tensor,  # (E, S, S) per-lane RLS inverse-Gram
    w0: torch.Tensor,  # (E, S, n_out) per-lane readout weights
    lam: float,  # forgetting factor
    dt,
    hold_steps: int,
    ensemble_axes: Sequence[str] = ("data",),
    model_axis: Optional[str] = "model",
    tableau_name: str = "rk4",
    gather_dtype=None,
    precision=None,
):
    """K learning serving ticks for a sharded slot batch.

    The integration is `tick_chunk_sharded`'s; P and W stay lane-sharded
    (replicated over the model axis), the chunk's (K, E_l, N_l) states are
    all-gathered over the model axis once, the bias column appended, and
    `kernels.rls.rls_chunk` runs on the lane block. Returns (m' (E, N, 3),
    states (K, E, N), P', W', preds (K, E, n_out))."""
    lo = _Local(mesh, params, w_cp, w_in, ensemble_axes, model_axis, tableau_name,
                gather_dtype, m.dtype)
    m_l = lo.local(m, "m").contiguous()
    m_l, states = _chunk_local(
        lo, m_l, lo.local(u_block, "u_e"), lo.local(mask_block, "lane_block"),
        integrators.dt_tensor(dt, m_l), hold_steps, precision,
    )
    sx = states
    if model_axis is not None:
        sx = _all_gather_dim(sx, mesh, model_axis, 2)
    ones = torch.ones((*sx.shape[:2], 1), dtype=sx.dtype, device=sx.device)
    xb = torch.cat([sx, ones], dim=-1)  # (K, E_l, S)
    p_l, w_l, preds = krls.rls_chunk(
        lo.local(p0, "learn_p"), lo.local(w0, "learn_w"), xb,
        lo.local(y_block, "y_block"), lo.local(lmask_block, "lane_block"), lam,
    )
    return (
        lo.gather(m_l, "m"),
        lo.gather(states, "states"),
        lo.gather(p_l, "learn_p"),
        lo.gather(w_l, "learn_w"),
        lo.gather(preds, "y_block"),
    )


def tick_sharded(
    mesh,
    params: STOParams,  # leaves (E, 1)
    w_cp: torch.Tensor,  # (N, N)
    w_in: torch.Tensor,  # (N, N_in)
    m: torch.Tensor,  # (E, N, 3)
    u: torch.Tensor,  # (E, N_in) this tick's input row per lane
    lane_mask: torch.Tensor,  # (E,) bool; False lanes return unchanged
    dt,
    hold_steps: int,
    ensemble_axes: Sequence[str] = ("data",),
    model_axis: Optional[str] = "model",
    tableau_name: str = "rk4",
    gather_dtype=None,
    precision=None,
):
    """One serving tick (a hold window) for a sharded slot batch: the
    one-tick chunk. Returns (m' (E, N, 3), states (E, N))."""
    m_new, states = tick_chunk_sharded(
        mesh, params, w_cp, w_in, m, u[None], lane_mask[None], dt, hold_steps,
        ensemble_axes=ensemble_axes, model_axis=model_axis, tableau_name=tableau_name,
        gather_dtype=gather_dtype, precision=precision,
    )
    return m_new, states[0]
