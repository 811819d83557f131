"""Layouts of the coupled-STO ensemble on a DeviceMesh.

The reservoir part of the reference's distributed/sharding.py: the layout
every sharded reservoir path of the package uses (api/sharded.py). A layout
is a tuple with one entry per tensor dim, the counterpart of a jax
PartitionSpec: a mesh dim name, a tuple of names (the dim split over those
mesh dims, row-major in the order listed), or None (replicated).

The LM parts of the reference's module (param_shardings, batch_shardings,
cache_spec_for, kv_seq_mode, constrain) are not here: they wait for the
training slice (ROADMAP queue 1 item 13b).
"""

from __future__ import annotations

from typing import Optional, Sequence


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
