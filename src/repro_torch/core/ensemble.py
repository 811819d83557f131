"""Ensembles of parameter sets (one value per ensemble lane), and the
sharded ensemble drive.

Of the reference's module, the deprecated shims `integrate_ensemble`,
`integrate_ensemble_sharded` and `fit_ridge_ensemble` are left out by
design (`compile_plan(spec, ExecPlan(...)).integrate` / `drive_batch` do
their work). `lower_sharded_ensemble`, which lowers XLA from
ShapeDtypeStructs there, binds the sharded integrator to arguments made
from shapes here, for a dry run to run on fake tensors (launch/dryrun.py).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from repro_torch.core.constants import STOParams


def broadcast_params(base: STOParams, size: int, **sweeps) -> STOParams:
    """Ensemble of parameter sets with leaves shaped (E, 1).

    The (E, 1) trailing singleton broadcasts against per-oscillator arrays of
    shape (E, N). Any keyword in `sweeps` supplies a length-E array for that
    field; all other fields are tiled from `base`.
    """
    unknown = set(sweeps) - set(base._fields)
    if unknown:
        raise ValueError(f"unknown sweep fields: {sorted(unknown)}")
    ref = base.gamma
    leaves = {}
    for name in base._fields:
        if name in sweeps:
            v = torch.as_tensor(sweeps[name], dtype=ref.dtype, device=ref.device).reshape(size, 1)
        else:
            v = getattr(base, name).expand(size, 1)
        leaves[name] = v
    return STOParams(**leaves)


def drive_ensemble_sharded(
    mesh,
    params: STOParams,  # leaves (E, 1)
    w_cp: torch.Tensor,  # (N, N)
    w_in: torch.Tensor,  # (N, N_in)
    m0: torch.Tensor,  # (E, N, 3)
    u_seq: torch.Tensor,  # (T, N_in) shared input series
    dt: float,
    hold_steps: int,
    ensemble_axes: Sequence[str] = ("data",),
    model_axis: Optional[str] = "model",
    tableau_name: str = "rk4",
    gather_dtype=None,
):
    """Reservoir drive (input on) for an ensemble sharded over a DeviceMesh,
    SPMD with global tensors on every rank. Returns (mT (E, N, 3), states
    (T, E, N)). Delegates to `api.sharded.drive_sharded`; prefer
    `compile_plan(spec, ExecPlan(mesh=...)).drive_batch(u)`."""
    from repro_torch.api import sharded  # deferred: api imports core

    return sharded.drive_sharded(
        mesh, params, w_cp, w_in, m0, u_seq, dt, hold_steps,
        ensemble_axes=ensemble_axes, model_axis=model_axis,
        tableau_name=tableau_name, gather_dtype=gather_dtype,
    )


def lower_sharded_ensemble(
    mesh,
    n: int,
    e: int,
    dt: float,
    n_steps: int,
    ensemble_axes: Sequence[str] = ("data",),
    model_axis: Optional[str] = "model",
    dtype=torch.bfloat16,
    gather_dtype=None,
    device="cuda",
):
    """Dry-run entry: `api.sharded.integrate_sharded` bound (a
    functools.partial) to uninitialised global arguments made on `device`
    (params (E, 1) a field, W (N, N), m0 (E, N, 3) in `dtype`): fake tensors,
    nothing allocated, when called inside a dry run's FakeTensorMode. Where
    the reference returns an XLA `Lowered`, launch/dryrun.py runs this call
    under its cost counters as one rank of `mesh`. The sharded path takes
    global tensors on every rank, so the arguments are the whole state."""
    from repro_torch.api import sharded  # deferred: api imports core

    dev = torch.device(device)
    params = STOParams(*(torch.empty((e, 1), dtype=dtype, device=dev) for _ in STOParams._fields))
    w = torch.empty((n, n), dtype=dtype, device=dev)
    m0 = torch.empty((e, n, 3), dtype=dtype, device=dev)
    return functools.partial(
        sharded.integrate_sharded, mesh, params, w, m0, dt, n_steps,
        ensemble_axes=tuple(ensemble_axes), model_axis=model_axis, gather_dtype=gather_dtype,
    )
