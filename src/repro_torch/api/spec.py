"""SimSpec: WHAT to simulate — the pure physics of a coupled-STO reservoir.

A `SimSpec` is everything the paper's equations need and nothing the
hardware cares about: the LLG/STO parameter set, the coupling and input
topologies, the initial magnetization, the RK timestep/tableau, and the hold
window (integration steps per input sample). How that evolution is executed
lives in `repro_torch.api.plan.ExecPlan`; `compile_plan(spec, plan)` marries
the two. The tensors of a spec live on one device (`SimSpec.device`).

The physics families (the reference's api/spec.py) are a `topology` value,
not a class:

  coupled_array     the paper's N-coupled STO array (the default).
  time_multiplexed  Riou et al. (arXiv:1904.11236): ONE oscillator per lane,
                    N virtual nodes on a delay line. Row j of m0 is virtual
                    node j's snapshot; the carried physical state is row
                    N-1. w_in is the +-1 input mask, w_cp mixes the previous
                    tick's snapshots into per-node feedback (identity: the
                    classic delay line) and params.a_cp is the feedback gain.
  array_transient   Kanao et al. (arXiv:1905.07937): the coupled array, each
                    tick's state the mean of m_x over the last
                    `readout_window` substeps of the hold window.
                    readout_window=1 is bit-identical to coupled_array.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import constants, coupling
from repro_torch.core.constants import STOParams
from repro_torch.device import resolve_device

TOPOLOGIES = ("coupled_array", "time_multiplexed", "array_transient")


class SimSpec(NamedTuple):
    """Pure physics description of one reservoir (or an ensemble template).

    params may carry 0-d leaves (one physical device) or (E, 1) ensemble
    leaves (`core.ensemble.broadcast_params`); execution width is the
    ExecPlan's call.
    """

    params: STOParams
    w_cp: torch.Tensor  # (N, N) coupling topology
    w_in: torch.Tensor  # (N, N_in) input topology
    m0: torch.Tensor  # (N, 3) canonical initial magnetization
    dt: float
    hold_steps: int  # integration steps per input sample
    tableau: str = "rk4"
    topology: str = "coupled_array"  # one of TOPOLOGIES
    readout_window: int = 0  # array_transient: trailing substeps averaged

    @property
    def n(self) -> int:
        return int(self.m0.shape[0])

    @property
    def n_in(self) -> int:
        return int(self.w_in.shape[1])

    @property
    def dtype(self):
        return self.m0.dtype

    @property
    def device(self) -> torch.device:
        return self.m0.device

    def to(self, device) -> "SimSpec":
        """This spec with every tensor on `device`."""
        dev = resolve_device(device)
        return self._replace(
            params=self.params.to(dev),
            w_cp=self.w_cp.to(dev),
            w_in=self.w_in.to(dev),
            m0=self.m0.to(dev),
        )


def validate_topology(spec: SimSpec) -> None:
    """Family invariants every consumer (compile_plan, engines) enforces.

    Raises ValueError on an unknown topology or a readout_window that does
    not fit the family: array_transient needs 1 <= readout_window <=
    hold_steps, every other family leaves the field at 0.
    """
    if spec.topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {spec.topology!r}; expected one of {TOPOLOGIES}")
    w = spec.readout_window
    if isinstance(w, bool) or not isinstance(w, int):
        raise ValueError(f"readout_window must be an int; got {w!r}")
    if spec.topology == "array_transient":
        if not 1 <= w <= int(spec.hold_steps):
            raise ValueError(
                "array_transient requires 1 <= readout_window <= hold_steps"
                f" ({spec.hold_steps}); got {w}"
            )
    elif w != 0:
        raise ValueError(
            f"readout_window is an array_transient field; topology "
            f"{spec.topology!r} requires readout_window=0 (got {w})"
        )


def make_spec(
    n: int,
    n_in: int = 1,
    seed: int = 0,
    dt: float = constants.DT,
    hold_steps: int = 100,
    dtype=torch.float32,
    params: Optional[STOParams] = None,
    tableau: str = "rk4",
    topology: str = "coupled_array",
    readout_window: int = 0,
    device="cuda",
) -> SimSpec:
    """Build a SimSpec with the paper's Table-1 defaults on `device`."""
    dev = resolve_device(device)
    if params is None:
        params = constants.default_params(dtype, device=dev)
    w_cp = torch.as_tensor(coupling.make_coupling_matrix(n, seed=seed)).to(dev, dtype)
    w_in = torch.as_tensor(coupling.make_input_matrix(n, n_in, seed=seed + 1)).to(dev, dtype)
    m0 = constants.initial_magnetization(n, dtype=dtype, device=dev)
    spec = SimSpec(
        params.to(dev), w_cp, w_in, m0, dt, hold_steps, tableau,
        topology=topology, readout_window=readout_window,
    )
    validate_topology(spec)
    return spec


def make_time_multiplexed_spec(
    n_virtual: int,
    n_in: int = 1,
    seed: int = 0,
    dt: float = constants.DT,
    hold_steps: int = 10,
    dtype=torch.float32,
    params: Optional[STOParams] = None,
    tableau: str = "rk4",
    device="cuda",
) -> SimSpec:
    """A Riou-style time-multiplexed single-oscillator reservoir on `device`.

    One physical oscillator; `n_virtual` virtual nodes, each holding the
    input for `hold_steps` RK substeps. w_in is a random +-1 input mask over
    the virtual nodes (numpy's generator from `seed`, so it is the
    reference's mask byte for byte); w_cp is the identity (node j's drive
    feeds back from node j's snapshot one tick earlier) with params.a_cp the
    feedback gain.
    """
    dev = resolve_device(device)
    if params is None:
        params = constants.default_params(dtype, device=dev)
    mask = np.random.default_rng(seed).choice((-1.0, 1.0), size=(n_virtual, n_in))
    spec = SimSpec(
        params.to(dev),
        torch.eye(n_virtual, dtype=dtype, device=dev),
        torch.as_tensor(mask).to(dev, dtype),
        constants.initial_magnetization(n_virtual, dtype=dtype, device=dev),
        dt, hold_steps, tableau,
        topology="time_multiplexed", readout_window=0,
    )
    validate_topology(spec)
    return spec


def make_array_transient_spec(
    n: int,
    readout_window: int,
    n_in: int = 1,
    seed: int = 0,
    dt: float = constants.DT,
    hold_steps: int = 100,
    dtype=torch.float32,
    params: Optional[STOParams] = None,
    tableau: str = "rk4",
    device="cuda",
) -> SimSpec:
    """A Kanao-style array whose state is read from the transient window."""
    return make_spec(
        n, n_in=n_in, seed=seed, dt=dt, hold_steps=hold_steps, dtype=dtype,
        params=params, tableau=tableau, topology="array_transient",
        readout_window=readout_window, device=device,
    )
