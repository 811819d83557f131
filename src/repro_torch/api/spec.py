"""SimSpec: WHAT to simulate — the pure physics of a coupled-STO reservoir.

A `SimSpec` is everything the paper's equations need and nothing the
hardware cares about: the LLG/STO parameter set, the coupling and input
topologies, the initial magnetization, the RK timestep/tableau, and the hold
window (integration steps per input sample). How that evolution is executed
lives in `repro_torch.api.plan.ExecPlan`; `compile_plan(spec, plan)` marries
the two. The tensors of a spec live on one device (`SimSpec.device`).

This slice ports the coupled_array topology with the classical RK4 tableau;
the other physics families wait for ROADMAP queue 1, item 8.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import constants, coupling
from repro_torch.core.constants import STOParams
from repro_torch.device import resolve_device

TOPOLOGIES = ("coupled_array",)
# the reference's other families, refused with a pointer to their port
_WAITING_TOPOLOGIES = ("time_multiplexed", "array_transient")


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
    topology: str = "coupled_array"
    readout_window: int = 0

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
    """Family invariants: only coupled_array (readout_window 0) is ported."""
    if spec.topology in _WAITING_TOPOLOGIES:
        raise NotImplementedError(
            f"topology {spec.topology!r} is not ported yet (ROADMAP queue 1, "
            "item 8: physics families); this slice serves coupled_array"
        )
    if spec.topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {spec.topology!r}; expected one of {TOPOLOGIES}")
    w = spec.readout_window
    if isinstance(w, bool) or not isinstance(w, int):
        raise ValueError(f"readout_window must be an int; got {w!r}")
    if w != 0:
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
