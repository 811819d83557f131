"""Physical constants and the paper's parameter set (Table 1).

Units follow the paper (Gaussian/CGS for magnetics, SI for charge/current):
  gamma   [rad / (Oe s)]      gyromagnetic ratio
  Ms      [emu / cm^3]        saturation magnetization
  fields  [Oe]
  volume  [cm^3]
  current [A]

The spin-transfer field H_s = hbar * eta * I / (2 e (1 + lam m.p) Ms V) mixes
SI (hbar, e, I) and CGS (Ms, V): hbar*I/(2e) is in Joule; Ms*V is in emu =
erg/Oe; 1 J = 1e7 erg, hence the explicit ERG_PER_JOULE factor. With the
paper's values H_s(m.p=0) ~ 135 Oe, comparable to H_appl = 200 Oe.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

# Fundamental constants (paper Table 1).
HBAR = 1.05457266e-34  # J s
E_CHARGE = 1.60217733e-19  # C
ERG_PER_JOULE = 1.0e7

# Paper Table 1 values.
GAMMA = 1.764e7  # rad / (Oe s)
ALPHA = 0.005
MS = 1448.3  # emu / cm^3
HK = 18.616e3  # Oe (interfacial anisotropy field)
HAPPL = 200.0  # Oe (applied field)
ETA = 0.537  # spin polarization
LAMBDA = 0.288  # spin-transfer torque asymmetry
CURRENT = 2.5e-3  # A
VOLUME = math.pi * 60.0**2 * 2.0 * 1e-21  # cm^3  (pi * 60^2 * 2 nm^3)
P_PINNED = (1.0, 0.0, 6.123234e-17)  # pinned-layer direction (~e_x)
A_CP = 1.0  # Oe, coupling amplitude
A_IN = 1.0  # Oe, input amplitude

# Benchmark protocol (paper §3.2).
DT = 1.0e-11  # s
N_STEPS_PAPER = 500_000
PHI0 = 2.0 * math.pi / 360.0  # initial-condition angle


class STOParams(NamedTuple):
    """LLG/STO parameters: 0-d tensors (one device) or (E, 1) tensors (one
    value per ensemble lane, see `core.ensemble.broadcast_params`)."""

    gamma: torch.Tensor
    alpha: torch.Tensor
    ms: torch.Tensor
    hk: torch.Tensor
    happl: torch.Tensor
    eta: torch.Tensor
    lam: torch.Tensor
    current: torch.Tensor
    volume: torch.Tensor
    a_cp: torch.Tensor
    a_in: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor

    @property
    def llg_prefactor(self):
        """gamma / (1 + alpha^2)."""
        return self.gamma / (1.0 + self.alpha**2)

    @property
    def hs_coef(self):
        """H_s numerator in Oe: 1e7 * hbar * eta * I / (2 e Ms V).

        H_s(m) = hs_coef / (1 + lam * m.p).
        """
        return (
            ERG_PER_JOULE
            * HBAR
            * self.eta
            * self.current
            / (2.0 * E_CHARGE * self.ms * self.volume)
        )

    @property
    def demag_field(self):
        """Effective perpendicular anisotropy: Hk - 4 pi Ms  [Oe]."""
        return self.hk - 4.0 * math.pi * self.ms

    def to(self, device=None, dtype=None) -> "STOParams":
        return STOParams(*(leaf.to(device=device, dtype=dtype) for leaf in self))


def default_params(dtype=torch.float32, device=None) -> STOParams:
    """The paper's Table 1 parameter set."""
    dev = resolve_device(device)
    as_ = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    return STOParams(
        gamma=as_(GAMMA),
        alpha=as_(ALPHA),
        ms=as_(MS),
        hk=as_(HK),
        happl=as_(HAPPL),
        eta=as_(ETA),
        lam=as_(LAMBDA),
        current=as_(CURRENT),
        volume=as_(VOLUME),
        a_cp=as_(A_CP),
        a_in=as_(A_IN),
        px=as_(P_PINNED[0]),
        py=as_(P_PINNED[1]),
        pz=as_(P_PINNED[2]),
    )


def initial_magnetization(
    n: int, dtype=torch.float32, phi0: float = PHI0, device=None
) -> torch.Tensor:
    """Paper Eq. (4): identical unit-norm initial state for every oscillator.

    Returns m0 with shape (n, 3); |m0_k| = 1 exactly (up to dtype rounding).
    """
    m0 = torch.tensor(
        [
            math.sin(phi0) * math.cos(phi0),
            math.sin(phi0) * math.sin(phi0),
            math.cos(phi0),
        ],
        dtype=dtype,
        device=resolve_device(device),
    )
    return m0.expand(n, 3)
