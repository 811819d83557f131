"""LLG vector field for N coupled spin-torque oscillators (paper Eq. 1-3).

State layout: m with shape (..., N, 3) — leading axes are ensemble/batch.

  dm_k/dt = -pref * m_k x b_k  -  alpha * pref * m_k x (m_k x b_k)
  pref    = gamma / (1 + alpha^2)
  b_k     = H_total_k + H_s(m_k) * (p x m_k)
  H_total = [Happl + (Hk - 4 pi Ms) m_k^z] e_z
            + A_cp (W^cp m^x)_k e_x  +  A_in (W^in u)_k e_x
  H_s     = hs_coef / (1 + lam * m_k . p)

This is the physics reference the planes-layout plain versions
(kernels/ref.py) are checked against.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.constants import STOParams
from repro_torch.core.coupling import coupling_field_x


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing axis of size 3 (written out)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def effective_field_b(m: torch.Tensor, params: STOParams, h_x: torch.Tensor) -> torch.Tensor:
    """b = H_total + H_s p x m, given the total x-field h_x (coupling+input).

    m: (..., N, 3); h_x: (..., N). Returns (..., N, 3).
    """
    shape = m[..., 0].shape
    p = torch.stack(
        [params.px.expand(shape), params.py.expand(shape), params.pz.expand(shape)], dim=-1
    )
    mdotp = torch.sum(m * p, dim=-1)
    h_s = params.hs_coef / (1.0 + params.lam * mdotp)  # (..., N)
    h_z = params.happl + params.demag_field * m[..., 2]  # (..., N)
    h_field = torch.stack([h_x, torch.zeros_like(h_x), h_z], dim=-1)
    return h_field + h_s[..., None] * _cross(p, m)


def llg_rhs_from_b(m: torch.Tensor, b: torch.Tensor, params: STOParams) -> torch.Tensor:
    """dm/dt given the effective field b (paper Eq. 1)."""
    # leaves are 0-d or (E, 1); one more axis broadcasts them over (..., N, 3)
    pref = params.llg_prefactor.unsqueeze(-1)
    alpha = params.alpha.unsqueeze(-1)
    m_x_b = _cross(m, b)
    m_x_m_x_b = _cross(m, m_x_b)
    return -pref * m_x_b - alpha * pref * m_x_m_x_b


def llg_field(
    m: torch.Tensor,
    params: STOParams,
    w_cp: Optional[torch.Tensor],
    h_in_x: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full vector field: local terms + O(N^2) coupling (+ input drive).

    m:      (..., N, 3)
    w_cp:   (N, N) or None (uncoupled — O(N) evaluation, paper §3.2 remark)
    h_in_x: (..., N) input field A_in W^in u, already projected; or None.
    """
    if w_cp is not None:
        h_x = coupling_field_x(w_cp, m[..., 0], params.a_cp)
    else:
        h_x = torch.zeros_like(m[..., 0])
    if h_in_x is not None:
        h_x = h_x + h_in_x
    b = effective_field_b(m, params, h_x)
    return llg_rhs_from_b(m, b, params)


def norm_error(m: torch.Tensor) -> torch.Tensor:
    """max_k | |m_k| - 1 | — the paper's conservation-law correctness oracle."""
    return torch.max(torch.abs(torch.linalg.vector_norm(m, dim=-1) - 1.0))
