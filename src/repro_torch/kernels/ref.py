"""Plain PyTorch versions of the kernels (the reference's kernels/ref.py).

Kernel-side state layout:
    m        : (3, N, E)  — component-major so each component is an (N, E)
                            plane; E is the ensemble (serving-slot) axis.
    w_cp     : (N, N)
    params   : (NP, E)    — per-ensemble-member scalar parameters.

PARAM_LAYOUT defines the packing order shared by kernels and plain versions.

Precision: a w_cp whose dtype differs from the state's (bf16, cast once by
the caller) makes the coupling product consume the x-plane rounded to that
dtype and accumulate in the state dtype; everything else stays in the state
dtype. Full-f32 products are a contract: on the card TF32 is switched off
and checked before every product.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.constants import STOParams

PARAM_LAYOUT: Tuple[str, ...] = (
    "pref",  # gamma / (1 + alpha^2)
    "alpha",
    "hs_coef",  # H_s numerator [Oe]
    "lam",
    "happl",
    "demag",  # Hk - 4 pi Ms
    "a_cp",
    "px",
    "py",
    "pz",
)
NP = len(PARAM_LAYOUT)


def pack_params(params: STOParams, e: int, dtype=torch.float32) -> torch.Tensor:
    """Pack STOParams into the kernel's (NP, E) layout.

    Accepts 0-d leaves or (E, 1)-ensemble leaves (`ensemble.broadcast_params`).
    """
    vals = {
        "pref": params.llg_prefactor,
        "alpha": params.alpha,
        "hs_coef": params.hs_coef,
        "lam": params.lam,
        "happl": params.happl,
        "demag": params.demag_field,
        "a_cp": params.a_cp,
        "px": params.px,
        "py": params.py,
        "pz": params.pz,
    }
    rows = [vals[name].to(dtype).reshape(-1).expand(e) for name in PARAM_LAYOUT]
    return torch.stack(rows, dim=0)


def _unpack(pvec: torch.Tensor):
    """(NP, E) -> dict of (E,) rows."""
    return {name: pvec[i] for i, name in enumerate(PARAM_LAYOUT)}


def require_full_f32_matmul() -> None:
    """Switch TF32 off for products on the card, and check that it is off:
    precision None/"highest" means full-f32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 products are on; the plain versions need full f32")


def coupling_dot(w_cp: torch.Tensor, x: torch.Tensor, acc_dtype) -> torch.Tensor:
    """w_cp @ x under the precision policy: for a w_cp of another dtype than
    acc_dtype, x is rounded to w_cp's dtype and both operands are widened
    exactly to acc_dtype, so the products are exact and accumulate there."""
    if w_cp.dtype != acc_dtype:
        x = x.to(w_cp.dtype).to(acc_dtype)
        w_cp = w_cp.to(acc_dtype)
    if w_cp.is_cuda:
        require_full_f32_matmul()
    return torch.matmul(w_cp, x)


def llg_field_planes(m, w_cp, pvec, h_in=None):
    """Vector field in kernel layout.

    m: (3, N, E); w_cp: (N, N); pvec: (NP, E). Returns k: (3, N, E).
    h_in: optional (N, E) input-drive x-field A_in (W^in u), added to the
    coupling field (held constant over a hold window).
    Algebraically identical to core.sto.llg_field.
    """
    p = _unpack(pvec)
    mx, my, mz = m[0], m[1], m[2]  # (N, E)
    hx = p["a_cp"] * coupling_dot(w_cp, mx, m.dtype)
    if h_in is not None:
        hx = hx + h_in
    hz = p["happl"] + p["demag"] * mz
    mdotp = p["px"] * mx + p["py"] * my + p["pz"] * mz
    hs = p["hs_coef"] / (1.0 + p["lam"] * mdotp)
    # b = H + hs * (p x m)
    bx = hx + hs * (p["py"] * mz - p["pz"] * my)
    by = hs * (p["pz"] * mx - p["px"] * mz)
    bz = hz + hs * (p["px"] * my - p["py"] * mx)
    # m x b
    cx = my * bz - mz * by
    cy = mz * bx - mx * bz
    cz = mx * by - my * bx
    # m x (m x b)
    dx = my * cz - mz * cy
    dy = mz * cx - mx * cz
    dz = mx * cy - my * cx
    pref = p["pref"]
    al = p["alpha"]
    kx = -pref * cx - al * pref * dx
    ky = -pref * cy - al * pref * dy
    kz = -pref * cz - al * pref * dz
    return torch.stack([kx, ky, kz], dim=0)


def rk4_step_planes(m, w_cp, pvec, dt, h_in=None):
    """One classical RK4 step in kernel layout."""
    k1 = llg_field_planes(m, w_cp, pvec, h_in)
    k2 = llg_field_planes(m + 0.5 * dt * k1, w_cp, pvec, h_in)
    k3 = llg_field_planes(m + 0.5 * dt * k2, w_cp, pvec, h_in)
    k4 = llg_field_planes(m + dt * k3, w_cp, pvec, h_in)
    return m + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4_multi_step_planes(m, w_cp, pvec, dt, n_inner: int, h_in=None):
    """n_inner RK4 steps (plain version of the fused kernel)."""
    for _ in range(n_inner):
        m = rk4_step_planes(m, w_cp, pvec, dt, h_in)
    return m


def rk4_chunk_planes(
    m,  # (3, N, E) state
    w_cp,  # (N, N) — pre-cast by the caller for reduced-precision coupling
    pvec,  # (NP, E)
    dt,
    hold_steps: int,
    h_block,  # (K, N, E) per-tick input-drive x-fields
    mask_block,  # (K, E) bool; False = lane frozen that tick
):
    """K ticks x hold_steps RK4 steps: the plain version behind impl="chunk".

    A lane masked False for a tick comes back bit-identical (a select).
    dt enters as a state-dtype scalar, as in the reference's chunk body.
    Returns (m' (3, N, E), states (K, N, E)).
    """
    dt_c = torch.full((), float(dt), dtype=m.dtype, device=m.device)
    states = []
    for t in range(h_block.shape[0]):
        m_new = m
        for _ in range(hold_steps):
            m_new = rk4_step_planes(m_new, w_cp, pvec, dt_c, h_block[t])
        m = torch.where(mask_block[t][None, None, :], m_new, m)
        states.append(m[0])
    return m, torch.stack(states)
