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
from repro_torch.device import require_full_f32_matmul

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


# ---------------------------------------------------------------------------
# Physics families (SimSpec.topology): planes-layout chunk bodies
# ---------------------------------------------------------------------------


def rk4_chunk_planes_window(
    m,  # (3, N, E) state
    w_cp,  # (N, N) — pre-cast by the caller for reduced-precision coupling
    pvec,  # (NP, E)
    dt,
    hold_steps: int,
    readout_window: int,
    h_block,  # (K, N, E) per-tick input-drive x-fields
    mask_block,  # (K, E) bool; False = lane frozen that tick
):
    """topology="array_transient" chunk body (Kanao et al., arXiv:1905.07937).

    The coupled-array dynamics of `rk4_chunk_planes`; only the emitted
    per-tick state differs: the mean of the m_x plane over the LAST
    `readout_window` RK substeps of the hold window instead of the endpoint.
    The hold window is split (hold_steps - w) + w with the same per-step op
    sequence, so readout_window=1 is bit-identical to `rk4_chunk_planes`.
    Returns (m' (3, N, E), states (K, N, E)).
    """
    dt_c = torch.full((), float(dt), dtype=m.dtype, device=m.device)
    w = int(readout_window)
    states = []
    for t in range(h_block.shape[0]):
        m_new = m
        for _ in range(hold_steps - w):
            m_new = rk4_step_planes(m_new, w_cp, pvec, dt_c, h_block[t])
        xs = []
        for _ in range(w):
            m_new = rk4_step_planes(m_new, w_cp, pvec, dt_c, h_block[t])
            xs.append(m_new[0])
        state = torch.stack(xs).mean(dim=0) if w > 1 else xs[0]
        keep = mask_block[t]
        state = torch.where(keep[None, :], state, m[0])
        m = torch.where(keep[None, None, :], m_new, m)
        states.append(state)
    return m, torch.stack(states)


def tm_feedback(h_ext, w_cp, x_prev, pvec):
    """A time-multiplexed tick's node drives (N, E): the masked input field
    plus the delayed feedback a_cp * (W^cp @ x_prev) from the previous
    tick's snapshots, under the precision policy (a pre-cast w_cp)."""
    return h_ext + pvec[PARAM_LAYOUT.index("a_cp")] * coupling_dot(w_cp, x_prev, x_prev.dtype)


def tm_delay_line_plain(s0, h_t, pvec, dt, hold_steps: int):
    """One tick's delay line, every lane: the carried oscillator s0 (3, E)
    runs hold_steps RK4 steps under node j's drive h_t[j] (E,) for j = 0 ..
    N-1 in turn, and its state after node j is snapshot j. Returns the
    snapshots (3, N, E). The plain version of `sto_step.tm_delay_line`.

    A single oscillator has no array coupling: its field is
    `llg_field_planes` with a (1, 1) zero W, whose coupling term a_cp * (0
    x) = +-0 changes nothing. dt enters as a 0-d f32 tensor on the CPU, so
    the RK4 coefficients dt / 2 and dt / 6 are rounded on the host whatever
    device the planes are on (the CUDA kernel takes them from the host too).
    """
    dt_c = torch.full((), float(dt), dtype=s0.dtype)
    w_zero = torch.zeros((1, 1), dtype=s0.dtype, device=s0.device)
    s = s0.reshape(3, 1, -1)
    snaps = []
    for j in range(h_t.shape[0]):
        h_j = h_t[j : j + 1]
        for _ in range(hold_steps):
            s = rk4_step_planes(s, w_zero, pvec, dt_c, h_j)
        snaps.append(s[:, 0])
    return torch.stack(snaps, dim=1)


def tm_chunk_planes(
    m,  # (3, N, E) virtual-node snapshots; row N-1 carries the oscillator
    w_cp,  # (N, N) feedback mixing — pre-cast for reduced-precision coupling
    pvec,  # (NP, E)
    dt,
    hold_steps: int,
    h_block,  # (K, N, E) per-tick masked-input x-fields A_in (W^in u)
    mask_block,  # (K, E) bool; False = lane frozen that tick
):
    """topology="time_multiplexed" chunk body (Riou et al., arXiv:1904.11236).

    ONE physical oscillator per lane; its N virtual nodes are its snapshots
    at the ends of consecutive hold windows. Per tick the node drives are
    the masked input field plus the delayed feedback from the previous
    tick's snapshots (`tm_feedback`; w_cp = I is the classic delay line),
    then the delay line itself (`tm_delay_line_plain`): sequential over the
    N nodes, independent across lanes. A lane masked False comes back
    bit-identical. Returns (m' (3, N, E), states (K, N, E)).
    """
    n = m.shape[1]
    states = []
    for t in range(h_block.shape[0]):
        h_t = tm_feedback(h_block[t], w_cp, m[0], pvec)
        m_new = tm_delay_line_plain(m[:, n - 1], h_t, pvec, dt, hold_steps)
        m = torch.where(mask_block[t][None, None, :], m_new, m)
        states.append(m[0])
    return m, torch.stack(states)
