"""Explicit time integrators (Butcher tableaux) and the loops that run them.

The paper uses classical RK4 (dt = 1e-11, 5e5 steps). A generic explicit-RK
stepper lets "any reservoir whose evolution can be approximated using an
explicit method" (paper §5) plug in. The three loops mirror the paper's
implementation ladder:

  integrate_python_loop : one step function called per step from Python
                          (the paper's NumPy-base analogue).
  integrate_scan        : the whole trajectory in one call (the reference
                          runs it as one compiled lax.scan; PyTorch runs the
                          same steps eagerly, one op after another).
  (kernels/ops.py)      : the fused CUDA kernel.

The stepper's op order is the reference's: zero a_ij and b_i are skipped,
dy is built term by term, and `dt` is a 0-d tensor of the state's dtype, so
`dt * a_ij` rounds in that dtype (an f32 state never sees an f64 product).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

Field = Callable[[torch.Tensor, Any], torch.Tensor]  # f(y, args) -> dy/dt


class Tableau(NamedTuple):
    a: Tuple[Tuple[float, ...], ...]  # strictly lower-triangular rows
    b: Tuple[float, ...]
    c: Tuple[float, ...]
    order: int


EULER = Tableau(a=((),), b=(1.0,), c=(0.0,), order=1)
HEUN = Tableau(a=((), (1.0,)), b=(0.5, 0.5), c=(0.0, 1.0), order=2)
RK4 = Tableau(
    a=((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
    b=(1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0),
    c=(0.0, 0.5, 0.5, 1.0),
    order=4,
)
# Bogacki–Shampine 3(2): embedded pair for the adaptive integrator
BS32 = Tableau(
    a=((), (0.5,), (0.0, 0.75), (2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0)),
    b=(2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0, 0.0),
    c=(0.0, 0.5, 0.75, 1.0),
    order=3,
)
BS32_B_LOW = (7.0 / 24.0, 0.25, 1.0 / 3.0, 0.125)  # 2nd-order embedded

TABLEAUX = {"euler": EULER, "heun": HEUN, "rk4": RK4, "bs32": BS32}


def dt_tensor(dt, y: torch.Tensor) -> torch.Tensor:
    """`dt` as a 0-d tensor of y's dtype on y's device."""
    return torch.as_tensor(dt, dtype=y.dtype, device=y.device)


def make_step(field: Field, tableau: Tableau = RK4) -> Callable:
    """Returns step(y, dt, args) -> y_next for an explicit tableau.

    Time-autonomous form: the STO field has no explicit t dependence between
    input samples (input is held piecewise-constant), matching the paper's
    benchmark (u = 0).
    """

    def step(y, dt, args):
        ks = []
        for row in tableau.a:
            yi = y
            for aij, kj in zip(row, ks):
                if aij != 0.0:
                    yi = yi + (dt * aij) * kj
            ks.append(field(yi, args))
        dy = None
        for bi, ki in zip(tableau.b, ks):
            if bi == 0.0:
                continue
            term = (dt * bi) * ki
            dy = term if dy is None else dy + term
        return y + dy

    return step


def integrate_scan(
    field: Field,
    y0: torch.Tensor,
    dt: float,
    n_steps: int,
    args: Any = None,
    tableau: Tableau = RK4,
    save_every: int = 0,
):
    """Whole-trajectory integration -> (yT, ys).

    save_every == 0: ys is None.
    save_every == k: ys holds y at every k-th step,
                     shape (n_steps // k, *y0.shape).
    """
    step = make_step(field, tableau)
    dt = dt_tensor(dt, y0)
    y = y0
    if save_every:
        if n_steps % save_every:
            raise ValueError(
                f"n_steps ({n_steps}) must be a multiple of save_every ({save_every})"
            )
        ys = []
        for _ in range(n_steps // save_every):
            for _ in range(save_every):
                y = step(y, dt, args)
            ys.append(y)
        return y, torch.stack(ys)
    for _ in range(n_steps):
        y = step(y, dt, args)
    return y, None


def integrate_python_loop(
    field: Field,
    y0: torch.Tensor,
    dt: float,
    n_steps: int,
    args: Any = None,
    tableau: Tableau = RK4,
):
    """The paper's NumPy-base analogue: one step function, called from
    Python once per step."""
    step = make_step(field, tableau)
    y = y0
    dt = dt_tensor(dt, y0)
    for _ in range(n_steps):
        y = step(y, dt, args)
    return y


def integrate_adaptive(
    field: Field,
    y0: torch.Tensor,
    t_end: float,
    args: Any = None,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    dt0: float = 1e-12,
    max_steps: int = 100_000,
    safety: float = 0.9,
):
    """Adaptive Bogacki–Shampine 3(2) with step control. Returns
    (yT, stats dict with "steps", "rejected", "t", "dt_final").

    The paper fixes dt=1e-11 by hand; the adaptive integrator picks dt to a
    tolerance instead. Rejected steps don't advance t; dt adapts by
    err^(-1/3) within [0.2, 5]x. The loop condition is read on the host
    every step.
    """
    step3 = make_step(field, BS32)

    def low_order(y, dt, args):
        ks = []
        for row in BS32.a:
            yi = y
            for aij, kj in zip(row, ks):
                if aij != 0.0:
                    yi = yi + (dt * aij) * kj
            ks.append(field(yi, args))
        out = y
        for bi, ki in zip(BS32_B_LOW, ks):
            out = out + (dt * bi) * ki
        return out

    t_end = dt_tensor(t_end, y0)
    t = torch.zeros((), dtype=y0.dtype, device=y0.device)
    dt = dt_tensor(dt0, y0)
    y, n, n_rej = y0, 0, 0
    while n < max_steps and bool(t < t_end):
        dt_c = torch.minimum(dt, t_end - t)
        y_hi = step3(y, dt_c, args)
        y_lo = low_order(y, dt_c, args)
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_hi))
        err = torch.sqrt(torch.mean(((y_hi - y_lo) / scale) ** 2))
        accept = bool(err <= 1.0)
        fac = torch.clip(safety * err ** (-1.0 / 3.0), 0.2, 5.0)
        if accept:
            t = t + dt_c
            y = y_hi
        else:
            n_rej += 1
        dt = dt_c * fac
        n += 1
    return y, {"steps": n, "rejected": n_rej, "t": t, "dt_final": dt}


def convergence_order(
    field: Field,
    y0: torch.Tensor,
    t_end: float,
    args: Any = None,
    tableau: Tableau = RK4,
    base_steps: int = 16,
    levels: int = 3,
) -> float:
    """Empirical order via Richardson: error vs a 4x-refined reference.

    Returns the mean observed slope log2(e_h / e_{h/2}); ~tableau.order for a
    smooth field.
    """
    ref_steps = base_steps * (2 ** (levels + 2))
    ref, _ = integrate_scan(field, y0, t_end / ref_steps, ref_steps, args, tableau)
    errs = []
    for lvl in range(levels):
        n = base_steps * (2**lvl)
        y, _ = integrate_scan(field, y0, t_end / n, n, args, tableau)
        errs.append(float(torch.max(torch.abs(y - ref))))
    slopes = [np.log2(errs[i] / errs[i + 1]) for i in range(levels - 1)]
    return float(np.mean(slopes))
