"""Reservoir-computing readouts on top of the coupled-STO integrator.

Pipeline (the paper's application context, [AKT+22]):
  input series u(t)  --drive-->  node states x_t = m^x(t_k)  --fit-->  readout

Only the linear readout is trained, which is what makes reservoir computing
cheap; the expensive part — and the paper's subject — is the simulation of
the reservoir itself (repro_torch.api.compile_plan). `fit_ridge` is batch
ridge regression; the online RLS/LMS trainers are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Readout(NamedTuple):
    w_out: torch.Tensor  # (N + 1, n_out) — last row is the bias
    washout: int


def coerce_input_series(u_seq, n_in: int, dtype, xp=torch):
    """Validate an input series against the explicit (T, N_in) contract.

    Accepts (T, N_in), or 1-D (T,) when n_in == 1. Anything else — including
    a (1, T) row — raises with the expected shape spelled out. xp=numpy (with
    a numpy dtype) keeps the series host-side: the serving engine assembles
    its input blocks on the host.
    """
    if xp is np:
        u_seq = np.asarray(u_seq, dtype=dtype)
    else:
        u_seq = torch.as_tensor(u_seq, dtype=dtype)
    if u_seq.ndim == 1:
        if n_in != 1:
            raise ValueError(
                f"1-D input series is only valid for n_in == 1; this "
                f"reservoir has n_in == {n_in}. Pass shape (T, {n_in})."
            )
        return u_seq[:, None]
    if u_seq.ndim != 2 or u_seq.shape[1] != n_in:
        raise ValueError(
            f"input series must have shape (T, {n_in}) — one row per sample, "
            f"one column per input channel — or (T,) when n_in == 1; got "
            f"{tuple(u_seq.shape)}. A (1, T) series must be passed as (T, 1)."
        )
    return u_seq


def fit_ridge(
    states: torch.Tensor,  # (T, N)
    targets: torch.Tensor,  # (T, n_out) or (T,)
    washout: int = 0,
    reg: float = 1e-6,
) -> Readout:
    """Ridge regression readout: solve (X^T X + reg I) W = X^T Y.

    targets is (T, n_out) — one row per sample, aligned with states (T, N) —
    or 1-D (T,) for a single output; a (1, T) row vector is rejected. The
    system is solved in f64 for f64 states and in f32 otherwise.
    """
    states = torch.as_tensor(states)
    targets = torch.as_tensor(targets, device=states.device)
    t = states.shape[0]
    if targets.ndim == 1:
        targets = targets[:, None]
    if targets.ndim != 2 or targets.shape[0] != t:
        raise ValueError(
            f"targets must have shape ({t}, n_out) — one row per state "
            f"sample — or ({t},) for a single output; got "
            f"{tuple(targets.shape)} against states {tuple(states.shape)}. "
            f"A (1, T) row vector must be passed as (T,) or (T, 1)."
        )
    dtype = torch.float64 if states.dtype == torch.float64 else torch.float32
    x = states[washout:].to(dtype)
    y = targets[washout:].to(dtype)
    xb = torch.cat([x, torch.ones((x.shape[0], 1), dtype=dtype, device=x.device)], dim=1)
    gram = xb.T @ xb
    rhs = xb.T @ y
    eye = torch.eye(gram.shape[0], dtype=dtype, device=x.device)
    return Readout(w_out=torch.linalg.solve(gram + reg * eye, rhs), washout=washout)


def predict(readout: Readout, states: torch.Tensor) -> torch.Tensor:
    x = states[readout.washout :]
    ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
    xb = torch.cat([x, ones], dim=1).to(readout.w_out.dtype)
    return xb @ readout.w_out


def nmse(pred: torch.Tensor, target) -> float:
    target = torch.as_tensor(target, device=pred.device).reshape(pred.shape).to(pred.dtype)
    num = torch.mean((pred - target) ** 2)
    den = torch.var(target, correction=0) + 1e-30
    return float(num / den)
