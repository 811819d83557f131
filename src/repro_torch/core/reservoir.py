"""Reservoir-computing readouts on top of the coupled-STO integrator.

Pipeline (the paper's application context, [AKT+22]):
  input series u(t)  --drive-->  node states x_t = m^x(t_k)  --fit-->  readout

Only the linear readout is trained, which is what makes reservoir computing
cheap; the expensive part — and the paper's subject — is the simulation of
the reservoir itself (repro_torch.api.compile_plan). `fit_ridge` is batch
ridge regression; `fit_rls` and `fit_lms` are the offline oracles of the
serving engine's online learners (kernels/rls.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import rls as krls


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


def _coerce_targets(states, targets):
    """(states, targets as (T, n_out)) on the states' device, with the
    readouts' explicit targets contract."""
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
    return states, targets


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
    states, targets = _coerce_targets(states, targets)
    dtype = torch.float64 if states.dtype == torch.float64 else torch.float32
    x = states[washout:].to(dtype)
    y = targets[washout:].to(dtype)
    xb = torch.cat([x, torch.ones((x.shape[0], 1), dtype=dtype, device=x.device)], dim=1)
    gram = xb.T @ xb
    rhs = xb.T @ y
    eye = torch.eye(gram.shape[0], dtype=dtype, device=x.device)
    return Readout(w_out=torch.linalg.solve(gram + reg * eye, rhs), washout=washout)


def _learn_rows(states, targets):
    """(T, N) states and (T, n_out) / (T,) targets -> the (T, S) feature
    rows (states + bias) and (T, n_out) targets in the states' dtype."""
    states, targets = _coerce_targets(states, targets)
    ones = torch.ones((states.shape[0], 1), dtype=states.dtype, device=states.device)
    return torch.cat([states, ones], dim=1), targets.to(states.dtype)


def _warm_start(w_init, w0, n_state, n_out):
    if w0 is None:
        return w_init
    return torch.as_tensor(w0, dtype=w_init.dtype).to(w_init.device).reshape(1, n_state, n_out)


def fit_rls(
    states: torch.Tensor,  # (T, N)
    targets: torch.Tensor,  # (T, n_out) or (T,)
    washout: int = 0,
    reg: float = 1e-6,
    lam: float = 1.0,
    w0: Optional[torch.Tensor] = None,  # (N + 1, n_out) warm start
    block: int = 1,
) -> Readout:
    """Recursive-least-squares readout: the offline oracle for streaming
    online learning (`ExecPlan.learn="rls"`).

    Runs the serving engine's update (kernels/rls.py::rls_chunk) over the
    state rows at batch width 1: P starts at I / reg, weights at w0 (zeros
    by default), and the first `washout` rows are masked (exactly-zero
    contributions, like a streaming session's `learn_washout` ticks).

    block matches the serving engine's chunk size: `block=K` applies
    rls_chunk to K-row blocks [0, K), [K, 2K), ..., which is how a served
    session's ticks are blocked (sessions admit at chunk boundaries, so
    their blocking is origin-aligned); the tail is padded with masked rows.
    Every block size, 1 included, goes through rls_chunk, as the engine
    does. Fed a session's harvested states with block == the engine's
    chunk_ticks, this reproduces the session's learned readout bit for bit
    on the CPU (tests/test_torch_rls.py).

    With lam == 1.0 the recursion solves the normal equations of
    `fit_ridge(states, targets, washout, reg)` up to float roundoff; lam < 1
    exponentially forgets old samples.
    """
    xb, y = _learn_rows(states, targets)
    if not 0.0 < float(lam) <= 1.0:
        raise ValueError(f"lam (forgetting factor) must be in (0, 1]; got {lam}")
    if block < 1:
        raise ValueError(f"block must be an int >= 1; got {block}")
    t, n_state = xb.shape
    n_out = y.shape[1]
    dev = xb.device
    mask = torch.arange(t, device=dev) >= washout
    p, w = krls.rls_init(1, n_state, n_out, reg, xb.dtype, device=dev)
    w = _warm_start(w, w0, n_state, n_out)
    pad = (-t) % block
    if pad:
        xb = torch.cat([xb, torch.zeros((pad, n_state), dtype=xb.dtype, device=dev)])
        y = torch.cat([y, torch.zeros((pad, n_out), dtype=y.dtype, device=dev)])
        mask = torch.cat([mask, torch.zeros(pad, dtype=torch.bool, device=dev)])
    for s in range(0, xb.shape[0], block):
        p, w, _ = krls.rls_chunk(
            p, w, xb[s : s + block, None, :], y[s : s + block, None, :],
            mask[s : s + block, None], float(lam),
        )
    return Readout(w_out=w[0], washout=washout)


def fit_lms(
    states: torch.Tensor,  # (T, N)
    targets: torch.Tensor,  # (T, n_out) or (T,)
    washout: int = 0,
    mu: float = 0.5,
    w0: Optional[torch.Tensor] = None,  # (N + 1, n_out) warm start
) -> Readout:
    """Normalized-LMS readout: the offline oracle for streaming online
    learning with `ExecPlan.learn="lms"`.

    Runs the serving engine's update (kernels/rls.py::lms_chunk) over the
    state rows at batch width 1, weights from w0 (zeros by default), the
    first `washout` rows masked. LMS carries no cross-tick P block, so the
    engine's chunk size does not change the op sequence: there is no
    `block` parameter. LMS converges toward the ridge solution but does not
    equal it in finite samples.
    """
    xb, y = _learn_rows(states, targets)
    if not 0.0 < float(mu) < 2.0:
        raise ValueError(f"mu (NLMS step size) must be in (0, 2); got {mu}")
    t, n_state = xb.shape
    n_out = y.shape[1]
    mask = torch.arange(t, device=xb.device) >= washout
    w = _warm_start(krls.lms_init(1, n_state, n_out, xb.dtype, device=xb.device), w0, n_state, n_out)
    w, _ = krls.lms_chunk(w, xb[:, None, :], y[:, None, :], mask[:, None], float(mu))
    return Readout(w_out=w[0], washout=washout)


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
