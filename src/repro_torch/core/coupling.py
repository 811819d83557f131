"""Coupling / input weight construction (paper §3.1).

W^cp: N x N, zero diagonal (no self-coupling), off-diagonal iid U[-1, 1],
rescaled to spectral radius 1. W^in: N x N_in, iid U[-1, 1].

Spectral radius: exact dense eigvals for moderate N; for large N the circular
law gives rho ~ sigma * sqrt(N) for iid zero-mean entries (sigma^2 = 1/3 for
U[-1,1]), refined by a few power iterations on W W^T pairs to bound the error.
Construction runs once at setup time on the host (NumPy); these functions are
the reference's, so the same seed gives byte-identical matrices.
"""

from __future__ import annotations

import numpy as np
import torch

# Above this N, exact eigvals (O(N^3)) get replaced by the circular-law
# estimate with a power-iteration refinement.
_EXACT_EIG_MAX_N = 2048


def spectral_radius(w: np.ndarray, exact_max_n: int = _EXACT_EIG_MAX_N) -> float:
    """Largest |eigenvalue| of a square matrix."""
    n = w.shape[0]
    if n <= exact_max_n:
        return float(np.max(np.abs(np.linalg.eigvals(w))))
    # Circular law estimate for iid entries: rho ~ sigma sqrt(N).
    sigma = float(np.std(w))
    est = sigma * np.sqrt(n)
    # Refine with power iteration on (W @ W) using a complex start vector:
    # for non-normal random W the dominant eigenvalue may be complex, so we
    # track the Rayleigh-quotient magnitude of W applied twice, which
    # converges in magnitude even for complex-conjugate dominant pairs.
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    v /= np.linalg.norm(v)
    lam = est
    for _ in range(60):
        v2 = w @ (w @ v)
        nrm = np.linalg.norm(v2)
        if nrm == 0.0:
            break
        lam = np.sqrt(nrm)
        v = v2 / nrm
    # Power iteration on W^2 gives |lambda_max|^2's sqrt = |lambda_max| when
    # it converges; fall back to the circular-law estimate if it diverges
    # from it wildly (non-convergence).
    if not np.isfinite(lam) or lam <= 0 or abs(lam - est) > 0.5 * est:
        lam = est
    return float(lam)


def make_coupling_matrix(
    n: int,
    seed: int = 0,
    target_rho: float = 1.0,
    dtype=np.float32,
) -> np.ndarray:
    """Paper's W^cp: zero diagonal, off-diagonal U[-1,1], rho(W) = target_rho."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-1.0, 1.0, size=(n, n)).astype(np.float64)
    np.fill_diagonal(w, 0.0)
    if n == 1:
        return w.astype(dtype)  # single oscillator: no coupling at all
    rho = spectral_radius(w)
    if rho > 0:
        w = w * (target_rho / rho)
    return w.astype(dtype)


def make_input_matrix(
    n: int,
    n_in: int,
    seed: int = 1,
    dtype=np.float32,
) -> np.ndarray:
    """Paper's W^in: N x N_in iid U[-1, 1]."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, size=(n, n_in)).astype(dtype)


def coupling_field_x(w_cp: torch.Tensor, mx: torch.Tensor, a_cp) -> torch.Tensor:
    """H^cp x-component: a_cp * (W^cp @ m^x)  — the paper's O(N^2) term.

    mx: (..., N) -> returns (..., N), one matmul over the trailing axis.
    """
    return a_cp * torch.einsum("ki,...i->...k", w_cp, mx)
