"""Benchmark tasks for reservoir readouts (standard in the RC literature the
paper cites: NARMA, delay memory / memory capacity)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def narma_series(
    t: int, order: int = 10, seed: int = 0, warmup: int = 200
) -> Tuple[np.ndarray, np.ndarray]:
    """NARMA-`order` input/target series.

    y_{t+1} = 0.3 y_t + 0.05 y_t sum_{i<order} y_{t-i} + 1.5 u_{t-order+1} u_t + 0.1
    with u ~ U[0, 0.5]. Returns (u, y) of length `t` after warmup.

    The recursion is only stable for moderate orders (NARMA-10 is the
    standard benchmark; beyond ~20 the feedback term can blow up for many
    input draws) — a diverging series raises instead of silently handing a
    readout inf/overflowed targets.
    """
    if not isinstance(order, (int, np.integer)) or isinstance(order, bool) or order < 1:
        raise ValueError(f"order must be an int >= 1; got {order!r}")
    if t < 1:
        raise ValueError(f"t must be >= 1; got {t}")
    rng = np.random.default_rng(seed)
    total = t + warmup + order
    u = rng.uniform(0.0, 0.5, size=total)
    y = np.zeros(total)
    with np.errstate(over="ignore", invalid="ignore"):
        for k in range(order, total - 1):
            y[k + 1] = (
                0.3 * y[k]
                + 0.05 * y[k] * np.sum(y[k - order + 1 : k + 1])
                + 1.5 * u[k - order + 1] * u[k]
                + 0.1
            )
    if not np.isfinite(y).all() or np.abs(y).max() > 1e3:
        raise ValueError(
            f"NARMA-{order} series diverged (|y| reached "
            f"{np.abs(y).max():.2e}); the recursion is unstable at this "
            f"order/seed — use order <= 10 or try another seed"
        )
    return u[warmup : warmup + t], y[warmup : warmup + t]


def delay_memory_targets(u: np.ndarray, max_delay: int) -> np.ndarray:
    """Targets y_d[t] = u[t - d] for d = 1..max_delay (memory-capacity task).

    Returns (T, max_delay); the first max_delay rows should be washed out.

    >>> delay_memory_targets(np.array([1.0, 2.0, 3.0, 4.0]), 2)
    array([[0., 0.],
           [1., 0.],
           [2., 1.],
           [3., 2.]])
    """
    if max_delay < 1:
        raise ValueError(f"max_delay must be >= 1; got {max_delay}")
    t = len(u)
    out = np.zeros((t, max_delay), dtype=u.dtype)
    for d in range(1, max_delay + 1):
        out[d:, d - 1] = u[: t - d]
    return out


def memory_capacity(pred: np.ndarray, target: np.ndarray) -> float:
    """MC = sum_d corr^2(pred_d, target_d)  (Jaeger's memory capacity).

    A zero-variance column (constant prediction or constant target — e.g.
    an untrained delay) has no defined correlation; it contributes 0 to the
    capacity instead of propagating NaN.

    >>> memory_capacity(np.array([[1.0, 5.0], [2.0, 5.0], [3.0, 5.0]]),
    ...                 np.array([[1.0, 0.0], [2.0, 1.0], [3.0, 2.0]]))
    1.0
    """
    mc = 0.0
    for d in range(target.shape[1]):
        p, y = pred[:, d], target[:, d]
        with np.errstate(invalid="ignore", divide="ignore"):
            c = np.corrcoef(p, y)[0, 1]
        if np.isfinite(c):
            mc += float(c) ** 2
    return mc


def sine_task(t: int, freq: float = 0.02, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """u = white noise, y = sin of the integrated input — a smooth nonlinear map."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.5, 0.5, size=t)
    phase = np.cumsum(u) * freq
    return u, np.sin(2.0 * np.pi * phase)
