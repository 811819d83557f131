"""Search strategies: seeded random, exhaustive grid, and a small CMA-ES.

All strategies speak one async ask/tell protocol, designed around the
driver's lane-vectorized evaluation (candidates finish in chunk-boundary
batches, not one by one):

    ask(n)        up to n new (token, genotype) pairs to evaluate next.
                  genotype is a point in [0, 1]^d (see tune.space). An
                  EMPTY list means "nothing to hand out right now" — either
                  the strategy is waiting on outstanding tells (CMA-ES
                  finishes a generation before sampling the next) or it is
                  exhausted; the driver keeps draining in-flight trials
                  either way.
    tell(token, fitness)
                  report a finished evaluation. fitness is MINIMIZED and
                  must be finite (the driver maps failed candidates to a
                  large penalty before telling).
    exhausted     True once no future ask() will ever yield candidates.

Determinism: a strategy's proposals depend only on (seed, the sequence of
tells) — the driver tells finished trials in trial-id order at each
harvest, so a fixed-seed tune run reproduces its trial history exactly.

CMA-ES follows Hansen's (mu/mu_w, lambda) tutorial form with rank-1 +
rank-mu covariance updates and CSA step-size control, on the unit cube
with boundary repair (samples clip to [0, 1]^d and the update uses the
repaired points). Dependency-free: a handful of numpy ops per generation
on a d x d matrix, d = a few knobs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.tune.space import Choice, Float, LogFloat, SearchSpace


class Strategy:
    """Base: token bookkeeping shared by every strategy."""

    name = "base"

    def __init__(self, space: SearchSpace, budget: int, seed: int = 0):
        if budget < 1:
            raise ValueError(f"budget must be >= 1; got {budget}")
        self.space = space
        self.budget = int(budget)
        self.seed = int(seed)
        self._next_token = 0
        self._outstanding: Dict[int, np.ndarray] = {}
        self.told = 0

    def _issue(self, genotype: np.ndarray) -> Tuple[int, np.ndarray]:
        token = self._next_token
        self._next_token += 1
        g = np.asarray(genotype, dtype=np.float64)
        self._outstanding[token] = g
        return token, g

    def ask(self, n: int) -> List[Tuple[int, np.ndarray]]:
        raise NotImplementedError

    def tell(self, token: int, fitness: float) -> None:
        if token not in self._outstanding:
            raise KeyError(f"unknown or already-told token {token}")
        if not np.isfinite(fitness):
            raise ValueError(
                f"fitness must be finite (drivers map failures to a "
                f"penalty); got {fitness!r}"
            )
        g = self._outstanding.pop(token)
        self.told += 1
        self._observe(token, g, float(fitness))

    def _observe(self, token: int, genotype: np.ndarray, fitness: float) -> None:
        pass  # random/grid don't adapt

    @property
    def issued(self) -> int:
        return self._next_token

    @property
    def exhausted(self) -> bool:
        raise NotImplementedError


class RandomSearch(Strategy):
    """Seeded uniform sampling of the unit cube — the embarrassingly
    parallel baseline: every candidate is independent, so ask(n) always
    fills the caller's lanes up to the budget."""

    name = "random"

    def __init__(self, space: SearchSpace, budget: int, seed: int = 0):
        super().__init__(space, budget, seed)
        self._rng = np.random.default_rng(seed)

    def ask(self, n: int) -> List[Tuple[int, np.ndarray]]:
        n = min(n, self.budget - self.issued)
        return [
            self._issue(self._rng.uniform(0.0, 1.0, self.space.dim))
            for _ in range(max(n, 0))
        ]

    @property
    def exhausted(self) -> bool:
        return self.issued >= self.budget


class GridSearch(Strategy):
    """Exhaustive grid in deterministic order — the sequential parameter
    sweep expressed as a strategy.

    Choice knobs enumerate their values; continuous knobs (Float/LogFloat)
    take `points` evenly spaced cube coordinates (so LogFloat grids are
    log-spaced in value). The full product enumerates in row-major order
    over the space's sorted knob names; budget truncates.
    """

    name = "grid"

    def __init__(
        self,
        space: SearchSpace,
        budget: int,
        seed: int = 0,  # unused; kept for the common constructor signature
        points: int = 5,
    ):
        super().__init__(space, budget, seed)
        if points < 1:
            raise ValueError(f"points must be >= 1; got {points}")
        axes = []
        for name in space.names:
            dom = space.knobs[name]
            if isinstance(dom, Choice):
                k = len(dom.values)
                # bucket midpoints decode back to exactly values[i]
                axes.append((np.arange(k) + 0.5) / k)
            else:
                axes.append(
                    np.linspace(0.0, 1.0, points)
                    if points > 1
                    else np.asarray([0.5])
                )
        self._axes = axes
        self.grid_size = int(np.prod([len(a) for a in axes]))
        self._count = min(self.grid_size, self.budget)

    def _genotype(self, i: int) -> np.ndarray:
        g = np.empty(len(self._axes))
        for ax in range(len(self._axes) - 1, -1, -1):
            k = len(self._axes[ax])
            g[ax] = self._axes[ax][i % k]
            i //= k
        return g

    def ask(self, n: int) -> List[Tuple[int, np.ndarray]]:
        out = []
        while len(out) < n and self.issued < self._count:
            out.append(self._issue(self._genotype(self.issued)))
        return out

    @property
    def exhausted(self) -> bool:
        return self.issued >= self._count


class CMAES(Strategy):
    """(mu/mu_w, lambda)-CMA-ES on the unit cube, generation-buffered.

    ask() hands out the current generation's unsampled candidates; once
    every member is told, the distribution updates and the next generation
    samples. While a generation is partially outstanding, ask() returns []
    — the driver keeps draining lanes and comes back. popsize defaults to
    the textbook 4 + floor(3 ln d), but passing popsize = the engine's
    lane width fills every lane per generation.
    """

    name = "cmaes"

    def __init__(
        self,
        space: SearchSpace,
        budget: int,
        seed: int = 0,
        sigma0: float = 0.3,
        popsize: Optional[int] = None,
        x0: Optional[np.ndarray] = None,
    ):
        super().__init__(space, budget, seed)
        d = space.dim
        self._rng = np.random.default_rng(seed)
        self.lam = int(popsize) if popsize else 4 + int(3 * math.log(max(d, 2)))
        if self.lam < 2:
            raise ValueError(f"popsize must be >= 2; got {self.lam}")
        self.mu = self.lam // 2
        w = math.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.w = w / w.sum()
        self.mu_eff = 1.0 / float(np.sum(self.w**2))
        self.c_sigma = (self.mu_eff + 2.0) / (d + self.mu_eff + 5.0)
        self.d_sigma = (
            1.0
            + 2.0 * max(0.0, math.sqrt((self.mu_eff - 1.0) / (d + 1.0)) - 1.0)
            + self.c_sigma
        )
        self.c_c = (4.0 + self.mu_eff / d) / (d + 4.0 + 2.0 * self.mu_eff / d)
        self.c_1 = 2.0 / ((d + 1.3) ** 2 + self.mu_eff)
        self.c_mu = min(
            1.0 - self.c_1,
            2.0 * (self.mu_eff - 2.0 + 1.0 / self.mu_eff)
            / ((d + 2.0) ** 2 + self.mu_eff),
        )
        self.chi_d = math.sqrt(d) * (1.0 - 1.0 / (4.0 * d) + 1.0 / (21.0 * d * d))

        self.m = (
            np.full(d, 0.5) if x0 is None else np.clip(np.asarray(x0, float), 0, 1)
        )
        self.sigma = float(sigma0)
        self.C = np.eye(d)
        self.p_sigma = np.zeros(d)
        self.p_c = np.zeros(d)
        self.generation = 0

        self._queue: List[np.ndarray] = []  # sampled, not yet asked out
        self._gen_tokens: Dict[int, int] = {}  # token -> index in generation
        self._gen_x: List[Optional[np.ndarray]] = []
        self._gen_f: List[Optional[float]] = []

    def _sample_generation(self) -> None:
        n = min(self.lam, self.budget - self.issued)
        if n <= 0:
            return
        d = self.space.dim
        # eigendecomposition of C once per generation (d is tiny)
        evals, B = np.linalg.eigh(self.C)
        D = np.sqrt(np.maximum(evals, 1e-20))
        z = self._rng.standard_normal((n, d))
        x = self.m[None, :] + self.sigma * (z * D[None, :]) @ B.T
        x = np.clip(x, 0.0, 1.0)  # boundary repair; update uses repaired x
        self._queue = [x[i] for i in range(n)]
        self._gen_x = [None] * n
        self._gen_f = [None] * n
        self._gen_tokens = {}
        self.generation += 1

    def ask(self, n: int) -> List[Tuple[int, np.ndarray]]:
        if not self._queue and not self._outstanding:
            self._sample_generation()
        out = []
        while len(out) < n and self._queue:
            g = self._queue.pop(0)
            token, g = self._issue(g)
            self._gen_tokens[token] = len(self._gen_tokens)
            out.append((token, g))
        return out

    def _observe(self, token: int, genotype: np.ndarray, fitness: float) -> None:
        i = self._gen_tokens[token]
        self._gen_x[i] = genotype
        self._gen_f[i] = fitness
        if self._queue or self._outstanding:
            return  # generation still in flight
        self._update(
            [x for x in self._gen_x if x is not None],
            [f for f in self._gen_f if f is not None],
        )

    def _update(self, xs: List[np.ndarray], fs: List[float]) -> None:
        if len(xs) < 2:
            return  # a truncated final generation can't rank parents
        d = self.space.dim
        order = np.argsort(fs, kind="stable")
        mu = min(self.mu, len(xs))
        w = self.w[:mu] / self.w[:mu].sum()
        mu_eff = 1.0 / float(np.sum(w**2))
        x_sel = np.stack([xs[order[i]] for i in range(mu)])
        y_sel = (x_sel - self.m[None, :]) / self.sigma
        y_w = w @ y_sel  # (d,)
        m_new = self.m + self.sigma * y_w

        evals, B = np.linalg.eigh(self.C)
        D_inv = 1.0 / np.sqrt(np.maximum(evals, 1e-20))
        c_inv_half = (B * D_inv[None, :]) @ B.T
        self.p_sigma = (1.0 - self.c_sigma) * self.p_sigma + math.sqrt(
            self.c_sigma * (2.0 - self.c_sigma) * mu_eff
        ) * (c_inv_half @ y_w)
        ps_norm = float(np.linalg.norm(self.p_sigma))
        h_sigma = float(
            ps_norm
            / math.sqrt(1.0 - (1.0 - self.c_sigma) ** (2 * self.generation))
            < (1.4 + 2.0 / (d + 1.0)) * self.chi_d
        )
        self.p_c = (1.0 - self.c_c) * self.p_c + h_sigma * math.sqrt(
            self.c_c * (2.0 - self.c_c) * mu_eff
        ) * y_w
        rank1 = np.outer(self.p_c, self.p_c)
        rank_mu = (y_sel.T * w[None, :]) @ y_sel
        delta_h = (1.0 - h_sigma) * self.c_c * (2.0 - self.c_c)
        self.C = (
            (1.0 - self.c_1 - self.c_mu) * self.C
            + self.c_1 * (rank1 + delta_h * self.C)
            + self.c_mu * rank_mu
        )
        self.C = (self.C + self.C.T) / 2.0  # keep symmetric under roundoff
        self.sigma *= math.exp(
            (self.c_sigma / self.d_sigma) * (ps_norm / self.chi_d - 1.0)
        )
        self.sigma = float(np.clip(self.sigma, 1e-8, 2.0))
        self.m = np.clip(m_new, 0.0, 1.0)

    @property
    def exhausted(self) -> bool:
        return (
            self.issued >= self.budget
            and not self._queue
            and not self._outstanding
        )


STRATEGIES = {
    "random": RandomSearch,
    "grid": GridSearch,
    "cmaes": CMAES,
}


def make_strategy(
    strategy, space: SearchSpace, budget: int, seed: int = 0, **kwargs
) -> Strategy:
    """Resolve a strategy name ("random" | "grid" | "cmaes") or pass an
    already-built Strategy through (it must wrap the same space)."""
    if isinstance(strategy, Strategy):
        if strategy.space is not space and strategy.space.names != space.names:
            raise ValueError(
                "the provided strategy wraps a different search space"
            )
        return strategy
    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown strategy {strategy!r}; choose from "
            f"{sorted(STRATEGIES)} or pass a Strategy instance"
        )
    return STRATEGIES[strategy](space, budget, seed=seed, **kwargs)
