"""Trial records and ranked tune results.

Everything here is host-side plain data (floats, dicts, numpy genotypes)
so a TuneResult serializes/compares across runs: fixed-seed tune runs
produce identical trial histories (pinned by tests/test_torch_tune.py),
which is what makes hyperparameter search results reviewable artifacts
instead of one-off printouts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Trial:
    """One evaluated candidate.

    fitness is MINIMIZED (the online learn_nmse by default; whatever the
    task's score callback returns otherwise). Non-finite fitness marks a
    failed/diverged candidate — ranked last, and reported to the strategy
    as a large penalty so CMA-ES steers away instead of crashing.
    """

    trial_id: int
    assignment: Dict[str, object]  # knob name -> concrete value
    fitness: float
    genotype: np.ndarray  # the [0, 1]^d point that decoded to `assignment`
    engine_key: str  # which structural engine group evaluated it
    ticks: int  # input ticks the evaluation consumed

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.fitness))

    def to_dict(self) -> dict:
        return {
            "trial_id": self.trial_id,
            "assignment": {
                k: (v.item() if isinstance(v, np.generic) else v)
                for k, v in self.assignment.items()
            },
            "fitness": float(self.fitness),
            "genotype": [float(g) for g in self.genotype],
            "engine_key": self.engine_key,
            "ticks": self.ticks,
        }


@dataclasses.dataclass
class TuneResult:
    """A finished search: every trial in evaluation order, plus provenance.

    `ranked()` sorts best-first (finite fitness ascending, failures last);
    `best` is ranked()[0]. trials keep SUBMISSION order — the fixed-seed
    determinism contract is over this list, ids and fitnesses included.
    """

    trials: List[Trial]
    strategy: str
    space_names: tuple
    budget: int
    seed: int
    wall_s: float  # wall-clock of the whole search
    sequential: bool = False  # True when evaluated one candidate at a time

    def ranked(self) -> List[Trial]:
        return sorted(
            self.trials,
            key=lambda t: (not t.ok, t.fitness if t.ok else 0.0, t.trial_id),
        )

    @property
    def best(self) -> Trial:
        if not self.trials:
            raise ValueError("no trials were evaluated")
        return self.ranked()[0]

    def to_dict(self) -> dict:
        return {
            "strategy": self.strategy,
            "space": list(self.space_names),
            "budget": self.budget,
            "seed": self.seed,
            "wall_s": self.wall_s,
            "sequential": self.sequential,
            "trials": [t.to_dict() for t in self.trials],
            "best": self.best.to_dict() if self.trials else None,
        }
