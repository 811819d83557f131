"""repro_torch.tune: vectorized hyperparameter search on the serving engine.

The ensemble axis E of one CompiledSim is the search population: candidates
ride per-lane STOParams columns through the serving engine (the RK4 kernels
on the card), the online learner scores them as they stream, and strategies
(seeded random, grid, dependency-free CMA-ES) re-seed lanes at chunk
boundaries through the SlotStore admit/retire path. Batch entry point
`tune_spec`; serving entry point `ReservoirEngine.submit_autotuned`
(washout-window autotune, implemented by `washout_autotune`).

    from repro_torch.tune import SearchSpace, Float, narma_task, tune_spec
    space = SearchSpace({"drive_current": Float(1e-3, 4e-3),
                         "spectral_radius": Float(0.2, 1.2)})
    result = tune_spec(spec, narma_task(300), space, budget=32)  # on "cuda"
    print(result.best.assignment, result.best.fitness)
"""

from repro_torch.tune.space import ALIASES, Choice, Float, LogFloat, SearchSpace
from repro_torch.tune.strategies import (
    CMAES,
    STRATEGIES,
    GridSearch,
    RandomSearch,
    Strategy,
    make_strategy,
)
from repro_torch.tune.results import Trial, TuneResult
from repro_torch.tune.driver import (
    PENALTY_FITNESS,
    TuneTask,
    narma_task,
    tune_spec,
    washout_autotune,
)

__all__ = [
    "ALIASES",
    "Choice",
    "Float",
    "LogFloat",
    "SearchSpace",
    "Strategy",
    "RandomSearch",
    "GridSearch",
    "CMAES",
    "STRATEGIES",
    "make_strategy",
    "Trial",
    "TuneResult",
    "TuneTask",
    "narma_task",
    "tune_spec",
    "washout_autotune",
    "PENALTY_FITNESS",
]
