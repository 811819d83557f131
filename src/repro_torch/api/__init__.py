"""Unified execution API: SimSpec (what to simulate) x ExecPlan (how to run).

    spec = api.make_spec(n=1024, hold_steps=100)           # pure physics, on "cuda"
    sim = api.compile_plan(spec, ensemble=64)              # resolved execution
    mT, states = sim.drive_batch(U)

Every impl-dispatch / padding / ensemble decision is made inside
`compile_plan`; `serve.reservoir.ReservoirEngine` serves from a CompiledSim,
drawn from the process-wide `PLAN_CACHE` (api/cache.py).
"""

from repro_torch.api.spec import (
    SimSpec,
    TOPOLOGIES,
    make_array_transient_spec,
    make_spec,
    make_time_multiplexed_spec,
    validate_topology,
)
from repro_torch.api.plan import (
    ExecPlan,
    FAMILY_IMPLS,
    PLAN_IMPLS,
    PLAN_PRECISIONS,
    check_plan_supports_topology,
)
from repro_torch.api.compiled import CompiledSim, compile_plan
from repro_torch.api.cache import (
    PLAN_CACHE,
    CacheStats,
    PlanCache,
    enable_persistent_cache,
    plan_cache_key,
    spec_structural_hash,
)

__all__ = [
    "SimSpec",
    "TOPOLOGIES",
    "make_spec",
    "make_time_multiplexed_spec",
    "make_array_transient_spec",
    "validate_topology",
    "ExecPlan",
    "FAMILY_IMPLS",
    "check_plan_supports_topology",
    "PLAN_IMPLS",
    "PLAN_PRECISIONS",
    "CompiledSim",
    "compile_plan",
    "PLAN_CACHE",
    "CacheStats",
    "PlanCache",
    "enable_persistent_cache",
    "plan_cache_key",
    "spec_structural_hash",
]
