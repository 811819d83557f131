"""Unified execution API: SimSpec (what to simulate) x ExecPlan (how to run).

    spec = api.make_spec(n=1024, hold_steps=100)           # pure physics, on "cuda"
    sim = api.compile_plan(spec, ensemble=64)              # resolved execution
    mT, states = sim.drive_batch(U)

Every impl-dispatch / padding / ensemble decision is made inside
`compile_plan`; `serve.reservoir.ReservoirEngine` serves from a CompiledSim.
"""

from repro_torch.api.spec import SimSpec, TOPOLOGIES, make_spec, validate_topology
from repro_torch.api.plan import ExecPlan, PLAN_IMPLS, PLAN_PRECISIONS
from repro_torch.api.compiled import CompiledSim, compile_plan

__all__ = [
    "SimSpec",
    "TOPOLOGIES",
    "make_spec",
    "validate_topology",
    "ExecPlan",
    "PLAN_IMPLS",
    "PLAN_PRECISIONS",
    "CompiledSim",
    "compile_plan",
]
