"""Fleet serving tier: replicated reservoir engines behind one front door.

The layer ABOVE `ReservoirEngine`: replicas (`replica.py`) each wrap one
engine in-process or in a spawned worker process, the router
(`router.py`) places sessions onto per-N replica pools with sticky
affinity and bit-exact checkpoint migration, the asyncio front-end
(`frontend.py`) adds submit/push/drain verbs with planner-driven
admission control, and the capacity planner (`planner.py`) turns a
measured BENCH_serve.json grid into an analytical
`sessions_per_sec(N, E, ...)` model for sizing all of it.

Fault tolerance is layered onto the same pieces: replica supervision (RPC
deadlines, send retries, health states) detects failures, the router's
checkpoint-based failover (`FleetRouter(checkpoint_every=...)`) recovers
sessions bit-identically onto respawned replicas, the engine's nan guard
quarantines a divergent tenant's lane without touching co-tenants, and
`faults.py` injects deterministic crash/hang/delay/drop/NaN faults so
every one of those paths is tested.

On a card every replica's engine runs the CUDA kernels of its plan; a
process replica holds its own card context, and everything its pipe
carries is host data. Entry points take the engine's `device` ("cuda" by
default; `device="cpu"` runs the kernels' plain versions).

Rule of thumb: execution capabilities are ExecPlan fields; PLACEMENT —
which replica, which pool, how many — is fleet fields.
"""

from .faults import CRASH_EXIT_CODE, FAULT_KINDS, Fault, FaultPlan, FaultRuntime
from .frontend import AdmissionError, FleetFrontend, OverloadError
from .planner import (
    CapacityModel,
    FleetPlan,
    ReplicaSpec,
    WorkloadClass,
    measure_probe_rates,
    usable_cores,
)
from .replica import (
    HEALTH_DEAD,
    HEALTH_DEGRADED,
    HEALTH_HEALTHY,
    LocalReplica,
    ProcessReplica,
    ReplicaError,
    make_engine,
    start_fleet,
    validate_supervision,
)
from .router import FleetFaultStats, FleetRouter

__all__ = [
    "AdmissionError",
    "CRASH_EXIT_CODE",
    "CapacityModel",
    "FAULT_KINDS",
    "Fault",
    "FaultPlan",
    "FaultRuntime",
    "FleetFaultStats",
    "FleetFrontend",
    "FleetPlan",
    "FleetRouter",
    "HEALTH_DEAD",
    "HEALTH_DEGRADED",
    "HEALTH_HEALTHY",
    "LocalReplica",
    "OverloadError",
    "ProcessReplica",
    "ReplicaError",
    "ReplicaSpec",
    "WorkloadClass",
    "make_engine",
    "measure_probe_rates",
    "start_fleet",
    "usable_cores",
    "validate_supervision",
]
