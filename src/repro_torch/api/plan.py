"""ExecPlan: HOW to execute a SimSpec — backend, padding, batching.

The fields are the reference's (api/plan.py), resolved exactly once, in
`repro_torch.api.compile_plan`:

  impl       "auto" consults the measured-latency dispatch table, then the
             platform gate / L2 heuristic (`kernels.ops.choose_impl`).
             Explicit values: "scan" (the core (E, N, 3) layout, any
             tableau: the exact oracle, eager torch ops on any device),
             "ref" (the plain PyTorch version), "fused" / "tiled" / "chunk"
             (the CUDA kernels; their plain versions for a CPU spec). The
             planes impls (ref/fused/tiled/chunk) integrate RK4 only.
  ensemble   E: how many reservoir lanes run per call (1 = solo).
  block_n/e  padding granules; multiples of the kernels' 64-row/64-lane tiles.
  n_inner    fused-kernel inner steps (None = one hold window per launch).
  precision  None / "highest": full f32 (TF32 off); "bf16_coupling": the
             coupling GEMM consumes bf16 operands and accumulates in f32;
             "mixed": also the input-field GEMM in bf16. The state carry and
             all elementwise math stay f32.
  chunk_ticks  K: how many input ticks one serving call covers.
  interpret  True runs the plain PyTorch versions of the kernels through the
             same dispatch and padding (the reference's interpret mode runs
             the Pallas kernels through the interpreter). An explicit request
             for checking, never a default.
  measure    time the impl candidates at compile time and pin the winner.
  learn      None, "rls" or "lms": `CompiledSim.tick_chunk` also trains
             per-lane readouts online (kernels/rls.py); learn_lam /
             learn_reg are RLS's forgetting factor and regularization
             (P0 = I / learn_reg), learn_mu the NLMS step size.
  aot        compile_plan also does, without launching, what the plan's
             first dispatch would do before its launch
             (`CompiledSim.aot_compile`: build or load the CUDA kernel
             library, resolve the launch configuration, set the kernels'
             shared-memory attributes). Nothing to do for scan / ref /
             interpret plans or on the CPU.
  compilation_cache_dir  build the CUDA kernel library into this directory
             and load it from there (`api.cache.enable_persistent_cache`),
             so a restarted process skips nvcc; the first directory wins
             for the process.

`aot` and `compilation_cache_dir` change when work happens, never what
runs: the plan cache's key leaves them out (api/cache.py). Not ported yet,
and refused with NotImplementedError when set: `mesh` and its axes
(sharded plans, ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

PLAN_IMPLS = ("auto", "scan", "ref", "fused", "tiled", "chunk")
PLAN_LEARN = (None, "rls", "lms")
PLAN_PRECISIONS = (None, "highest", "bf16_coupling", "mixed")

# Which impls can execute which physics family (SimSpec.topology), the
# reference's table. The coupled-array kernels (fused/tiled) take the N x N
# coupling product into every RK stage; the time-multiplexed delay line has
# no such stage product (its feedback is once per tick), so those impls
# cannot express it and compile_plan refuses the pairing ("auto" resolves
# around it). Neither family decomposes over a mesh's N axis: families are
# unsharded.
FAMILY_IMPLS = {
    "coupled_array": PLAN_IMPLS,
    "time_multiplexed": ("auto", "scan", "ref", "chunk"),
    "array_transient": ("auto", "scan", "ref", "fused", "tiled", "chunk"),
}


def check_plan_supports_topology(plan: "ExecPlan", topology: str) -> None:
    """Refuse plan/physics-family pairings that have no executable mapping
    (called by compile_plan after the spec's own validation)."""
    allowed = FAMILY_IMPLS.get(topology)
    if allowed is None:
        raise ValueError(f"unknown topology {topology!r}; expected one of {tuple(FAMILY_IMPLS)}")
    if topology == "coupled_array":
        return
    if plan.mesh is not None:
        raise ValueError(
            f"mesh plans shard the coupled array; topology {topology!r} is "
            "unsharded — scale it across ensemble lanes or engine replicas"
        )
    if plan.impl not in allowed:
        raise ValueError(
            f"impl {plan.impl!r} cannot execute topology {topology!r}; supported impls: {allowed}"
        )


def _is_dtype(d) -> bool:
    if isinstance(d, torch.dtype):
        return True
    try:
        np.dtype(d)
    except TypeError:
        return False
    return True


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    impl: str = "auto"
    ensemble: int = 1
    block_n: Optional[int] = None  # None = the kernels' tile
    block_e: Optional[int] = None
    n_inner: Optional[int] = None  # None = full hold window per kernel launch
    mesh: Optional[object] = None
    ensemble_axes: Sequence[str] = ("data",)
    model_axis: Optional[str] = "model"
    gather_dtype: Optional[object] = None
    precision: Optional[str] = None  # None/"highest" = full f32
    chunk_ticks: int = 1
    learn: Optional[str] = None
    learn_lam: float = 1.0
    learn_reg: float = 1e-6
    learn_mu: float = 0.5
    interpret: bool = False
    measure: bool = False
    aot: bool = False
    compilation_cache_dir: Optional[str] = None

    def __post_init__(self):
        if self.impl not in PLAN_IMPLS:
            raise ValueError(f"impl must be one of {PLAN_IMPLS}; got {self.impl!r}")
        if self.ensemble < 1:
            raise ValueError(f"ensemble must be >= 1; got {self.ensemble}")
        if self.mesh is not None and self.impl not in ("auto", "scan"):
            raise ValueError(
                "sharded plans integrate in the core layout; impl must be "
                f"'auto' or 'scan' when mesh is set, got {self.impl!r}"
            )
        if isinstance(self.chunk_ticks, bool) or not isinstance(self.chunk_ticks, int):
            raise ValueError(f"chunk_ticks must be an int >= 1; got {self.chunk_ticks!r}")
        if self.chunk_ticks < 1:
            raise ValueError(f"chunk_ticks must be >= 1; got {self.chunk_ticks}")
        if self.gather_dtype is not None and not _is_dtype(self.gather_dtype):
            raise ValueError(
                f"gather_dtype must be a dtype (e.g. torch.bfloat16) or None; "
                f"got {self.gather_dtype!r}"
            )
        if self.precision not in PLAN_PRECISIONS:
            raise ValueError(
                f"precision must be one of {PLAN_PRECISIONS}; got {self.precision!r}"
            )
        if self.reduced_precision and self.impl == "scan" and self.mesh is None:
            raise ValueError(
                "impl='scan' is the bit-exact oracle; reduced precision "
                f"({self.precision!r}) applies to the planes impls "
                "(ref/fused/tiled/chunk) — use impl='auto' or an explicit planes impl"
            )
        if self.learn not in PLAN_LEARN:
            raise ValueError(f"learn must be one of {PLAN_LEARN}; got {self.learn!r}")
        if not isinstance(self.learn_lam, (int, float)) or isinstance(
            self.learn_lam, bool
        ) or not (0.0 < float(self.learn_lam) <= 1.0):
            raise ValueError(
                f"learn_lam (RLS forgetting factor) must be a float in (0, 1]; "
                f"got {self.learn_lam!r}"
            )
        if not isinstance(self.learn_reg, (int, float)) or isinstance(
            self.learn_reg, bool
        ) or not float(self.learn_reg) > 0.0:
            raise ValueError(
                f"learn_reg (RLS regularization; P0 = I / learn_reg) must be > 0; "
                f"got {self.learn_reg!r}"
            )
        if not isinstance(self.learn_mu, (int, float)) or isinstance(
            self.learn_mu, bool
        ) or not (0.0 < float(self.learn_mu) < 2.0):
            raise ValueError(
                f"learn_mu (NLMS step size) must be a float in (0, 2); got {self.learn_mu!r}"
            )
        if self.compilation_cache_dir is not None and not isinstance(
            self.compilation_cache_dir, str
        ):
            raise ValueError(
                "compilation_cache_dir must be a directory path string or "
                f"None; got {self.compilation_cache_dir!r}"
            )
        for granule in ("block_n", "block_e"):
            v = getattr(self, granule)
            if v is not None and (isinstance(v, bool) or not isinstance(v, int) or v % 64):
                raise ValueError(
                    f"{granule} must be a multiple of the kernels' 64-wide tile; got {v!r}"
                )
        if self.mesh is not None:
            raise NotImplementedError(
                "ExecPlan.mesh is not ported yet (ROADMAP queue 1 item 12, sharded plans)"
            )

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def effective_precision(self) -> Optional[str]:
        """The precision policy with the full-f32 aliases collapsed to None."""
        return None if self.precision == "highest" else self.precision

    @property
    def reduced_precision(self) -> bool:
        return self.effective_precision is not None

    @property
    def effective_gather_dtype(self):
        """The sharded coupling path's wire dtype after precision resolution
        (the reference's): an explicit gather_dtype wins, else reduced
        precision gathers in bf16. The plan cache keys on it."""
        if self.gather_dtype is not None:
            return self.gather_dtype
        return torch.bfloat16 if self.reduced_precision else None
