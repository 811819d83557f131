"""Multi-tenant streaming reservoir inference engine.

Concurrent client streams map onto slots of the ensemble axis E, so ONE
batched integrate advances every active session per input tick. Admitting a
session splices its magnetization state m (N, 3) and per-tenant STOParams
lane into the batched (3, N, E) planes (serve/state_store.py); finished
sessions free their slot without stalling the batch (serve/scheduler.py).
Each session carries its own trained Readout and input stream; readout
application is itself slot-batched.

The engine holds a CompiledSim and its hot path is `CompiledSim.tick_chunk`
over `ExecPlan.chunk_ticks` input ticks. `run()` is a double-buffered
pipeline: while the card executes chunk C+1, the host harvests chunk C and
assembles chunk C+2's input block, applying admissions and retirements to
the slot store at chunk boundaries. On CUDA, each launched chunk enqueues
non-blocking copies of its states/outputs blocks (and of the boundary's
retired final states) into pinned host buffers and records an event; the
harvest waits on that event only, so it never waits for the chunk launched
after it. (A plain `.cpu()` on the same stream would wait for that chunk
too and serialise the double buffer.)

`step()` keeps the synchronous per-tick path (one `CompiledSim.tick` and one
harvest per input tick) for externally clocked callers and as the pipelined
path's baseline; on the scan impl both give the same bits.

Online learning: an engine built with learn="rls" | "lms" trains the
readout of every session that submits `targets` inside `tick_chunk`, after
the chunk's integrate (kernels/rls.py). The learn columns (P, W) stay on the
device; a-priori predictions come back with the chunk's other blocks, and a
retiring lane's learned W with its final state.

Lifecycle: `open=True` makes a push stream that idles (lane frozen) when its
input runs dry until `append_ticks` feeds it or `close_session` lets it
finish. `checkpoint_session` / `snapshot_sessions` freeze live sessions into
host-side `SessionCheckpoint`s (with a learner's P and W) that
`restore_session` resumes on any engine of the same spec. Under
`autoscale=` the engine grows and shrinks its slot count at chunk
boundaries between power-of-two buckets, moving the occupied columns
(serve/state_store.py `SlotStore.resized`) onto a CompiledSim per bucket.

Compiles are shared: the template route and every bucket draw from the
process-wide `repro_torch.api.PLAN_CACHE`, so engines over the same spec
and plan use one CompiledSim. With `prewarm=True` (the default) an
autoscaling engine warms the buckets adjacent to its width in a daemon
thread (`prewarm_buckets`), so a rescale at a chunk boundary finds its
bucket's first dispatch already paid.

Mixed-spec tenancy: a session may carry its own SimSpec. The engine routes
it by structural hash: the template's hash serves it in a primary lane (the
spec's scalar params become the lane's values); another hash (another
physics family, other shapes) lands on an internal sub-engine compiled for
that spec through PLAN_CACHE, one per hash, which `step_chunk` advances in
lockstep and whose results surface in this engine's `results`.

Autotune: `submit_autotuned` tunes a learning tenant's lane knobs on the
live engine during its washout window (`repro_torch.tune.washout_autotune`)
before it submits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.api import (
    FAMILY_IMPLS,
    PLAN_CACHE,
    CompiledSim,
    ExecPlan,
    SimSpec,
    spec_structural_hash,
)
from repro_torch.api.cache import _params_equal
from repro_torch.core.constants import STOParams
from repro_torch.core.reservoir import Readout, coerce_input_series
from repro_torch.distributed.sharding import axis_size
from repro_torch.serve.scheduler import AutoscalePolicy, QueueDepthPolicy, SlotScheduler
from repro_torch.serve.state_store import SlotStore, _host

BACKENDS = ("auto", "scan", "ref", "fused", "tiled", "chunk")


@dataclasses.dataclass
class StreamSession:
    """One tenant's streaming request.

    u_seq follows the explicit (T, N_in) contract ((T,) for n_in == 1).
    params overrides the engine template's physical parameters for this
    tenant's lane; readout is the tenant's trained linear readout (None =
    state collection only); m0 resumes from a previous session's final
    state.

    `targets` (T, n_out) (or (T,)) makes the session a LEARNER on a learning
    engine: its lane's readout trains online, one update per tick inside the
    chunk. `learn_washout` skips the update for the first ticks (the
    a-priori predictions are still recorded). A `readout` warm-starts the
    learned weights (and still drives `outputs`); `learn_w0` / `learn_P0`
    resume a recursion mid-stream (weights, and RLS's inverse-Gram) and take
    priority. The trained readout, the per-tick predictions and the online
    NMSE come back on the SessionResult.

    `open=True` marks a PUSH stream: the session stays resident after its
    input is exhausted (its lane idles, state frozen) until
    `engine.append_ticks(sid, ...)` supplies more rows or
    `engine.close_session(sid)` lets it finish.

    `spec` (mixed-spec tenancy): a session that carries its own SimSpec is
    routed by structural hash. The template's hash means the template's
    physics: the session rides a primary lane, the spec's scalar params
    becoming its lane values unless `params` is set (explicit wins). Another
    hash (another topology family, other N / dt / hold_steps / w_cp ...)
    lands on an internal sub-engine compiled for that spec. None: the
    engine's template spec.
    """

    sid: int
    u_seq: np.ndarray
    params: Optional[STOParams] = None
    readout: Optional[Readout] = None
    m0: Optional[object] = None
    collect_states: bool = True
    targets: Optional[np.ndarray] = None  # (T, n_out) online-learning targets
    learn_washout: int = 0  # ticks before the first update
    open: bool = False
    learn_w0: Optional[np.ndarray] = None  # (N+1, n_out) learned-weight resume
    learn_P0: Optional[np.ndarray] = None  # (N+1, N+1) inverse-Gram resume
    spec: Optional[SimSpec] = None

    # engine-internal bookkeeping (set on admit)
    _slot: int = dataclasses.field(default=-1, repr=False)
    _t: int = dataclasses.field(default=0, repr=False)
    _states: list = dataclasses.field(default_factory=list, repr=False)
    _outs: list = dataclasses.field(default_factory=list, repr=False)
    _preds: list = dataclasses.field(default_factory=list, repr=False)
    _admitted_tick: int = dataclasses.field(default=-1, repr=False)
    _finished_tick: int = dataclasses.field(default=-1, repr=False)
    _n_out: int = dataclasses.field(default=1, repr=False)
    # set by restore_session: admission keeps the seeded _t and prefix
    _restored: bool = dataclasses.field(default=False, repr=False)
    # set by the nan guard when this tenant's lane went non-finite
    _error: Optional[str] = dataclasses.field(default=None, repr=False)


@dataclasses.dataclass
class SessionResult:
    sid: int
    states: Optional[np.ndarray]  # (T, N) streamed node states
    outputs: Optional[np.ndarray]  # (T - washout, n_out) readout outputs
    final_m: np.ndarray  # (N, 3)
    admitted_tick: int
    finished_tick: int
    slot: int
    # online learning (sessions submitted with targets on a learning engine)
    predictions: Optional[np.ndarray] = None  # (T, n_out) a-priori per tick
    learned_readout: Optional[Readout] = None  # final trained W (washout=0)
    learn_nmse: Optional[float] = None  # online NMSE after learn_washout
    # set when the nan guard quarantined this tenant's lane; the arrays then
    # hold the clean prefix before the offending chunk
    error: Optional[str] = None


@dataclasses.dataclass
class SessionCheckpoint:
    """A mid-stream session frozen for migration between engines.

    Every field is a host numpy array or a plain scalar (params: 0-d CPU
    tensors), so a checkpoint pickles unchanged. `u_seq` / `targets` carry
    the FULL stream (targets at the session's own width q, not the store's
    padded width); `t` marks how far the source engine got; `states` /
    `outs` / `preds` are the prefix already harvested. `m` is the
    magnetization at tick t, and `P` / `Wl` the learner in flight (P None
    for LMS; both None for inference sessions). `restore_session` injects
    them into the destination's slot columns, so the resumed stream is
    bit-identical to one that never moved wherever the destination computes
    the session's lane with the same arithmetic."""

    sid: int
    u_seq: np.ndarray  # (T, N_in) full input stream
    t: int  # ticks already served by the source engine
    m: Optional[np.ndarray]  # (N, 3) at tick t (None: queued, never ran)
    params: Optional[STOParams]
    readout_w: Optional[np.ndarray]  # (N+1, q) static readout, unpadded
    readout_washout: int
    collect_states: bool
    targets: Optional[np.ndarray]  # (T, q) full targets, unpadded
    learn_washout: int
    open: bool
    n_out: int  # the session's own output width q
    states: Optional[np.ndarray]  # (t, N) harvested prefix
    outs: Optional[np.ndarray]  # (t, q) harvested prefix
    preds: Optional[np.ndarray]  # (t, q) harvested prefix
    P: Optional[np.ndarray]  # (S, S) in-flight RLS inverse-Gram
    Wl: Optional[np.ndarray]  # (S, q) in-flight learned weights, unpadded
    # a mixed-spec tenant's own SimSpec, its tensors on the CPU (so the
    # checkpoint pickles); restore_session re-routes from it
    spec: Optional[SimSpec] = None


@dataclasses.dataclass
class EngineStats:
    """One engine's load/latency snapshot — plain scalars only, so it
    pickles across the fleet's replica transport. The fleet router compares
    these live measurements against the capacity planner's predictions."""

    n: int
    num_slots: int
    active: int
    queued: int
    backend: str
    precision: Optional[str]
    learn: Optional[str]
    chunk_ticks: int
    ticks: int
    session_ticks: int
    occupancy: float
    queue_depth: int
    mean_queue_wait: float
    grows: int
    shrinks: int
    detached: int
    # rescale compiles (SchedulerStats): cold = the bucket compiled at the
    # boundary, stalling rescale_stall_s seconds in total
    cold_rescales: int
    warm_rescales: int
    rescale_stall_s: float
    chunk_median_s: Optional[float]  # median wall time of recent chunks
    chunks_timed: int
    ticks_per_sec: Optional[float]  # E * K / chunk_median_s
    # mixed-spec tenancy: internal sub-engines serving sessions whose spec
    # hash differs from the template's
    sub_engines: int = 0
    # lanes the nan guard quarantined, sub-engines included
    quarantined_lanes: int = 0
    # the owning fleet replica's health (healthy | degraded | dead), stamped
    # by the replica transport; "healthy" for a bare engine
    health: str = "healthy"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _HostCopy:
    """Device tensors copied to host. On CUDA the copies go into pinned
    buffers without blocking and an event marks their completion; `numpy()`
    waits on that event only."""

    def __init__(self, tensors: List[Optional[torch.Tensor]]):
        self.event = None
        self.host = []
        for t in tensors:
            if t is None or t.device.type == "cpu":
                self.host.append(t)
                continue
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            self.host.append(buf)
            if self.event is None:
                self.event = torch.cuda.Event()
        if self.event is not None:
            self.event.record()

    def numpy(self) -> List[Optional[np.ndarray]]:
        if self.event is not None:
            self.event.synchronize()
        return [None if t is None else t.numpy() for t in self.host]


@dataclasses.dataclass
class _ChunkPlan:
    """One launched chunk's host-side record: who occupied which slot for
    how many of the K ticks, plus the pending host copies to harvest."""

    # (session, slot, n_ticks served in rows [0, n_ticks) of the chunk)
    entries: List[Tuple[StreamSession, int, int]]
    u: np.ndarray  # (K, E, N_in) assembled input block
    mask: np.ndarray  # (K, E) per-tick lane activity
    any_readout: bool
    # learning engines: (K, E, n_out) targets, (K, E) per-tick learn mask,
    # and whether any learner was served (its predictions come back)
    targets: Optional[np.ndarray] = None
    lmask: Optional[np.ndarray] = None
    any_learn: bool = False
    # (states (K, N, E), outs (K, E, n_out), preds (K, E, n_out))
    copies: Optional[_HostCopy] = None


def _with_bias(states):
    """(..., N, E) states -> (..., N+1, E), the last row ones."""
    ones = torch.ones(
        (*states.shape[:-2], 1, states.shape[-1]), dtype=states.dtype, device=states.device
    )
    return torch.cat([states, ones], dim=-2)


def _apply_readouts(xb, w_out):
    """Slot-batched readout of one tick: (N+1, E) states with their bias row
    x (E, N+1, n_out) -> (E, n_out)."""
    return torch.einsum("ne,eno->eo", xb, w_out)


def _apply_readouts_chunk(states_block, w_out):
    """Chunked readout: (K, N, E) x (E, N+1, n_out) -> (K, E, n_out).

    K calls of the per-tick `_apply_readouts`, stacked: one batched einsum
    over K ("kne,eno->keo") hands the GEMM another shape, which may sum in
    another order, and the chunked path must give the per-tick path's bits
    (`step()`)."""
    xb = _with_bias(states_block)
    return torch.stack([_apply_readouts(xb[t], w_out) for t in range(xb.shape[0])])


def _spec_host(spec: Optional[SimSpec]) -> Optional[SimSpec]:
    """A session's SimSpec with every tensor on the CPU, for a checkpoint
    (it pickles without a card). It hashes as the original, so a restore
    routes to the same sub-engine."""
    return None if spec is None else spec.to("cpu")


def _bucket_slots(demand: int, min_slots: int, max_slots: int) -> int:
    """Smallest bucket covering demand: min_slots * 2^k, clamped to
    max_slots. Power-of-two widths keep the engine's compiled buckets few
    (log2 of the range)."""
    b = min_slots
    while b < demand and b < max_slots:
        b *= 2
    return min(b, max_slots)


def _ensemble_axis_size(plan: ExecPlan) -> int:
    """Ranks the ensemble axis spans on a sharded plan (1 if unsharded)."""
    if plan.mesh is None:
        return 1
    return axis_size(plan.mesh, tuple(plan.ensemble_axes))


def _bucket_ladder(min_slots: int, max_slots: int) -> List[int]:
    """Every width `_bucket_slots` can return: min_slots * 2^k while below
    max_slots, plus the clamp bucket max_slots itself (which need not be a
    power-of-two multiple)."""
    ladder = []
    b = min_slots
    while b < max_slots:
        ladder.append(b)
        b *= 2
    ladder.append(max_slots)
    return ladder


class ReservoirEngine:
    """Serve many concurrent reservoir streams from one batched simulator.

    Construct either from a SimSpec plus num_slots (the ensemble capacity E),
    in which case the engine compiles an ExecPlan on `device` ("cuda" by
    default); or from an already-compiled CompiledSim (num_slots defaults to
    the plan's ensemble width).

    Serving knobs:
      backend       auto | scan | ref | fused | tiled | chunk (ExecPlan.impl)
      chunk_ticks   K ticks per call — `run()` pipelines K-tick chunks
      interpret     run the plain PyTorch versions of the kernels (checking)
      precision     None/"highest" full f32, "bf16_coupling"/"mixed" reduced
      learn         "rls" | "lms": train the readouts of sessions that submit
                    targets; learn_lam / learn_reg are RLS's forgetting
                    factor and regularization, learn_mu the NLMS step size
                    (repro_torch.api.plan.ExecPlan)
      max_retained  cap on finished SessionResults kept in `results`
      nan_guard     quarantine a tenant whose harvested rows went non-finite
      autoscale     an AutoscalePolicy (or True for QueueDepthPolicy()): grow
                    or shrink the slot count between min_slots and max_slots
                    at chunk boundaries, over power-of-two buckets from
                    min_slots, each drawn once from PLAN_CACHE and kept
      compilation_cache_dir  (template route) build the CUDA kernel
                    library into this directory and load it from there, so
                    a restarted server skips nvcc (ExecPlan field of the
                    same name)
      prewarm       autoscaling engines warm the buckets adjacent to their
                    width in a daemon thread, at construction and after
                    every rescale (`prewarm_buckets`), on the stream the
                    engine serves on (one masked chunk each; a sharded
                    plan's in the calling thread); prewarm=False
                    leaves each bucket's compile and launch-free warm
                    (aot) to its rescale. A failed prewarm
                    is not fatal (the rescale compiles on demand) and is
                    recorded in `prewarm_errors`.

    The template route draws its CompiledSim from the process-wide
    PLAN_CACHE, so engines built from the same spec, plan and device share
    one.
    """

    def __init__(
        self,
        res: Union[SimSpec, CompiledSim],
        num_slots: Optional[int] = None,
        backend: str = "auto",
        n_out: int = 1,
        measure: bool = False,
        interpret: bool = False,
        chunk_ticks: Optional[int] = None,
        max_retained: Optional[int] = None,
        precision: Optional[str] = None,
        nan_guard: bool = True,
        device="cuda",
        learn: Optional[str] = None,
        learn_lam: Optional[float] = None,
        learn_reg: Optional[float] = None,
        learn_mu: Optional[float] = None,
        autoscale: Union[AutoscalePolicy, bool, None] = None,
        min_slots: Optional[int] = None,
        max_slots: Optional[int] = None,
        compilation_cache_dir: Optional[str] = None,
        prewarm: bool = True,
    ):
        if isinstance(res, CompiledSim):
            sim = res
            if num_slots is not None and num_slots != sim.plan.ensemble:
                raise ValueError(
                    f"num_slots ({num_slots}) must match the compiled plan's "
                    f"ensemble width ({sim.plan.ensemble}); omit num_slots to use the plan's"
                )
            if (
                backend != "auto"
                or measure
                or interpret
                or chunk_ticks is not None
                or precision is not None
                or learn is not None
                or learn_lam is not None
                or learn_reg is not None
                or learn_mu is not None
                or compilation_cache_dir is not None
            ):
                raise ValueError(
                    "backend/measure/interpret/chunk_ticks/precision/learn*/"
                    "compilation_cache_dir are ExecPlan decisions; when "
                    "constructing from a CompiledSim, set them on the plan "
                    "passed to compile_plan instead"
                )
            num_slots = sim.plan.ensemble
            spec_hash = spec_structural_hash(sim.spec)
        else:
            if num_slots is None:
                raise TypeError("num_slots is required when constructing from a SimSpec")
            if backend not in BACKENDS:
                raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
            spec_hash = spec_structural_hash(res)
            sim = PLAN_CACHE.get_or_compile(
                res,
                ExecPlan(
                    impl=backend,
                    ensemble=num_slots,
                    interpret=interpret,
                    measure=measure,
                    chunk_ticks=1 if chunk_ticks is None else chunk_ticks,
                    precision=precision,
                    learn=learn,
                    learn_lam=1.0 if learn_lam is None else learn_lam,
                    learn_reg=1e-6 if learn_reg is None else learn_reg,
                    learn_mu=0.5 if learn_mu is None else learn_mu,
                    compilation_cache_dir=compilation_cache_dir,
                ),
                device=device,
                spec_hash=spec_hash,
            )
        # -- autoscale: one CompiledSim per bucket width (checked before the
        # slot store, which needs scalar-leaved spec params) -----------------
        if autoscale is True:
            autoscale = QueueDepthPolicy()
        self.autoscale: Optional[AutoscalePolicy] = autoscale or None
        self.min_slots = num_slots if min_slots is None else min_slots
        self.max_slots = num_slots if max_slots is None else max_slots
        if self.autoscale is not None:
            if not (1 <= self.min_slots <= num_slots <= self.max_slots):
                raise ValueError(
                    f"autoscale bounds must satisfy 1 <= min_slots <= "
                    f"num_slots <= max_slots; got min={self.min_slots} "
                    f"num={num_slots} max={self.max_slots}"
                )
            if sim.plan.sharded:
                # every reachable bucket width must divide over the mesh's
                # ensemble axes, or a rescale would strand lanes on a
                # decomposition the sharded body cannot express
                axis = _ensemble_axis_size(sim.plan)
                widths = [num_slots] + _bucket_ladder(self.min_slots, self.max_slots)
                bad = sorted({w for w in widths if w % axis})
                if bad:
                    raise ValueError(
                        "autoscale on a sharded plan requires every bucket "
                        "width to be divisible by the ensemble-axis size "
                        f"{axis} (mesh axes {tuple(sim.plan.ensemble_axes)}); "
                        f"min_slots={self.min_slots} / max_slots="
                        f"{self.max_slots} reach incompatible widths {bad}"
                    )
            if sim.spec.params.gamma.ndim != 0:
                raise ValueError(
                    "autoscale requires scalar-leaved spec params (per-tenant "
                    "params ride in session lanes, not the spec)"
                )
        self.sim = sim
        self.res = sim.spec
        # the template's structural hash, computed once: every rescale's and
        # prewarm's PLAN_CACHE lookup passes it (mixed-spec routing keys on it)
        self._spec_hash = spec_hash
        self.device = sim.device
        self.chunk_ticks = sim.plan.chunk_ticks
        self.learn = sim.plan.learn
        self.store = SlotStore(
            sim.spec, num_slots, n_out=n_out, learn=self.learn, learn_reg=sim.plan.learn_reg
        )
        self.scheduler = SlotScheduler(num_slots)
        self.tick_count = 0
        self.results: Dict[int, SessionResult] = {}
        self.max_retained = max_retained
        self.backend = sim.impl
        self.precision = sim.precision
        self.nan_guard = bool(nan_guard)
        # the compiled bucket widths; a rescale to a width found here is warm
        self._sims: Dict[int, CompiledSim] = {num_slots: sim}

        # sessions whose final tick was served by the most recently LAUNCHED
        # chunk (slot still holds their state until the next boundary)
        self._finishing: List[Tuple[int, StreamSession]] = []
        # one boundary's retired sessions awaiting their final states' copy
        self._awaiting: Optional[Tuple[List[Tuple[int, StreamSession]], _HostCopy]] = None
        # device copy of the last chunk's lane-mask block; steady-state
        # chunks repeat the same mask, so skip the re-upload
        self._mask_np: Optional[np.ndarray] = None
        self._mask_dev: Optional[torch.Tensor] = None
        # the same for the learn mask, constant once every learner is past
        # its washout
        self._lmask_np: Optional[np.ndarray] = None
        self._lmask_dev: Optional[torch.Tensor] = None
        self._quarantine: List[Tuple[int, StreamSession]] = []
        # the launched-but-unharvested chunk (the pipeline's second buffer)
        self._pending: Optional[_ChunkPlan] = None
        self._chunk_times: deque = deque(maxlen=128)
        # background warm-up of the adjacent autoscale buckets; a failure is
        # recorded (width, error), never raised: the rescale compiles on demand
        self._prewarm_enabled = bool(prewarm)
        self._prewarm_thread: Optional[threading.Thread] = None
        self.prewarm_errors: List[Tuple[int, str]] = []
        if self._prewarm_enabled and self.autoscale is not None:
            self.prewarm_buckets()
        # mixed-spec tenancy: one sub-engine per foreign structural hash
        self._subengines: Dict[str, "ReservoirEngine"] = {}

    @property
    def num_slots(self) -> int:
        return self.store.num_slots

    # -- mixed-spec tenancy ------------------------------------------------------

    def _route_spec(self, session: StreamSession) -> Optional["ReservoirEngine"]:
        """The engine that serves a spec-carrying session: None for this one
        (the spec's structural hash is the template's, which leaves scalar
        param values out: they ride the session's lane), else the sub-engine
        of its hash, built on first use."""
        spec = session.spec
        if spec.params.gamma.ndim != 0:
            raise ValueError(
                f"session {session.sid}: a session spec must carry "
                f"scalar-leaved params (per-lane values are the lane's job; "
                f"ensemble-leaved sweeps belong on the engine template)"
            )
        h = spec_structural_hash(spec)
        if h == self._spec_hash:
            # the template's physics in a primary lane: the spec's scalar
            # params become the lane's unless the session pinned its own
            if session.params is None and not _params_equal(spec.params, self.res.params):
                session.params = spec.params
            return None
        sub = self._subengines.get(h)
        if sub is None:
            sub = self._subengines[h] = self._make_subengine(spec, h)
        return sub

    def _make_subengine(self, spec: SimSpec, spec_hash: str) -> "ReservoirEngine":
        """A sub-engine for a structurally different spec: the template's
        plan at this engine's min_slots width, drawn through PLAN_CACHE (two
        engines serving the same foreign spec share its CompiledSim). An impl
        the spec's family cannot run (a fused or tiled template serving a
        time_multiplexed tenant) becomes "auto", which compile_plan resolves
        to one it can; so does a chunk template serving an array_transient
        tenant, whose "chunk" is the eager plain body, not a kernel. Sharded
        templates refuse: families do not shard, and serving a tenant
        unsharded on a mesh engine would misstate its placement."""
        plan = self.sim.plan
        if plan.mesh is not None:
            raise ValueError(
                "mixed-spec tenancy is not supported on sharded engines — "
                "a sub-engine cannot inherit the mesh decomposition; serve "
                f"the {spec.topology!r} spec from an unsharded engine"
            )
        impl = plan.impl
        if impl not in FAMILY_IMPLS[spec.topology] or (
            spec.topology == "array_transient" and impl == "chunk"
        ):
            impl = "auto"
        sim = PLAN_CACHE.get_or_compile(
            spec, dataclasses.replace(plan, ensemble=self.min_slots, impl=impl),
            device=self.device, spec_hash=spec_hash,
        )
        return ReservoirEngine(
            sim, n_out=self.store.n_out, max_retained=self.max_retained,
            nan_guard=self.nan_guard, prewarm=False,
        )

    # -- session lifecycle -------------------------------------------------

    def submit(self, session: StreamSession) -> None:
        if session.spec is not None:
            sub = self._route_spec(session)
            if sub is not None:
                sub._enqueue(session)
                return
        self._enqueue(session)

    def _enqueue(self, session: StreamSession) -> None:
        """Validate a session routed to this engine and queue it."""
        # the engine assembles u blocks host-side, so the series stays numpy
        store = self.store
        u = coerce_input_series(session.u_seq, store.n_in, store.np_dtype, xp=np)
        if u.shape[0] == 0 and not session.open:
            raise ValueError(f"session {session.sid}: empty input stream")
        session.u_seq = u
        n_out = None  # the session's own width, inferred below
        if session.readout is not None:
            w = session.readout.w_out
            if w.ndim != 2 or w.shape[0] != store.n + 1 or not (1 <= w.shape[1] <= store.n_out):
                raise ValueError(
                    f"session {session.sid}: readout w_out shape "
                    f"{tuple(w.shape)} must be ({store.n + 1}, q) with "
                    f"1 <= q <= {store.n_out} (the engine's n_out)"
                )
            n_out = w.shape[1]
        if session.targets is not None:
            if self.learn is None:
                raise ValueError(
                    f"session {session.sid}: targets require a learning "
                    f"engine — compile the plan with ExecPlan(learn='rls') "
                    f"or learn='lms' (or pass learn=... to ReservoirEngine)"
                )
            t = _host(session.targets).astype(store.np_dtype)
            if t.ndim == 1:
                t = t[:, None]
            if t.ndim != 2 or t.shape[0] != u.shape[0] or not (1 <= t.shape[1] <= store.n_out):
                raise ValueError(
                    f"session {session.sid}: targets must have shape "
                    f"({u.shape[0]}, q) — one row per input row, "
                    f"1 <= q <= {store.n_out} — or ({u.shape[0]},) for "
                    f"q == 1; got {tuple(np.shape(session.targets))}"
                )
            if n_out is not None and t.shape[1] != n_out:
                raise ValueError(
                    f"session {session.sid}: targets carry {t.shape[1]} "
                    f"output columns but the readout carries {n_out}; a "
                    f"session has ONE output width"
                )
            n_out = t.shape[1]
            # store-width targets: chunk assembly copies rows straight into
            # the (K, E, n_out) block; results slice back to q columns
            session.targets = self._pad_cols(t, "targets", session.sid)
            if (
                isinstance(session.learn_washout, bool)
                or not isinstance(session.learn_washout, int)
                or session.learn_washout < 0
            ):
                raise ValueError(
                    f"session {session.sid}: learn_washout must be an int "
                    f">= 0; got {session.learn_washout!r}"
                )
        session._n_out = store.n_out if n_out is None else n_out
        if session.learn_w0 is not None or session.learn_P0 is not None:
            if self.learn is None or session.targets is None:
                raise ValueError(
                    f"session {session.sid}: learn_w0/learn_P0 resume a "
                    f"learn recursion — they require a learning engine and "
                    f"targets"
                )
            if session.learn_P0 is not None and self.learn == "lms":
                raise ValueError(
                    f"session {session.sid}: learn_P0 resumes an RLS "
                    f"inverse-Gram — learn='lms' carries no P; resume LMS "
                    f"sessions with learn_w0 alone"
                )
            s = store.n + 1
            if session.learn_w0 is not None:
                w0 = _host(session.learn_w0).astype(store.np_dtype)
                if w0.shape != (s, session._n_out):
                    raise ValueError(
                        f"session {session.sid}: learn_w0 shape "
                        f"{tuple(w0.shape)} != ({s}, {session._n_out})"
                    )
                session.learn_w0 = w0
            if session.learn_P0 is not None:
                p0 = _host(session.learn_P0).astype(store.np_dtype)
                if p0.shape != (s, s):
                    raise ValueError(
                        f"session {session.sid}: learn_P0 shape "
                        f"{tuple(p0.shape)} != ({s}, {s})"
                    )
                session.learn_P0 = p0
        self.scheduler.submit(session)

    def _pad_cols(self, a, what: str, sid: int) -> np.ndarray:
        """Zero-pad a session's (..., q) columns to the store's n_out width.
        Columns of a learned W update independently given the shared gain,
        so padding columns never perturb the session's own; results slice
        back to q."""
        a = _host(a).astype(self.store.np_dtype)
        q = a.shape[-1]
        if q > self.store.n_out:
            raise ValueError(
                f"session {sid}: {what} has {q} output columns but the engine "
                f"was built with n_out={self.store.n_out}; construct "
                f"ReservoirEngine(..., n_out={q}) (or wider) to serve it"
            )
        if q == self.store.n_out:
            return a
        return np.concatenate([a, np.zeros(a.shape[:-1] + (self.store.n_out - q,), a.dtype)], -1)

    def _admit_pending(self) -> None:
        placed = self.scheduler.admissions(self.store.free_slots())
        if not placed:
            return
        items = []
        for slot, sess in placed:
            w_out = None
            if sess.readout is not None:
                w_out = self._pad_cols(sess.readout.w_out, "readout", sess.sid)
            # a learner's lane starts from (in priority order) its resume
            # weights, else its readout, else zeros; learn_P0 resumes P
            w_learn = p_learn = None
            if sess.targets is not None:
                w_learn = (
                    w_out if sess.learn_w0 is None
                    else self._pad_cols(sess.learn_w0, "learn_w0", sess.sid)
                )
                p_learn = sess.learn_P0
            items.append((slot, sess.m0, sess.params, w_out, w_learn, p_learn))
            sess._slot = slot
            if sess._restored:
                # a restored session resumes mid-stream: restore_session
                # seeded _t and the harvested prefix
                sess._restored = False
            else:
                sess._t = 0
                sess._states = []
                sess._outs = []
                sess._preds = []
            sess._admitted_tick = self.tick_count
        self.store.admit_many(items)  # one write per array, not per session

    def _record_result(
        self,
        sess: StreamSession,
        slot: int,
        final_m: np.ndarray,
        learned_w: Optional[np.ndarray] = None,
    ) -> None:
        """Assemble a SessionResult from the session's harvested host blocks
        (and, for a learner, its lane's learned (S, n_out) weights)."""
        states = None
        if sess.collect_states:
            states = (
                np.concatenate(sess._states)
                if sess._states
                else np.zeros((0, self.store.n), self.store.np_dtype)
            )
        outputs = None
        if sess.readout is not None:
            outs = (
                np.concatenate(sess._outs)
                if sess._outs
                else np.zeros((0, sess._n_out), self.store.np_dtype)
            )
            outputs = outs[sess.readout.washout :]
        predictions = learned_readout = learn_nmse = None
        if sess.targets is not None:
            q = sess._n_out
            predictions = (
                np.concatenate(sess._preds)
                if sess._preds
                else np.zeros((0, q), self.store.np_dtype)
            )
            if learned_w is not None:
                # washout=0: the trained readout applies to any states; the
                # store's padding columns slice off
                learned_readout = Readout(w_out=torch.from_numpy(learned_w[:, :q]), washout=0)
            wo = sess.learn_washout
            if predictions.shape[0] > wo:
                p, y = predictions[wo:], sess.targets[wo:, :q]
                learn_nmse = float(np.mean((p - y) ** 2) / (np.var(y) + 1e-30))
        self.results[sess.sid] = SessionResult(
            sid=sess.sid,
            states=states,
            outputs=outputs,
            final_m=final_m,
            admitted_tick=sess._admitted_tick,
            finished_tick=sess._finished_tick,
            slot=slot,
            predictions=predictions,
            learned_readout=learned_readout,
            learn_nmse=learn_nmse,
            error=sess._error,
        )
        sess._states = []
        sess._outs = []
        sess._preds = []
        if self.max_retained is not None:
            while len(self.results) > self.max_retained:
                self.results.pop(next(iter(self.results)))

    def submit_autotuned(
        self,
        session: StreamSession,
        space,
        budget: int = 8,
        strategy="random",
        seed: int = 0,
        **kwargs,
    ):
        """Auto-tune this session's lane knobs during its washout window,
        then submit it with the winning parameters.

        `space` is a `repro_torch.tune.SearchSpace` over LANE knobs
        (STOParams fields; structural knobs would need a recompile, which a
        live engine cannot do). Probe sessions stream the tenant's washout
        prefix on spare lanes with negative sids, scored by the online
        learner; the best assignment is frozen into `session.params` and the
        session submits normally. Returns the probe `TuneResult`. Requires a
        learning engine and a learning session with learn_washout >= 2.

        Delegates to `repro_torch.tune.washout_autotune`, imported here:
        serve does not import tune at import time (tune drives serve).
        """
        from repro_torch.tune.driver import washout_autotune

        return washout_autotune(
            self, session, space, budget=budget, strategy=strategy, seed=seed, **kwargs
        )

    def pop_results(self) -> Dict[int, SessionResult]:
        """Drain finished-session results: returns sid -> SessionResult and
        clears the retained map."""
        out = self.results
        self.results = {}
        return out

    def _retire(self, slot: int) -> None:
        """Per-tick path: retire at once (the state column is current)."""
        sess = self.scheduler.retire(slot)
        sess._finished_tick = self.tick_count
        (final_m,) = _HostCopy([self.store.state_columns([slot])]).numpy()
        self._record_result(sess, slot, final_m[0].copy())
        self.store.retire(slot)

    # -- autoscale -------------------------------------------------------------

    def _maybe_autoscale(self) -> None:
        sched = self.scheduler
        active = len(sched.running)
        target = self.autoscale.target_slots(
            active=active,
            queued=len(sched.queue),
            num_slots=self.num_slots,
            min_slots=self.min_slots,
            max_slots=self.max_slots,
        )
        target = max(target, active, 1)
        bucket = _bucket_slots(target, self.min_slots, self.max_slots)
        if bucket != self.num_slots:
            self._rescale(bucket)

    def _rescale(self, new_e: int) -> None:
        """Move serving onto the CompiledSim of width new_e.

        Occupied slots compact into the low lanes of the new store (one
        gather-scatter per array, learn columns included); running sessions
        keep streaming across the boundary. The bucket comes from
        PLAN_CACHE. One this engine served before, or one that PLAN_CACHE
        holds already warmed (the prewarm thread's work), is a warm rescale
        and costs nothing here. Otherwise the boundary compiles and warms it
        now, and that time is the stall (cold_rescales / rescale_stall_s).
        The boundary warms with aot=True (`CompiledSim.aot_compile`: the
        library, the launch configuration and the shared-memory attribute,
        no launch): a masked chunk here would stall serving for a whole
        chunk on the card (and allocate a learn plan's P at the new width),
        while in a process whose kernels already ran the first real chunk
        at a new width costs what a later one does."""
        stats = self.scheduler.stats
        sim = self._sims.get(new_e)
        if sim is not None:
            stats.warm_rescales += 1
        else:
            spec, spec_hash = self.sim.spec, self._spec_hash
            plan_b = dataclasses.replace(self.sim.plan, ensemble=new_e)
            n_out = self.store.n_out
            lookup = dict(device=self.device, spec_hash=spec_hash)
            warm = PLAN_CACHE.contains(spec, plan_b, **lookup) and PLAN_CACHE.is_warm(
                spec, plan_b, n_out=n_out, **lookup
            )
            t0 = time.perf_counter()
            sim = PLAN_CACHE.get_or_compile(spec, plan_b, **lookup)
            PLAN_CACHE.warm(sim, n_out=n_out, aot=True, spec_hash=spec_hash)
            if warm:
                stats.warm_rescales += 1
            else:
                stats.cold_rescales += 1
                stats.rescale_stall_s += time.perf_counter() - t0
            self._sims[new_e] = sim
        slot_map = {old: new for new, old in enumerate(sorted(self.scheduler.running))}
        self.store = self.store.resized(new_e, slot_map)
        self.scheduler.remap(slot_map, new_e)
        for slot, sess in self.scheduler.running.items():
            sess._slot = slot
        self.sim = sim
        self.backend = sim.impl
        self.precision = sim.precision
        if self._prewarm_enabled:
            self.prewarm_buckets()

    def prewarm(self, block: bool = True) -> None:
        """Warm the current width's plan (one masked chunk through
        PLAN_CACHE) and the adjacent autoscale buckets: afterwards the first
        real chunk and the next rescale pay no first-dispatch cost."""
        PLAN_CACHE.warm(self.sim, n_out=self.store.n_out, spec_hash=self._spec_hash)
        self.prewarm_buckets(block=block)

    def prewarm_buckets(self, block: bool = False) -> Tuple[int, ...]:
        """Compile and warm the autoscale buckets adjacent to the current
        width in a daemon thread, so that a rescale at a chunk boundary finds
        its bucket warm in PLAN_CACHE.

        The thread launches its masked chunks on the stream this engine
        serves on (a cooperative kernel needs every cluster co-resident, so a
        side stream would buy no overlap). A rescale that races it for a
        bucket waits for that one compile. Not fatal: a failure is recorded
        in `prewarm_errors` and the rescale compiles on demand; a previous
        prewarm still running skips this round. Returns the widths
        scheduled; block=True waits for them. A sharded plan warms in the
        calling thread: its warmup chunk runs collectives, which every rank
        must issue in the same order."""
        if self.autoscale is None:
            return ()
        if self._prewarm_thread is not None and self._prewarm_thread.is_alive():
            if not block:
                return ()
            self._prewarm_thread.join()
        ladder = _bucket_ladder(self.min_slots, self.max_slots)
        below = [b for b in ladder if b < self.num_slots]
        above = [b for b in ladder if b > self.num_slots]
        spec, plan, dev = self.sim.spec, self.sim.plan, self.device
        n_out = self.store.n_out
        lookup = dict(n_out=n_out, device=dev, spec_hash=self._spec_hash)
        targets = tuple(
            b
            for b in ([below[-1]] if below else []) + ([above[0]] if above else [])
            if not PLAN_CACHE.is_warm(spec, dataclasses.replace(plan, ensemble=b), **lookup)
        )
        if not targets:
            return ()
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

        def work():
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                for b in targets:
                    try:
                        sim = PLAN_CACHE.ensure_warm(
                            spec, dataclasses.replace(plan, ensemble=b), **lookup
                        )
                        self._sims.setdefault(b, sim)
                    except Exception as exc:  # not fatal: the rescale compiles on demand
                        self.prewarm_errors.append((b, f"{type(exc).__name__}: {exc}"))

        if plan.sharded:
            work()
            return targets
        t = threading.Thread(target=work, daemon=True, name="plan-prewarm")
        self._prewarm_thread = t
        t.start()
        if block:
            t.join()
        return targets

    # -- the synchronous per-tick path -------------------------------------------

    def _advance(self, u: torch.Tensor) -> torch.Tensor:
        """One input tick for every slot; returns the (N, E) states plane."""
        store = self.store
        store.m, states_plane = self.sim.tick(
            store.m, u, lane_mask=store.active_mask, params=store.params_ensemble
        )
        return states_plane

    def step(self) -> bool:
        """Admit, advance one tick, harvest. Returns False when drained.

        The synchronous baseline: one `CompiledSim.tick` and one harvest per
        input tick. `run()` is the pipelined chunked path; both give the same
        per-session results, bit for bit on the scan impl and within the
        kernels' tolerance elsewhere. Do not interleave with `step_chunk()`
        while a chunk is in flight."""
        if self.learn is not None:
            raise RuntimeError(
                "online learning (ExecPlan.learn) runs on the chunked serving "
                "path only — drive the engine with run() or step_chunk() "
                "(chunk_ticks=1 keeps per-tick semantics)"
            )
        if self._subengines:
            raise RuntimeError(
                "mixed-spec tenants are served on the chunked path only — "
                "drive the engine with run() or step_chunk()"
            )
        self._admit_pending()
        running = self.scheduler.running
        if not running:
            return self.scheduler.has_work()
        store = self.store
        u = np.zeros((store.num_slots, store.n_in), store.np_dtype)
        any_readout = False
        for slot, sess in running.items():
            if sess.open:
                raise RuntimeError(
                    "open (push) streams are served on the chunked path only "
                    "— drive the engine with run() or step_chunk()"
                )
            u[slot] = sess.u_seq[sess._t]
            any_readout = any_readout or sess.readout is not None
        states_plane = self._advance(torch.from_numpy(u).to(self.device, non_blocking=True))
        outs = _apply_readouts(_with_bias(states_plane), store.w_out) if any_readout else None
        states_np, outs_np = _HostCopy([states_plane, outs]).numpy()  # (N, E), (E, n_out)
        self.scheduler.on_tick()
        self.tick_count += 1
        for slot, sess in list(running.items()):
            if sess.collect_states:
                sess._states.append(states_np[None, :, slot].copy())  # (1, N)
            if sess.readout is not None:
                sess._outs.append(outs_np[slot : slot + 1, : sess._n_out].copy())
            sess._t += 1
            if sess._t >= sess.u_seq.shape[0]:
                self._retire(slot)
        return True

    # -- the pipelined chunked path -----------------------------------------

    def _retire_finishers(self) -> None:
        """Snapshot + free the slots of sessions that finished inside the
        launched chunk. store.m is that chunk's (possibly still in-flight)
        result; the gather and its host copy are ordered after it on the
        stream. Results materialize at `_finalize_awaiting`."""
        if not self._finishing:
            return
        slots = [slot for slot, _ in self._finishing]
        # the final states and, on learning engines, the learned W columns
        # (k, S, n_out); P stays on the card
        finals = _HostCopy(
            [
                self.store.state_columns(slots),  # (k, N, 3)
                self.store.learn_w_columns(slots) if self.learn is not None else None,
            ]
        )
        for slot, _ in self._finishing:
            self.scheduler.retire(slot)
        self._awaiting = (self._finishing, finals)
        self.store.retire_many(slots)
        self._finishing = []

    def _scan_for_nonfinite(
        self,
        plan: _ChunkPlan,
        states_np: Optional[np.ndarray],
        outs_np: Optional[np.ndarray],
        preds_np: Optional[np.ndarray],
    ) -> None:
        """Per-chunk nan guard over the harvested blocks: one aggregate
        isfinite per block, per-lane isolation only when that trips. An
        offending tenant is marked for quarantine — its lane retires at the
        next boundary with a structured error, its harvested prefix intact;
        lanes are independent columns, so co-tenants are untouched."""
        blocks = [b for b in (states_np, outs_np, preds_np) if b is not None]
        if not blocks or all(np.isfinite(b).all() for b in blocks):
            return
        for sess, slot, n in plan.entries:
            if n == 0 or sess._error is not None:
                continue
            bad = []
            if (
                states_np is not None
                and sess.collect_states
                and not np.isfinite(states_np[:n, :, slot]).all()
            ):
                bad.append("states")
            if (
                outs_np is not None
                and sess.readout is not None
                and not np.isfinite(outs_np[:n, slot, : sess._n_out]).all()
            ):
                bad.append("outputs")
            if (
                preds_np is not None
                and sess.targets is not None
                and not np.isfinite(preds_np[:n, slot, : sess._n_out]).all()
            ):
                bad.append("predictions")
            if bad:
                sess._error = (
                    f"non_finite_state: session {sess.sid} (lane {slot}) "
                    f"produced non-finite {'/'.join(bad)} in the chunk "
                    f"ending at tick {sess._t}; tenant quarantined "
                    f"(co-tenant lanes unaffected)"
                )
                self.scheduler.stats.quarantined_lanes += 1
                self._quarantine.append((slot, sess))

    def _retire_quarantined(self) -> None:
        """Force-retire lanes the nan guard flagged (error-bearing result,
        clean harvested prefix) and free their slots."""
        for _, sess in self._quarantine:
            # the session's current slot: a rescale since the flag moves it
            slot = sess._slot
            if self.scheduler.running.get(slot) is not sess:
                continue  # finished or detached since it was flagged
            self.scheduler.retire(slot)
            sess._finished_tick = self.tick_count
            learning = self.learn is not None and sess.targets is not None
            final_m, w = _HostCopy(
                [
                    self.store.state_columns([slot]),
                    self.store.learn_w_columns([slot]) if learning else None,
                ]
            ).numpy()
            self._record_result(
                sess, slot, final_m[0].copy(), learned_w=None if w is None else w[0].copy()
            )
            self.store.retire_many([slot])
        self._quarantine = []

    def _assemble_chunk(self) -> Optional[_ChunkPlan]:
        """Host-side boundary work: retire the previous chunk's finishers,
        autoscale, admit, and build the next K-tick u/mask block. Returns
        None when nothing is left to serve, or when every resident session
        is an idle push stream. Runs while the card executes the previously
        launched chunk."""
        self._retire_finishers()
        self._retire_quarantined()
        # resize at the boundary (the slots now reflect retirements)
        if self.autoscale is not None:
            self._maybe_autoscale()
        self._admit_pending()
        running = self.scheduler.running
        if not running:
            return None

        # K-tick input block + per-tick lane masks (mid-chunk retires mask a
        # lane's trailing rows off; the slot refills next boundary)
        # plus, on learning engines, the target block and learn mask (False
        # rows: washout ticks, inference-only tenants, idle lanes)
        k = self.chunk_ticks
        e, n_in = self.store.num_slots, self.store.n_in
        u = np.zeros((k, e, n_in), self.store.np_dtype)
        mask = np.zeros((k, e), dtype=bool)
        learning = self.learn is not None
        y = np.zeros((k, e, self.store.n_out), self.store.np_dtype) if learning else None
        lmask = np.zeros((k, e), dtype=bool) if learning else None
        entries = []
        any_readout = any_learn = False
        session_ticks = 0
        for slot, sess in running.items():
            t0 = sess._t
            # an idle push stream (input exhausted, not closed) serves n = 0
            # ticks: its mask stays False all chunk, so its state is frozen
            # until append_ticks refills it
            n = min(k, sess.u_seq.shape[0] - t0)
            u[:n, slot] = sess.u_seq[t0 : t0 + n]
            mask[:n, slot] = True
            if learning and sess.targets is not None:
                y[:n, slot] = sess.targets[t0 : t0 + n]
                # update only from the session's learn_washout tick onward;
                # predictions are recorded from its first tick
                lmask[max(0, sess.learn_washout - t0) : n, slot] = True
                any_learn = any_learn or n > 0
            sess._t = t0 + n
            entries.append((sess, slot, n))
            session_ticks += n
            any_readout = any_readout or (sess.readout is not None and n > 0)
            if sess._t >= sess.u_seq.shape[0] and not sess.open:
                sess._finished_tick = self.tick_count + n
                self._finishing.append((slot, sess))
        if session_ticks == 0:
            # every resident is an idle push stream: launch nothing and keep
            # the clock still; quiesce so a just-closed, exhausted stream
            # retires with every harvested row
            self.quiesce()
            return None
        self.scheduler.on_ticks(k, session_ticks)
        self.tick_count += k
        return _ChunkPlan(
            entries=entries, u=u, mask=mask, any_readout=any_readout,
            targets=y, lmask=lmask, any_learn=any_learn,
        )

    def _launch_chunk(self, plan: _ChunkPlan) -> None:
        """Enqueue the chunk and the host copies of its blocks; returns
        without waiting for the card."""
        store = self.store
        # a cached mask of another width (before a rescale) never matches
        if self._mask_np is None or not (
            self._mask_np.shape == plan.mask.shape and np.array_equal(self._mask_np, plan.mask)
        ):
            self._mask_np = plan.mask
            self._mask_dev = torch.from_numpy(plan.mask).to(self.device, non_blocking=True)
        u = torch.from_numpy(plan.u).to(self.device, non_blocking=True)
        preds = None
        if self.learn is not None:
            if self._lmask_np is None or not (
                self._lmask_np.shape == plan.lmask.shape
                and np.array_equal(self._lmask_np, plan.lmask)
            ):
                self._lmask_np = plan.lmask
                self._lmask_dev = torch.from_numpy(plan.lmask).to(self.device, non_blocking=True)
            # one call advances physics AND learning; P/Wl stay on the card
            store.m, states_block, (store.P, store.Wl), preds = self.sim.tick_chunk(
                store.m,
                u,
                lane_mask=self._mask_dev,
                params=store.params_ensemble,
                targets=torch.from_numpy(plan.targets).to(self.device, non_blocking=True),
                learn_state=(store.P, store.Wl),
                learn_mask=self._lmask_dev,
            )
        else:
            store.m, states_block = self.sim.tick_chunk(
                store.m, u, lane_mask=self._mask_dev, params=store.params_ensemble
            )
        collect = any(sess.collect_states for sess, _, _ in plan.entries)
        outs_block = (
            _apply_readouts_chunk(states_block, store.w_out) if plan.any_readout else None
        )
        plan.copies = _HostCopy(
            [states_block if collect else None, outs_block, preds if plan.any_learn else None]
        )

    def _harvest_chunk(self, plan: _ChunkPlan) -> None:
        """Wait for the chunk's host copies, then per-session slicing."""
        states_np, outs_np, preds_np = plan.copies.numpy()
        if self.nan_guard:
            self._scan_for_nonfinite(plan, states_np, outs_np, preds_np)
        # .copy(): a bare slice would pin the whole chunk block per session
        for sess, slot, n in plan.entries:
            if n == 0 or sess._error is not None:
                continue
            if sess.collect_states:
                sess._states.append(states_np[:n, :, slot].copy())  # (n, N)
            if sess.readout is not None:
                sess._outs.append(outs_np[:n, slot, : sess._n_out].copy())
            if preds_np is not None and sess.targets is not None:
                sess._preds.append(preds_np[:n, slot, : sess._n_out].copy())
        # sessions retired at the last boundary: their final chunk is now
        # harvested, so their results are complete
        self._finalize_awaiting()

    def _finalize_awaiting(self) -> None:
        """Record results for sessions retired at the previous boundary."""
        if self._awaiting is None:
            return
        finishers, finals = self._awaiting
        finals_np, w_np = finals.numpy()  # (k, N, 3), (k, S, n_out) or None
        for i, (slot, sess) in enumerate(finishers):
            learned_w = w_np[i].copy() if w_np is not None and sess.targets is not None else None
            self._record_result(sess, slot, finals_np[i].copy(), learned_w=learned_w)
        self._awaiting = None

    def step_chunk(self) -> bool:
        """Advance the pipeline by one chunk. Returns False when drained.

        One call = assemble + launch the next K-tick chunk, then harvest the
        PREVIOUSLY launched one (which the card ran while the host
        assembled). The final call launches nothing and harvests the
        trailing chunk. Keep calling until it returns False."""
        t0 = time.perf_counter()
        plan = self._assemble_chunk()
        if plan is not None:
            self._launch_chunk(plan)
        if self._pending is not None:
            self._harvest_chunk(self._pending)
        else:
            self._finalize_awaiting()
        self._pending = plan
        if plan is not None:
            self._chunk_times.append(time.perf_counter() - t0)
        progress = plan is not None
        # the mixed-spec tenants advance in lockstep; their finished sessions
        # surface in this engine's results
        for sub in self._subengines.values():
            progress = sub.step_chunk() or progress
            if sub.results:
                self.results.update(sub.pop_results())
        if self._subengines and self.max_retained is not None:
            while len(self.results) > self.max_retained:
                self.results.pop(next(iter(self.results)))
        return progress

    def quiesce(self) -> None:
        """Drain the pipeline without launching new work: harvest the
        in-flight chunk and record any finishers' results. Afterwards the
        slot store's columns are current for every resident session, the
        precondition of `checkpoint_session`. Serving resumes with the next
        `step_chunk()` / `run()`."""
        if self._pending is not None:
            self._harvest_chunk(self._pending)
            self._pending = None
        self._retire_finishers()
        self._finalize_awaiting()
        for sub in self._subengines.values():
            sub.quiesce()
            if sub.results:
                self.results.update(sub.pop_results())

    def run(self, sessions: Optional[List[StreamSession]] = None) -> Dict[int, SessionResult]:
        """Serve sessions to completion; returns sid -> SessionResult."""
        for s in sessions or []:
            self.submit(s)
        while self.step_chunk():
            pass
        return self.results

    # -- push streams, checkpoints ---------------------------------------------

    def _find_session(self, sid: int) -> Tuple[Optional[int], StreamSession]:
        """Locate a live session by sid: (slot, session) if resident, (None,
        session) if still queued. Raises KeyError when unknown (finished
        sessions live in `results`)."""
        for slot, sess in self.scheduler.running.items():
            if sess.sid == sid:
                return slot, sess
        for sess in self.scheduler.queue:
            if sess.sid == sid:
                return None, sess
        raise KeyError(f"no live session with sid {sid}")

    def _owner(self, sid: int) -> "ReservoirEngine":
        """The engine holding sid: this one, or the sub-engine its spec
        routed it to. Raises KeyError when no engine knows it."""
        for eng in (self, *self._subengines.values()):
            try:
                eng._find_session(sid)
                return eng
            except KeyError:
                continue
        raise KeyError(f"no live session with sid {sid}")

    def append_ticks(self, sid: int, u, targets=None) -> None:
        """Feed more input rows to an OPEN (push) stream.

        The rows join the session's stream at its tail; an idle lane picks
        them up at the next chunk boundary. Learning sessions must push
        matching target rows (and inference sessions must not)."""
        eng = self._owner(sid)
        if eng is not self:
            return eng.append_ticks(sid, u, targets)
        _, sess = self._find_session(sid)
        if not sess.open:
            raise ValueError(
                f"session {sid} is not an open stream — submit it with "
                f"open=True to push ticks"
            )
        store = self.store
        u = coerce_input_series(u, store.n_in, store.np_dtype, xp=np)
        if sess.targets is not None:
            if targets is None:
                raise ValueError(
                    f"session {sid} is a learning stream — push target rows "
                    f"alongside the inputs"
                )
            t = _host(targets).astype(store.np_dtype)
            if t.ndim == 1:
                t = t[:, None]
            if t.shape != (u.shape[0], sess._n_out):
                raise ValueError(
                    f"session {sid}: pushed targets shape "
                    f"{tuple(np.shape(targets))} != ({u.shape[0]}, {sess._n_out})"
                )
            # reassigned, never written in place: a snapshot may hold the
            # old array
            sess.targets = np.concatenate([sess.targets, self._pad_cols(t, "targets", sid)])
        elif targets is not None:
            raise ValueError(f"session {sid} is inference-only; it cannot take targets")
        sess.u_seq = np.concatenate([sess.u_seq, u])

    def close_session(self, sid: int) -> None:
        """End an open stream: once its pushed input is exhausted the session
        finishes like any closed-stream session (result in `results`)."""
        _, sess = self._owner(sid)._find_session(sid)
        sess.open = False

    def _freeze_sessions(
        self, live: List[Tuple[Optional[int], StreamSession]], detach: bool
    ) -> List[SessionCheckpoint]:
        """Host-side SessionCheckpoints of live (slot, session) pairs, slot
        None for a queued session. The pipeline must be quiesced (columns
        current, nothing in flight). The resident sessions' m, P and Wl
        columns come to the host in one gather each. detach=True removes
        the sessions from this engine (migration); detach=False leaves them
        serving untouched: every array a checkpoint holds is a copy, or one
        the engine only ever replaces (u_seq / targets grow by
        reassignment)."""
        store = self.store
        resident = [(slot, sess) for slot, sess in live if slot is not None]
        slots = [slot for slot, _ in resident]
        learners = [
            slot for slot, sess in resident if self.learn is not None and sess.targets is not None
        ]
        m_np = p_np = w_np = None
        if resident:
            m_np, p_np, w_np = _HostCopy(
                [
                    store.state_columns(slots),  # (k, N, 3)
                    store.learn_P_columns(learners) if learners and self.learn == "rls" else None,
                    store.learn_w_columns(learners) if learners else None,
                ]
            ).numpy()
        col = {slot: i for i, slot in enumerate(slots)}
        lcol = {slot: i for i, slot in enumerate(learners)}

        def cat(blocks):
            return np.concatenate(blocks) if blocks else None

        out = []
        for slot, sess in live:
            q = sess._n_out
            learning = self.learn is not None and sess.targets is not None
            m = P = Wl = None
            if slot is None:
                if sess.m0 is not None:
                    m = _host(sess.m0).astype(store.np_dtype).copy()
            else:
                m = m_np[col[slot]].copy()
                if learning:
                    # LMS learners carry no inverse-Gram: Wl is their whole
                    # learn state. Padding columns stay zero for a session's
                    # life (zero targets, zero start), so slicing is exact.
                    P = None if p_np is None else p_np[lcol[slot]].copy()
                    Wl = w_np[lcol[slot]][:, :q].copy()
            params = None
            if sess.params is not None:
                params = STOParams(*(torch.as_tensor(x).detach().cpu().clone() for x in sess.params))
            out.append(
                SessionCheckpoint(
                    sid=sess.sid,
                    u_seq=sess.u_seq,
                    t=sess._t,
                    m=m,
                    params=params,
                    readout_w=None if sess.readout is None else _host(sess.readout.w_out).copy(),
                    readout_washout=0 if sess.readout is None else sess.readout.washout,
                    collect_states=sess.collect_states,
                    targets=None if sess.targets is None else sess.targets[:, :q].copy(),
                    learn_washout=sess.learn_washout,
                    open=sess.open,
                    n_out=q,
                    states=cat(sess._states) if sess.collect_states else None,
                    outs=cat(sess._outs) if sess.readout is not None else None,
                    preds=cat(sess._preds) if learning else None,
                    P=P,
                    Wl=Wl,
                    spec=_spec_host(sess.spec),
                )
            )
        if detach:
            for slot, sess in live:
                if slot is None:
                    self.scheduler.remove_queued(sess)
                else:
                    self.scheduler.detach(slot)
                sess._states, sess._outs, sess._preds = [], [], []
            if slots:
                store.retire_many(slots)
        return out

    def checkpoint_session(self, sid: int) -> SessionCheckpoint:
        """Freeze a live session into a host-side SessionCheckpoint and
        remove it from this engine (a detach, not a retirement: no
        SessionResult is recorded). It restores into any engine of the same
        spec through `restore_session`. Quiesces the pipeline first."""
        self.quiesce()
        eng = self._owner(sid)
        if eng is not self:
            return eng.checkpoint_session(sid)
        slot, sess = self._find_session(sid)
        return self._freeze_sessions([(slot, sess)], detach=True)[0]

    def snapshot_sessions(self) -> List[SessionCheckpoint]:
        """Non-destructive checkpoints of EVERY live session, running and
        queued, sub-engines included. Quiesces the pipeline first; every
        session keeps serving, and its stream is bit-identical to one that
        was never snapshotted.
        Sessions the nan guard flagged are left out, so a restore never
        resurrects a poisoned stream."""
        self.quiesce()
        live = [(slot, s) for slot, s in self.scheduler.running.items() if s._error is None]
        live += [(None, s) for s in self.scheduler.queue if s._error is None]
        out = self._freeze_sessions(live, detach=False)
        for sub in self._subengines.values():
            out.extend(sub.snapshot_sessions())
        return out

    def restore_session(self, ckpt: SessionCheckpoint) -> StreamSession:
        """Resume a checkpointed session on THIS engine: submit it with the
        frozen magnetization as m0 and the learner in flight as its learn
        resume (P, Wl), then seed the served prefix so the final
        SessionResult covers the whole stream. A checkpoint that carries its
        spec routes as a submitted session does (possibly onto a sub-engine
        of this engine)."""
        readout = None
        if ckpt.readout_w is not None:
            readout = Readout(w_out=torch.from_numpy(np.array(ckpt.readout_w)), washout=ckpt.readout_washout)
        sess = StreamSession(
            sid=ckpt.sid,
            u_seq=ckpt.u_seq,
            params=ckpt.params,
            readout=readout,
            m0=ckpt.m,
            collect_states=ckpt.collect_states,
            targets=ckpt.targets,
            learn_washout=ckpt.learn_washout,
            open=ckpt.open,
            learn_w0=ckpt.Wl,
            learn_P0=ckpt.P,
            spec=ckpt.spec,
        )
        self.submit(sess)
        if ckpt.t:
            sess._t = ckpt.t
            sess._states = [] if ckpt.states is None else [ckpt.states]
            sess._outs = [] if ckpt.outs is None else [ckpt.outs]
            sess._preds = [] if ckpt.preds is None else [ckpt.preds]
            sess._restored = True  # _admit_pending keeps the seeded prefix
        return sess

    def stats(self) -> EngineStats:
        """Load/latency snapshot — plain scalars only."""
        sched = self.scheduler
        timed = sorted(self._chunk_times)
        median = timed[len(timed) // 2] if timed else None
        return EngineStats(
            n=self.res.n,
            num_slots=self.num_slots,
            active=len(sched.running),
            queued=len(sched.queue),
            backend=self.backend,
            precision=self.precision,
            learn=self.learn,
            chunk_ticks=self.chunk_ticks,
            ticks=sched.stats.ticks,
            session_ticks=sched.stats.session_ticks,
            occupancy=sched.occupancy(),
            queue_depth=sched.queue_depth(),
            mean_queue_wait=sched.mean_queue_wait(),
            grows=sched.stats.grows,
            shrinks=sched.stats.shrinks,
            detached=sched.stats.detached,
            cold_rescales=sched.stats.cold_rescales,
            warm_rescales=sched.stats.warm_rescales,
            rescale_stall_s=sched.stats.rescale_stall_s,
            chunk_median_s=median,
            chunks_timed=len(timed),
            ticks_per_sec=None if not median else self.num_slots * self.chunk_ticks / median,
            sub_engines=len(self._subengines),
            quarantined_lanes=sched.stats.quarantined_lanes
            + sum(sub.scheduler.stats.quarantined_lanes for sub in self._subengines.values()),
        )
