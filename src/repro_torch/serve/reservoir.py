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

Not ported yet (ROADMAP queue 1 item 7 and later): the per-tick `step()`,
autoscale, online learning, mixed-spec sub-engines, push streams,
checkpoints and autotune.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.api import CompiledSim, ExecPlan, SimSpec, compile_plan
from repro_torch.core.constants import STOParams
from repro_torch.core.reservoir import Readout, coerce_input_series
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve.state_store import SlotStore

BACKENDS = ("auto", "ref", "fused", "tiled", "chunk")

# ReservoirEngine options of the reference that are not ported yet
_WAITING_OPTIONS = {
    "autoscale": "queue 1 item 7, autoscale",
    "min_slots": "queue 1 item 7, autoscale",
    "max_slots": "queue 1 item 7, autoscale",
    "prewarm": "queue 1 item 9, plan cache",
    "learn": "queue 1 item 6, online learning tails",
    "learn_lam": "queue 1 item 6, online learning tails",
    "learn_reg": "queue 1 item 6, online learning tails",
    "learn_mu": "queue 1 item 6, online learning tails",
    "compilation_cache_dir": "queue 1 item 9, plan cache",
}


@dataclasses.dataclass
class StreamSession:
    """One tenant's streaming request.

    u_seq follows the explicit (T, N_in) contract ((T,) for n_in == 1).
    params overrides the engine template's physical parameters for this
    tenant's lane; readout is the tenant's trained linear readout (None =
    state collection only); m0 resumes from a previous session's final
    state. `targets`, `open` and `spec` (online learning, push streams,
    mixed-spec tenancy) are not ported yet and raise at submit.
    """

    sid: int
    u_seq: np.ndarray
    params: Optional[STOParams] = None
    readout: Optional[Readout] = None
    m0: Optional[object] = None
    collect_states: bool = True
    targets: Optional[np.ndarray] = None
    open: bool = False
    spec: Optional[SimSpec] = None

    # engine-internal bookkeeping (set on admit)
    _slot: int = dataclasses.field(default=-1, repr=False)
    _t: int = dataclasses.field(default=0, repr=False)
    _states: list = dataclasses.field(default_factory=list, repr=False)
    _outs: list = dataclasses.field(default_factory=list, repr=False)
    _admitted_tick: int = dataclasses.field(default=-1, repr=False)
    _finished_tick: int = dataclasses.field(default=-1, repr=False)
    _n_out: int = dataclasses.field(default=1, repr=False)
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
    # set when the nan guard quarantined this tenant's lane; the arrays then
    # hold the clean prefix before the offending chunk
    error: Optional[str] = None


@dataclasses.dataclass
class EngineStats:
    """One engine's load/latency snapshot — plain scalars only."""

    n: int
    num_slots: int
    active: int
    queued: int
    backend: str
    precision: Optional[str]
    chunk_ticks: int
    ticks: int
    session_ticks: int
    occupancy: float
    queue_depth: int
    mean_queue_wait: float
    chunk_median_s: Optional[float]  # median wall time of recent chunks
    chunks_timed: int
    ticks_per_sec: Optional[float]  # E * K / chunk_median_s
    quarantined_lanes: int = 0


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
    copies: Optional[_HostCopy] = None  # (states (K, N, E), outs (K, E, n_out))


def _apply_readouts_chunk(states_block, w_out):
    """Slot-batched readout: (K, N, E) x (E, N+1, n_out) -> (K, E, n_out)."""
    k, _, e = states_block.shape
    xb = torch.cat(
        [states_block, torch.ones((k, 1, e), dtype=states_block.dtype, device=states_block.device)],
        dim=1,
    )
    return torch.einsum("kne,eno->keo", xb, w_out)


class ReservoirEngine:
    """Serve many concurrent reservoir streams from one batched simulator.

    Construct either from a SimSpec plus num_slots (the ensemble capacity E),
    in which case the engine compiles an ExecPlan on `device` ("cuda" by
    default); or from an already-compiled CompiledSim (num_slots defaults to
    the plan's ensemble width).

    Serving knobs:
      backend       auto | ref | fused | tiled | chunk (ExecPlan.impl)
      chunk_ticks   K ticks per call — `run()` pipelines K-tick chunks
      interpret     run the plain PyTorch versions of the kernels (checking)
      precision     None/"highest" full f32, "bf16_coupling"/"mixed" reduced
      max_retained  cap on finished SessionResults kept in `results`
      nan_guard     quarantine a tenant whose harvested rows went non-finite
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
        **waiting,
    ):
        for name, value in waiting.items():
            if name not in _WAITING_OPTIONS:
                raise TypeError(f"ReservoirEngine got an unexpected keyword {name!r}")
            if value is not None:
                raise NotImplementedError(
                    f"ReservoirEngine({name}=...) is not ported yet "
                    f"(ROADMAP {_WAITING_OPTIONS[name]})"
                )
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
            ):
                raise ValueError(
                    "backend/measure/interpret/chunk_ticks/precision are "
                    "ExecPlan decisions; when constructing from a CompiledSim, "
                    "set them on the plan passed to compile_plan instead"
                )
            num_slots = sim.plan.ensemble
        else:
            if num_slots is None:
                raise TypeError("num_slots is required when constructing from a SimSpec")
            if backend not in BACKENDS:
                raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
            sim = compile_plan(
                res,
                ExecPlan(
                    impl=backend,
                    ensemble=num_slots,
                    interpret=interpret,
                    measure=measure,
                    chunk_ticks=1 if chunk_ticks is None else chunk_ticks,
                    precision=precision,
                ),
                device=device,
            )
        self.sim = sim
        self.res = sim.spec
        self.device = sim.device
        self.chunk_ticks = sim.plan.chunk_ticks
        self.store = SlotStore(sim.spec, num_slots, n_out=n_out)
        self.scheduler = SlotScheduler(num_slots)
        self.tick_count = 0
        self.results: Dict[int, SessionResult] = {}
        self.max_retained = max_retained
        self.backend = sim.impl
        self.precision = sim.precision
        self.nan_guard = bool(nan_guard)

        # sessions whose final tick was served by the most recently LAUNCHED
        # chunk (slot still holds their state until the next boundary)
        self._finishing: List[Tuple[int, StreamSession]] = []
        # one boundary's retired sessions awaiting their final states' copy
        self._awaiting: Optional[Tuple[List[Tuple[int, StreamSession]], _HostCopy]] = None
        # device copy of the last chunk's lane-mask block; steady-state
        # chunks repeat the same mask, so skip the re-upload
        self._mask_np: Optional[np.ndarray] = None
        self._mask_dev: Optional[torch.Tensor] = None
        self._quarantine: List[Tuple[int, StreamSession]] = []
        # the launched-but-unharvested chunk (the pipeline's second buffer)
        self._pending: Optional[_ChunkPlan] = None
        self._chunk_times: deque = deque(maxlen=128)

    @property
    def num_slots(self) -> int:
        return self.store.num_slots

    # -- session lifecycle -------------------------------------------------

    def submit(self, session: StreamSession) -> None:
        for field, item in (
            ("targets", "queue 1 item 6, online learning"),
            ("spec", "queue 1 item 8, mixed-spec tenancy"),
        ):
            if getattr(session, field) is not None:
                raise NotImplementedError(
                    f"session {session.sid}: StreamSession.{field} is not ported yet (ROADMAP {item})"
                )
        if session.open:
            raise NotImplementedError(
                f"session {session.sid}: push streams (open=True) are not ported "
                "yet (ROADMAP queue 1 item 7)"
            )
        # the engine assembles u blocks host-side, so the series stays numpy
        u = coerce_input_series(session.u_seq, self.store.n_in, self.store.np_dtype, xp=np)
        if u.shape[0] == 0:
            raise ValueError(f"session {session.sid}: empty input stream")
        session.u_seq = u
        session._n_out = self.store.n_out
        if session.readout is not None:
            w = session.readout.w_out
            if w.ndim != 2 or w.shape[0] != self.store.n + 1 or not (
                1 <= w.shape[1] <= self.store.n_out
            ):
                raise ValueError(
                    f"session {session.sid}: readout w_out shape "
                    f"{tuple(w.shape)} must be ({self.store.n + 1}, q) with "
                    f"1 <= q <= {self.store.n_out} (the engine's n_out)"
                )
            session._n_out = w.shape[1]
        self.scheduler.submit(session)

    def _pad_cols(self, w) -> np.ndarray:
        """A session's (N+1, q) readout widened to the store's n_out with zero
        columns (results slice back to q)."""
        w = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        w = w.astype(self.store.np_dtype)
        pad = self.store.n_out - w.shape[1]
        return w if pad == 0 else np.concatenate([w, np.zeros((w.shape[0], pad), w.dtype)], 1)

    def _admit_pending(self) -> None:
        placed = self.scheduler.admissions(self.store.free_slots())
        if not placed:
            return
        items = []
        for slot, sess in placed:
            w_out = None if sess.readout is None else self._pad_cols(sess.readout.w_out)
            items.append((slot, sess.m0, sess.params, w_out))
            sess._slot = slot
            sess._t = 0
            sess._states = []
            sess._outs = []
            sess._admitted_tick = self.tick_count
        self.store.admit_many(items)  # one write per array, not per session

    def _record_result(self, sess: StreamSession, slot: int, final_m: np.ndarray) -> None:
        """Assemble a SessionResult from the session's harvested host blocks."""
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
        self.results[sess.sid] = SessionResult(
            sid=sess.sid,
            states=states,
            outputs=outputs,
            final_m=final_m,
            admitted_tick=sess._admitted_tick,
            finished_tick=sess._finished_tick,
            slot=slot,
            error=sess._error,
        )
        sess._states = []
        sess._outs = []
        if self.max_retained is not None:
            while len(self.results) > self.max_retained:
                self.results.pop(next(iter(self.results)))

    def pop_results(self) -> Dict[int, SessionResult]:
        """Drain finished-session results: returns sid -> SessionResult and
        clears the retained map."""
        out = self.results
        self.results = {}
        return out

    # -- the pipelined chunked path -----------------------------------------

    def _retire_finishers(self) -> None:
        """Snapshot + free the slots of sessions that finished inside the
        launched chunk. store.m is that chunk's (possibly still in-flight)
        result; the gather and its host copy are ordered after it on the
        stream. Results materialize at `_finalize_awaiting`."""
        if not self._finishing:
            return
        slots = [slot for slot, _ in self._finishing]
        finals = _HostCopy([self.store.state_columns(slots)])  # (k, N, 3)
        for slot, _ in self._finishing:
            self.scheduler.retire(slot)
        self._awaiting = (self._finishing, finals)
        self.store.retire_many(slots)
        self._finishing = []

    def _scan_for_nonfinite(
        self, plan: _ChunkPlan, states_np: Optional[np.ndarray], outs_np: Optional[np.ndarray]
    ) -> None:
        """Per-chunk nan guard over the harvested blocks: one aggregate
        isfinite per block, per-lane isolation only when that trips. An
        offending tenant is marked for quarantine — its lane retires at the
        next boundary with a structured error, its harvested prefix intact;
        lanes are independent columns, so co-tenants are untouched."""
        blocks = [b for b in (states_np, outs_np) if b is not None]
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
        for slot, sess in self._quarantine:
            if self.scheduler.running.get(slot) is not sess:
                continue  # finished since it was flagged
            self.scheduler.retire(slot)
            sess._finished_tick = self.tick_count
            (final_m,) = _HostCopy([self.store.state_columns([slot])]).numpy()
            self._record_result(sess, slot, final_m[0].copy())
            self.store.retire_many([slot])
        self._quarantine = []

    def _assemble_chunk(self) -> Optional[_ChunkPlan]:
        """Host-side boundary work: retire the previous chunk's finishers,
        admit, and build the next K-tick u/mask block. Returns None when
        nothing is left to serve. Runs while the card executes the
        previously launched chunk."""
        self._retire_finishers()
        self._retire_quarantined()
        self._admit_pending()
        running = self.scheduler.running
        if not running:
            return None

        # K-tick input block + per-tick lane masks (mid-chunk retires mask a
        # lane's trailing rows off; the slot refills next boundary)
        k = self.chunk_ticks
        e, n_in = self.store.num_slots, self.store.n_in
        u = np.zeros((k, e, n_in), self.store.np_dtype)
        mask = np.zeros((k, e), dtype=bool)
        entries = []
        any_readout = False
        session_ticks = 0
        for slot, sess in running.items():
            t0 = sess._t
            n = min(k, sess.u_seq.shape[0] - t0)
            u[:n, slot] = sess.u_seq[t0 : t0 + n]
            mask[:n, slot] = True
            sess._t = t0 + n
            entries.append((sess, slot, n))
            session_ticks += n
            any_readout = any_readout or sess.readout is not None
            if sess._t >= sess.u_seq.shape[0]:
                sess._finished_tick = self.tick_count + n
                self._finishing.append((slot, sess))
        self.scheduler.on_ticks(k, session_ticks)
        self.tick_count += k
        return _ChunkPlan(entries=entries, u=u, mask=mask, any_readout=any_readout)

    def _launch_chunk(self, plan: _ChunkPlan) -> None:
        """Enqueue the chunk and the host copies of its blocks; returns
        without waiting for the card."""
        store = self.store
        if self._mask_np is None or not np.array_equal(self._mask_np, plan.mask):
            self._mask_np = plan.mask
            self._mask_dev = torch.from_numpy(plan.mask).to(self.device, non_blocking=True)
        store.m, states_block = self.sim.tick_chunk(
            store.m,
            torch.from_numpy(plan.u).to(self.device, non_blocking=True),
            lane_mask=self._mask_dev,
            params=store.params_ensemble,
        )
        collect = any(sess.collect_states for sess, _, _ in plan.entries)
        outs_block = (
            _apply_readouts_chunk(states_block, store.w_out) if plan.any_readout else None
        )
        plan.copies = _HostCopy([states_block if collect else None, outs_block])

    def _harvest_chunk(self, plan: _ChunkPlan) -> None:
        """Wait for the chunk's host copies, then per-session slicing."""
        states_np, outs_np = plan.copies.numpy()
        if self.nan_guard:
            self._scan_for_nonfinite(plan, states_np, outs_np)
        # .copy(): a bare slice would pin the whole chunk block per session
        for sess, slot, n in plan.entries:
            if n == 0 or sess._error is not None:
                continue
            if sess.collect_states:
                sess._states.append(states_np[:n, :, slot].copy())  # (n, N)
            if sess.readout is not None:
                sess._outs.append(outs_np[:n, slot, : sess._n_out].copy())
        # sessions retired at the last boundary: their final chunk is now
        # harvested, so their results are complete
        self._finalize_awaiting()

    def _finalize_awaiting(self) -> None:
        """Record results for sessions retired at the previous boundary."""
        if self._awaiting is None:
            return
        finishers, finals = self._awaiting
        (finals_np,) = finals.numpy()  # (k, N, 3)
        for i, (slot, sess) in enumerate(finishers):
            self._record_result(sess, slot, finals_np[i].copy())
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
        return plan is not None

    def quiesce(self) -> None:
        """Drain the pipeline without launching new work: harvest the
        in-flight chunk and record any finishers' results."""
        if self._pending is not None:
            self._harvest_chunk(self._pending)
            self._pending = None
        self._retire_finishers()
        self._finalize_awaiting()

    def run(self, sessions: Optional[List[StreamSession]] = None) -> Dict[int, SessionResult]:
        """Serve sessions to completion; returns sid -> SessionResult."""
        for s in sessions or []:
            self.submit(s)
        while self.step_chunk():
            pass
        return self.results

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
            chunk_ticks=self.chunk_ticks,
            ticks=sched.stats.ticks,
            session_ticks=sched.stats.session_ticks,
            occupancy=sched.occupancy(),
            queue_depth=sched.queue_depth(),
            mean_queue_wait=sched.mean_queue_wait(),
            chunk_median_s=median,
            chunks_timed=len(timed),
            ticks_per_sec=None if not median else self.num_slots * self.chunk_ticks / median,
            quarantined_lanes=sched.stats.quarantined_lanes,
        )
