"""Asyncio front-end for the fleet: submit/push/drain with admission control.

The front-end owns a background PUMP task that advances every replica one
chunk round at a time (via the router's overlapped `run_for`) and folds
finished results into an awaitable map. Client coroutines see three
verbs:

    sid = await fleet.submit_stream(n=16, u_seq=u)        # place
    await fleet.push_ticks(sid, more_u)                   # feed (open)
    result = await fleet.result(sid)                      # harvest

Admission control is PLANNER-DRIVEN, not reactive: the per-pool inflight
ceiling is what the calibrated `CapacityModel` says the pool can retire
within `admit_window_s` seconds (floored at the pool's slot capacity —
the planner never starves a pool below what its hardware holds).
`submit_stream` applies BACKPRESSURE by awaiting until the pool dips
below its ceiling; with `max_waiters` set, submissions beyond that
ceiling-plus-queue fail fast with `AdmissionError` instead of building an
unbounded wait line. Both behaviors exist so a bursty tenant slows down
at the door rather than inflating every resident tenant's latency.

Engine/replica calls run in a dedicated SINGLE-THREADED executor: local
replicas release the GIL inside torch's kernels and while they wait on the
card, and process replicas spend the time blocked on a pipe, so the loop
stays responsive either way —
but router access must never overlap, because a ProcessReplica pipe has
exactly one reply stream (two threads interleaving send/recv would steal
each other's replies). One worker serializes pump rounds, submissions,
and pushes; the replica children still run their chunks in parallel via
the router's split-phase launch/collect pump. So a local replica is
stepped from the executor's thread, not the thread that built it; on a
card that thread launches on the same device and default stream, and the
engine's host-copy events and its prewarm thread (which launches on the
stream current when it starts) order against the chunks as they do on the
building thread.

Fault tolerance: client-facing router calls retry `ReplicaError` with
capped exponential backoff (the router fails dead replicas over
synchronously; the retry bridges recoveries that need a pump round), the
pump itself survives replica failures, and DEGRADED mode — forced via
`set_degraded(True)` or automatic while any pool replica's health is not
"healthy" — sheds new streams with a structured `OverloadError` instead
of queueing unboundedly behind a recovery. `shed_streams` and
`fault_stats()` expose the tally.
"""

from __future__ import annotations

import asyncio
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from repro_torch.serve.reservoir import SessionResult, StreamSession

from .planner import CapacityModel
from .replica import HEALTH_HEALTHY, ReplicaError
from .router import FleetRouter


class AdmissionError(RuntimeError):
    """Submission rejected: the pool is at capacity and its wait line is
    full. Retry later or grow the fleet (`CapacityModel.plan_fleet`)."""


class OverloadError(AdmissionError):
    """Structured DEGRADED-mode rejection: the pool is running with
    reduced capacity (a replica unhealthy/respawning, or degraded mode
    forced) and new streams are shed at the door instead of queueing
    behind a recovery. Carries machine-readable fields so a client can
    back off or re-target without parsing the message."""

    def __init__(self, n: int, inflight: int, limit: int, reason: str):
        self.n = n
        self.inflight = inflight
        self.limit = limit
        self.reason = reason
        super().__init__(
            f"pool N={n} degraded ({reason}): shedding new streams at "
            f"{inflight}/{limit} inflight — retry with backoff"
        )

    def to_dict(self) -> dict:
        return {
            "error": "overload",
            "n": self.n,
            "inflight": self.inflight,
            "limit": self.limit,
            "reason": self.reason,
        }


class FleetFrontend:
    def __init__(
        self,
        router: FleetRouter,
        planner: Optional[CapacityModel] = None,
        admit_window_s: float = 1.0,
        max_waiters: Optional[int] = None,
        idle_sleep_s: float = 0.002,
        degraded: bool = False,
        rpc_retries: int = 2,
        rpc_backoff_s: float = 0.05,
        rpc_backoff_max_s: float = 1.0,
    ):
        if not isinstance(rpc_retries, int) or isinstance(rpc_retries, bool) or rpc_retries < 0:
            raise ValueError(f"rpc_retries must be an int >= 0; got {rpc_retries!r}")
        if not rpc_backoff_s > 0:
            raise ValueError(f"rpc_backoff_s must be > 0; got {rpc_backoff_s!r}")
        if not rpc_backoff_max_s >= rpc_backoff_s:
            raise ValueError(
                f"rpc_backoff_max_s ({rpc_backoff_max_s!r}) must be >= "
                f"rpc_backoff_s ({rpc_backoff_s!r})"
            )
        self.router = router
        self.planner = planner if planner is not None else router.planner
        self.admit_window_s = admit_window_s
        self.max_waiters = max_waiters
        self.idle_sleep_s = idle_sleep_s
        # in-flight RPC resilience: a router call that still fails after
        # the router's own synchronous failover (ReplicaError) is retried
        # with capped exponential backoff — recovery may need a pump round
        self.rpc_retries = rpc_retries
        self.rpc_backoff_s = rpc_backoff_s
        self.rpc_backoff_max_s = rpc_backoff_max_s
        # degraded mode: shed new streams with a structured OverloadError
        # instead of queueing unboundedly. Entered explicitly
        # (set_degraded) or automatically while any pool replica's health
        # is not "healthy".
        self._degraded = bool(degraded)
        self.shed_streams = 0
        self._inflight: Dict[int, int] = {}  # pool N -> live sessions
        self._waiters: Dict[int, int] = {}  # pool N -> queued submitters
        self._sid_pool: Dict[int, int] = {}  # sid -> pool N (accounting)
        self._results: Dict[int, SessionResult] = {}
        self._cond: Optional[asyncio.Condition] = None
        self._pump_task: Optional[asyncio.Task] = None
        self._stopping = False
        # ONE worker: replica pipes carry one reply stream each, so router
        # calls (pump / submit / push / close) must never overlap
        self._exec: Optional[ThreadPoolExecutor] = None

    # -- capacity -----------------------------------------------------------

    def pool_limit(self, n: int, degraded: bool = False) -> Optional[int]:
        """Planner-estimated inflight ceiling for pool N (None: unlimited,
        no planner given). Sessions the pool can retire in admit_window_s,
        never below the pool's aggregate slot count. degraded=True prices
        the pool at one replica fewer — the ceiling to SHED above while a
        replica is being respawned, so recovery capacity isn't promised
        to new streams."""
        if self.planner is None:
            if degraded:
                # no planner: the pool's structural slot capacity is the
                # shed line — degraded admission is never unlimited
                pool = self.router.pool(n)
                return sum(r.num_slots for r in pool) if pool else None
            return None
        pool = self.router.pool(n)
        slots = sum(r.num_slots for r in pool)
        # sustained family: what the pool actually retires under churn,
        # not the optimistic mid-run peak
        e = max(r.num_slots for r in pool)
        if degraded:
            cap = self.planner.degraded_fleet_sessions_per_sec(
                n, e, replicas=len(pool)
            )
        else:
            cap = self.planner.fleet_sessions_per_sec(
                n, e, replicas=len(pool), sustained=True
            )
        return max(slots, math.ceil(cap * self.admit_window_s))

    # -- degraded mode -------------------------------------------------------

    @property
    def degraded(self) -> bool:
        return self._degraded

    def set_degraded(self, flag: bool) -> None:
        """Force degraded admission on/off (ops override; health-driven
        degradation is automatic per pool)."""
        self._degraded = bool(flag)

    def pool_degraded(self, n: int) -> bool:
        """True when pool N should shed: degraded mode forced, or any of
        its replicas reports non-healthy (a cheap local attribute — no
        RPC; the supervision layer stamps health on retry/death)."""
        if self._degraded:
            return True
        return any(
            getattr(r, "health", HEALTH_HEALTHY) != HEALTH_HEALTHY
            for r in self.router.pool(n)
        )

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        self._cond = asyncio.Condition()
        self._stopping = False
        self._exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="fleet-frontend"
        )
        self._pump_task = asyncio.create_task(self._pump())

    async def aclose(self) -> None:
        self._stopping = True
        if self._pump_task is not None:
            await self._pump_task
            self._pump_task = None
        if self._exec is not None:
            self._exec.shutdown(wait=True)
            self._exec = None
        self.router.close()

    async def __aenter__(self) -> "FleetFrontend":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    async def _call(self, fn, *args):
        """Run a router call on the serialized executor, retrying
        `ReplicaError` with capped exponential backoff. The router already
        fails dead replicas over synchronously; an error surviving that
        means recovery needs time (respawn, pool rebuild) — backoff gives
        it pump rounds instead of failing the client's first retry."""
        loop = asyncio.get_running_loop()
        delay = self.rpc_backoff_s
        attempt = 0
        while True:
            try:
                return await loop.run_in_executor(self._exec, fn, *args)
            except ReplicaError:
                attempt += 1
                if attempt > self.rpc_retries:
                    raise
                await asyncio.sleep(min(delay, self.rpc_backoff_max_s))
                delay *= 2

    async def _pump(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stopping:
            try:
                worked = await loop.run_in_executor(
                    self._exec, self.router.run_for, 1
                )
                finished = await loop.run_in_executor(
                    self._exec, self.router.results
                )
            except ReplicaError:
                # a replica failure the router could not absorb this round
                # (e.g. no respawn registered yet) must not kill the pump —
                # surviving pools keep serving; retry next round
                await asyncio.sleep(self.idle_sleep_s)
                continue
            if finished:
                async with self._cond:
                    self._results.update(finished)
                    for sid in finished:
                        n = self._sid_pool.pop(sid, None)
                        if n is not None:
                            self._inflight[n] -= 1
                    self._cond.notify_all()
            if not worked:
                # idle (everything drained or parked open streams): yield
                # so submitters/pushers get the loop, then poll again
                await asyncio.sleep(self.idle_sleep_s)

    # -- client verbs -------------------------------------------------------

    async def submit_stream(
        self,
        n: int,
        u_seq: np.ndarray,
        *,
        targets: Optional[np.ndarray] = None,
        readout=None,
        params=None,
        m0=None,
        collect_states: bool = True,
        learn_washout: int = 0,
        open: bool = False,
        sid: Optional[int] = None,
    ) -> int:
        """Admit one stream into the N-pool; returns its sid.

        Blocks (backpressure) while the pool is at its planner ceiling;
        raises AdmissionError when `max_waiters` submitters are already
        blocked on that pool."""
        if self._cond is None:
            raise RuntimeError("frontend not started — use `async with`")
        degraded = self.pool_degraded(n)
        limit = self.pool_limit(n, degraded=degraded)
        async with self._cond:
            if degraded and limit is not None and self._inflight.get(n, 0) >= limit:
                self.shed_streams += 1
                raise OverloadError(
                    n=n,
                    inflight=self._inflight.get(n, 0),
                    limit=limit,
                    reason=(
                        "degraded mode forced"
                        if self._degraded
                        else "replica unhealthy (failover in progress)"
                    ),
                )
            if (
                limit is not None
                and self.max_waiters is not None
                and self._inflight.get(n, 0) >= limit
                and self._waiters.get(n, 0) >= self.max_waiters
            ):
                raise AdmissionError(
                    f"pool N={n} at capacity ({limit} inflight, "
                    f"{self._waiters[n]} waiting); offered load exceeds the "
                    f"planned fleet — re-plan with CapacityModel.plan_fleet"
                )
            self._waiters[n] = self._waiters.get(n, 0) + 1
            try:
                while (
                    limit is not None and self._inflight.get(n, 0) >= limit
                ):
                    await self._cond.wait()
            finally:
                self._waiters[n] -= 1
            sid = self.router.next_sid() if sid is None else sid
            session = StreamSession(
                sid=sid,
                u_seq=u_seq,
                params=params,
                readout=readout,
                m0=m0,
                collect_states=collect_states,
                targets=targets,
                learn_washout=learn_washout,
                open=open,
            )
            await self._call(self.router.submit, n, session)
            self._inflight[n] = self._inflight.get(n, 0) + 1
            self._sid_pool[sid] = n
        return sid

    async def push_ticks(self, sid: int, u, targets=None) -> None:
        """Feed more rows to an open stream (affinity-routed; retried with
        backoff across a failover)."""
        await self._call(self.router.append_ticks, sid, u, targets)

    async def close_stream(self, sid: int) -> None:
        """Let an open stream finish once its pushed input is exhausted."""
        await self._call(self.router.close_session, sid)

    async def result(self, sid: int) -> SessionResult:
        """Await one stream's finished SessionResult."""
        async with self._cond:
            while sid not in self._results:
                await self._cond.wait()
            return self._results.pop(sid)

    async def drain_results(self) -> Dict[int, SessionResult]:
        """Await every inflight (non-open) stream, then hand back all
        finished results collected so far."""
        async with self._cond:
            while any(self._inflight.get(n, 0) > 0 for n in self._inflight):
                await self._cond.wait()
            out, self._results = self._results, {}
            return out

    def stats(self):
        """Live per-pool EngineStats (the planner's measured side)."""
        return self.router.stats()

    def fault_stats(self) -> dict:
        """Failover/quarantine counters (router + replicas) plus the
        streams this frontend shed while degraded."""
        d = self.router.fault_stats()
        d["shed_streams"] = self.shed_streams
        return d
