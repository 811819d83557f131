"""Fleet replica workers: one `ReservoirEngine` each, uniform RPC surface.

Two transports, one protocol:

- `LocalReplica` wraps the engine in-process — zero copy, deterministic,
  the transport for correctness tests and single-core hosts (where extra
  processes only add context switches).
- `ProcessReplica` spawns the engine into its own OS process and speaks
  the same protocol over a `multiprocessing` pipe. Commands are
  CHUNK-GRANULARITY: the parent says "run_for(k)" and the child advances
  up to k pipeline chunks before replying, so the pipe carries one small
  message per chunk, never per tick. `run_for_async`/`run_for_wait` split
  the round trip so a router can launch every replica's chunk first and
  collect second — on a multi-core host the children genuinely overlap.

Everything that crosses the pipe is host data, in both directions: numpy
arrays, scalars and CPU tensors. `submit` moves a session's tensors to the
CPU before it pickles it (`_host_session`: params, readout weights, m0 and
its spec); `SessionCheckpoint`s are built on the host, and
`SessionResult`s carry numpy and CPU tensors. So a session can be
submitted to either transport, checkpointed out of one replica and
restored into another — process boundaries included — bit-identically.
Messages go through the plain pickler (`_put` / `_take`): torch registers
reducers with multiprocessing's own pickler that would move every CPU
tensor of a message into a shared-memory segment of its own; the plain
pickler copies the tensor's bytes into the message.

On a card each child builds its engine on its own CUDA context (spawn, not
fork: a CUDA runtime does not survive a fork) and loads the kernel library
itself. `start_fleet` builds the library once in the parent and points
every child at that build directory, so no child runs nvcc. A child whose
engine fails to build, a CUDA out-of-memory included, answers the ready
handshake with an error and the parent raises `ReplicaError`; a child whose
kernel library fails to load raises on its first chunk, which the parent
relays as `ReplicaError`. Neither falls back to the CPU.

Supervision: every replica carries a health state, one of
`healthy | degraded | dead`. The process transport polls the pipe with a
deadline instead of blocking, checks the child's liveness each poll step,
and retries SEND-side failures with capped exponential backoff — a dead
or hung child raises `ReplicaError` (with the child's exit code when
known) instead of blocking the parent forever. Reply timeouts are NOT
retried: the pipe's replies are strictly ordered and the parent cannot
know whether a slow child executed the request, so resending would risk
double-executing a non-idempotent op. A reply timeout is terminal — the
replica is marked dead and the router fails the sessions over. Once a
retry fired, health degrades (sticky) so routers and the frontend can
shed load before the replica dies outright.

Fault injection: pass `faults=FaultPlan(...)` to either transport and the
scheduled events fire deterministically — crash/hang in the serving loop,
delay/drop on the parent's send path, NaN into a tenant's input at
submit (see `fleet/faults.py`).

The engine factory handed to a replica must be a module-level callable
(`make_engine` below is the default) because the spawn context pickles it
into the child.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import pickle
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.api import make_spec
from repro_torch.core.constants import STOParams
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.serve.fleet.faults import CRASH_EXIT_CODE, FaultPlan
from repro_torch.serve.reservoir import (
    EngineStats,
    ReservoirEngine,
    SessionCheckpoint,
    SessionResult,
    StreamSession,
    _spec_host,
)

HEALTH_HEALTHY = "healthy"
HEALTH_DEGRADED = "degraded"
HEALTH_DEAD = "dead"

# pipe poll step while awaiting a reply: short enough to notice a dead
# child quickly, long enough not to spin
_POLL_STEP_S = 0.05

# how long an injected hang sleeps in the child (far past any rpc
# deadline a test would configure; the parent kills the child on reap)
_HANG_SLEEP_S = 3600.0


class ReplicaError(RuntimeError):
    """A replica-level failure surfaced to the caller: an engine-side
    exception relayed over the transport, or the transport itself failing
    (dead child, hung child, exhausted send retries). `exit_code` carries
    the child's exit status when the failure was a death."""

    def __init__(self, message: str, exit_code: Optional[int] = None):
        super().__init__(message)
        self.exit_code = exit_code


def validate_supervision(
    rpc_timeout_s: Optional[float],
    rpc_retries: int,
    rpc_backoff_s: float,
) -> None:
    """Reject non-positive supervision knobs up front — a zero timeout or
    backoff silently degenerates to busy-spinning or instant death."""
    if rpc_timeout_s is not None and not rpc_timeout_s > 0:
        raise ValueError(f"rpc_timeout_s must be > 0 or None; got {rpc_timeout_s!r}")
    if not isinstance(rpc_retries, int) or isinstance(rpc_retries, bool) or rpc_retries < 0:
        raise ValueError(f"rpc_retries must be an int >= 0; got {rpc_retries!r}")
    if not rpc_backoff_s > 0:
        raise ValueError(f"rpc_backoff_s must be > 0; got {rpc_backoff_s!r}")


def make_engine(
    n: int = 16,
    num_slots: int = 8,
    n_in: int = 1,
    hold_steps: int = 5,
    seed: int = 0,
    backend: str = "auto",
    chunk_ticks: int = 8,
    n_out: int = 1,
    learn: Optional[str] = None,
    precision: Optional[str] = None,
    autoscale: bool = False,
    min_slots: Optional[int] = None,
    max_slots: Optional[int] = None,
    compilation_cache_dir: Optional[str] = None,
    device="cuda",
) -> ReservoirEngine:
    """Default replica engine factory (module-level: pickles into spawn).

    Builds the spec with `make_spec(n, n_in, seed, hold_steps)` in f32 on
    `device` (the reference's `make_reservoir` draws the same W^cp and W^in
    from the same seeds). The engine's template route draws from the
    process-wide PlanCache, so local replicas of one config share a single
    CompiledSim; process replicas each compile in their own process —
    point `compilation_cache_dir` at a directory that holds the kernel
    library and they load it from there without running nvcc, which is
    what `start_fleet(transport="process")` arranges on a card."""
    spec = make_spec(n, n_in, seed, hold_steps=hold_steps, dtype=torch.float32, device=device)
    return ReservoirEngine(
        spec,
        num_slots=num_slots,
        backend=backend,
        chunk_ticks=chunk_ticks,
        n_out=n_out,
        learn=learn,
        precision=precision,
        autoscale=autoscale or None,
        min_slots=min_slots,
        max_slots=max_slots,
        compilation_cache_dir=compilation_cache_dir,
        device=device,
    )


def _cpu(x):
    """A tensor on the CPU (other values as they are)."""
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _host_session(session: StreamSession) -> StreamSession:
    """A copy of `session` whose every tensor lies on the CPU (params,
    readout weights, m0, the learn resume, its spec), so that it pickles
    into a child without CUDA storage. The caller's session is untouched."""
    readout = session.readout
    if readout is not None:
        readout = readout._replace(w_out=_cpu(readout.w_out))
    params = session.params
    if params is not None:
        params = STOParams(*(_cpu(torch.as_tensor(x)) for x in params))
    return dataclasses.replace(
        session,
        u_seq=_cpu(session.u_seq),
        targets=_cpu(session.targets),
        params=params,
        readout=readout,
        m0=_cpu(session.m0),
        learn_w0=_cpu(session.learn_w0),
        learn_P0=_cpu(session.learn_P0),
        spec=_spec_host(session.spec),
    )


class LocalReplica:
    """In-process replica: the engine lives on this event loop/thread."""

    transport = "local"

    def __init__(self, factory=make_engine, faults: Optional[FaultPlan] = None, **engine_kw):
        self.engine = factory(**engine_kw)
        self.n = self.engine.res.n
        self.num_slots = self.engine.num_slots
        # live sessions this replica currently owns (admission signal for
        # the router's least-loaded placement)
        self.pending = 0
        self._last_worked = False
        self.health = HEALTH_HEALTHY
        self.rpc_retries_total = 0  # uniform with ProcessReplica (always 0)
        # local transport has no pipe: crash/hang both fail-stop, nan
        # poisons at submit, delay/drop are process-transport faults
        self._faults = faults.runtime() if faults is not None else None

    def _check_alive(self) -> None:
        if self.health == HEALTH_DEAD:
            raise ReplicaError(
                "replica is dead (injected crash)", exit_code=CRASH_EXIT_CODE
            )

    def _die(self) -> None:
        self.health = HEALTH_DEAD
        self.engine = None  # the "process" is gone; drop its state with it
        raise ReplicaError(
            "injected crash (local transport)", exit_code=CRASH_EXIT_CODE
        )

    # -- session lifecycle --------------------------------------------------

    def submit(self, session: StreamSession) -> None:
        self._check_alive()
        if self._faults is not None:
            self._faults.poison_session(session)
        self.engine.submit(session)
        self.pending += 1

    def append_ticks(self, sid, u, targets=None) -> None:
        self._check_alive()
        self.engine.append_ticks(sid, u, targets)

    def close_session(self, sid) -> None:
        self._check_alive()
        self.engine.close_session(sid)

    def checkpoint_session(self, sid) -> SessionCheckpoint:
        self._check_alive()
        ckpt = self.engine.checkpoint_session(sid)
        self.pending -= 1
        return ckpt

    def restore_session(self, ckpt: SessionCheckpoint) -> None:
        self._check_alive()
        self.engine.restore_session(ckpt)
        self.pending += 1

    def snapshot(self) -> List[SessionCheckpoint]:
        """Non-destructive checkpoints of every live session (failover)."""
        self._check_alive()
        return self.engine.snapshot_sessions()

    # -- serving ------------------------------------------------------------

    def run_for(self, max_chunks: int = 1) -> bool:
        """Advance up to max_chunks pipeline chunks; True if any ran."""
        self._check_alive()
        worked = False
        for _ in range(max_chunks):
            if self._faults is not None and self._faults.on_chunk() in ("crash", "hang"):
                self._die()
            if not self.engine.step_chunk():
                break
            worked = True
        return worked

    # split-phase pump (uniform with ProcessReplica; local = immediate)
    def run_for_async(self, max_chunks: int = 1) -> None:
        self._last_worked = self.run_for(max_chunks)

    def run_for_wait(self) -> bool:
        return self._last_worked

    def results(self) -> List[SessionResult]:
        self._check_alive()
        out = list(self.engine.pop_results().values())
        self.pending -= len(out)
        return out

    def stats(self) -> EngineStats:
        self._check_alive()
        st = self.engine.stats()
        st.health = self.health
        return st

    def prewarm(self) -> None:
        """Warm-start: warm the serving plan (one masked chunk) and the
        adjacent autoscale buckets before traffic arrives — the router calls
        this on a migration destination so a restored session's first chunk
        pays no first dispatch."""
        self._check_alive()
        self.engine.prewarm(block=True)

    def close(self) -> None:
        self.health = HEALTH_DEAD


# ---------------------------------------------------------------------------
# process transport
# ---------------------------------------------------------------------------


def _put(conn, msg) -> None:
    """Send one message through the plain pickler (see the module
    docstring)."""
    conn.send_bytes(pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL))


def _take(conn):
    """Receive one message `_put` sent (only this module's processes write
    to the pipe)."""
    return pickle.loads(conn.recv_bytes())


def _child_main(
    conn,
    factory,
    engine_kw: Dict[str, Any],
    fault_plan: Optional[FaultPlan] = None,
) -> None:
    """Replica child: build the engine, answer one reply per command."""
    faults = fault_plan.runtime() if fault_plan is not None else None
    try:
        engine = factory(**engine_kw)
        _put(conn, ("ok", None))  # ready handshake (after torch import/compile)
    except Exception as e:  # noqa: BLE001 — report, don't die silently
        _put(conn, ("err", f"{type(e).__name__}: {e}"))
        return
    while True:
        op, *args = _take(conn)
        try:
            if op == "run_for":
                worked = False
                for _ in range(args[0]):
                    if faults is not None:
                        action = faults.on_chunk()
                        if action == "crash":
                            conn.close()
                            os._exit(CRASH_EXIT_CODE)
                        if action == "hang":
                            time.sleep(_HANG_SLEEP_S)
                    if not engine.step_chunk():
                        break
                    worked = True
                _put(conn, ("ok", worked))
            elif op == "submit":
                if faults is not None:
                    faults.poison_session(args[0])
                engine.submit(args[0])
                _put(conn, ("ok", None))
            elif op == "results":
                _put(conn, ("ok", list(engine.pop_results().values())))
            elif op == "append":
                engine.append_ticks(*args)
                _put(conn, ("ok", None))
            elif op == "close_session":
                engine.close_session(args[0])
                _put(conn, ("ok", None))
            elif op == "checkpoint":
                _put(conn, ("ok", engine.checkpoint_session(args[0])))
            elif op == "restore":
                engine.restore_session(args[0])
                _put(conn, ("ok", None))
            elif op == "snapshot":
                _put(conn, ("ok", engine.snapshot_sessions()))
            elif op == "stats":
                _put(conn, ("ok", engine.stats()))
            elif op == "prewarm":
                engine.prewarm(block=True)
                _put(conn, ("ok", None))
            elif op == "stop":
                _put(conn, ("ok", None))
                return
            else:
                _put(conn, ("err", f"unknown op {op!r}"))
        except Exception as e:  # noqa: BLE001 — RPC error channel
            _put(conn, ("err", f"{type(e).__name__}: {e}"))


class ProcessReplica:
    """A replica in its own OS process, driven over a pipe.

    Spawn (not fork): neither a CUDA runtime nor torch's thread pools
    survive forking, and spawn gives the child a clean import, its own card
    context and its own intra-op threads. Construction blocks until the
    child's engine is built — callers should start several replicas before
    waiting if they want the builds to overlap (see `start_fleet`).

    Supervision knobs:
      rpc_timeout_s  deadline for a reply once a request is on the pipe
                     (None = wait for the child as long as it stays
                     alive; a death is still detected immediately).
      rpc_retries    max re-sends of a request that failed to go out
                     (injected drop / transient send failure). Replies
                     are never re-requested — see module docstring.
      rpc_backoff_s  initial backoff between send retries (doubles per
                     attempt, capped at 1s)."""

    transport = "process"

    def __init__(
        self,
        factory=make_engine,
        _defer_ready: bool = False,
        rpc_timeout_s: Optional[float] = 120.0,
        rpc_retries: int = 3,
        rpc_backoff_s: float = 0.05,
        faults: Optional[FaultPlan] = None,
        **engine_kw,
    ):
        validate_supervision(rpc_timeout_s, rpc_retries, rpc_backoff_s)
        self.rpc_timeout_s = rpc_timeout_s
        self.rpc_retries = rpc_retries
        self.rpc_backoff_s = rpc_backoff_s
        self.rpc_retries_total = 0
        self.health = HEALTH_HEALTHY
        self._faults = faults.runtime() if faults is not None else None
        ctx = mp.get_context("spawn")
        self._conn, child_conn = ctx.Pipe()
        self._proc = ctx.Process(
            target=_child_main,
            args=(child_conn, factory, engine_kw, faults),
            daemon=True,
        )
        self._proc.start()
        child_conn.close()
        self.n = engine_kw.get("n", 16)
        self.num_slots = engine_kw.get("num_slots", 8)
        self.pending = 0
        self._ready = False
        if not _defer_ready:
            self.wait_ready()

    def wait_ready(self) -> None:
        if not self._ready:
            # no deadline: engine builds legitimately take long (torch
            # import, a card context, a plan compile), but a child that
            # dies building still raises immediately via the liveness poll
            self._recv(timeout=None, op="ready")
            self._ready = True

    # -- supervised transport ------------------------------------------------

    def _die(self, reason: str, exit_code: Optional[int] = None) -> None:
        """Mark this replica dead and surface the failure. The child (if
        still running — e.g. hung) is left for `close()` to reap; callers
        route through `FleetRouter._reap` which calls it."""
        self.health = HEALTH_DEAD
        raise ReplicaError(reason, exit_code=exit_code)

    def _send(self, msg: Tuple, op: str) -> None:
        """Put one request on the pipe, retrying send-side failures
        (injected drops, transient pipe errors) with capped exponential
        backoff. Safe to retry: a request that never reached the pipe
        cannot have been executed."""
        if self.health == HEALTH_DEAD:
            raise ReplicaError(f"replica is dead; cannot send {op!r}")
        attempt = 0
        while True:
            dropped = False
            if self._faults is not None:
                dropped, delay = self._faults.before_send(op)
                if delay > 0:
                    time.sleep(delay)
            if not dropped:
                try:
                    _put(self._conn, msg)
                    return
                except (BrokenPipeError, OSError):
                    if not self._proc.is_alive():
                        self._die(
                            f"replica child died before {op!r} was sent "
                            f"(exit code {self._proc.exitcode})",
                            exit_code=self._proc.exitcode,
                        )
                    # transient: fall through to the retry path
                    dropped = True
            attempt += 1
            self.rpc_retries_total += 1
            if self.health == HEALTH_HEALTHY:
                self.health = HEALTH_DEGRADED  # sticky: a retry happened
            if attempt > self.rpc_retries:
                self._die(
                    f"rpc {op!r} failed to send after {attempt} attempts "
                    f"(retry budget {self.rpc_retries} exhausted)"
                )
            time.sleep(min(self.rpc_backoff_s * (2 ** (attempt - 1)), 1.0))

    def _recv(self, timeout: Optional[float], op: str):
        """Await one reply, polling so a dead child is detected instead of
        blocking forever; a live-but-silent child past `timeout` is hung
        and equally terminal (the reply stream is ordered, so a late
        reply could never be matched to a new request safely)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            step = _POLL_STEP_S
            if deadline is not None:
                step = max(0.0, min(step, deadline - time.monotonic()))
            try:
                if self._conn.poll(step):
                    status, payload = _take(self._conn)
                    if status == "err":
                        raise ReplicaError(payload)
                    return payload
            except (EOFError, OSError) as e:
                self._proc.join(timeout=1.0)
                self._die(
                    f"replica pipe closed mid-{op} "
                    f"(exit code {self._proc.exitcode}): {e}",
                    exit_code=self._proc.exitcode,
                )
            if not self._proc.is_alive():
                if self._conn.poll(0):
                    continue  # reply landed just before the exit; drain it
                self._die(
                    f"replica child died mid-{op} "
                    f"(exit code {self._proc.exitcode})",
                    exit_code=self._proc.exitcode,
                )
            if deadline is not None and time.monotonic() >= deadline:
                self._die(
                    f"rpc {op!r} timed out after {timeout:.1f}s: "
                    f"child alive but unresponsive (hung)"
                )

    def _rpc(self, op: str, *args):
        self._send((op, *args), op)
        return self._recv(self.rpc_timeout_s, op)

    # -- session lifecycle --------------------------------------------------

    def submit(self, session: StreamSession) -> None:
        self._rpc("submit", _host_session(session))
        self.pending += 1

    def append_ticks(self, sid, u, targets=None) -> None:
        self._rpc("append", sid, _cpu(u), _cpu(targets))

    def close_session(self, sid) -> None:
        self._rpc("close_session", sid)

    def checkpoint_session(self, sid) -> SessionCheckpoint:
        ckpt = self._rpc("checkpoint", sid)
        self.pending -= 1
        return ckpt

    def restore_session(self, ckpt: SessionCheckpoint) -> None:
        self._rpc("restore", ckpt)
        self.pending += 1

    def snapshot(self) -> List[SessionCheckpoint]:
        """Non-destructive checkpoints of every live session (failover)."""
        return self._rpc("snapshot")

    # -- serving ------------------------------------------------------------

    def run_for(self, max_chunks: int = 1) -> bool:
        return self._rpc("run_for", max_chunks)

    def run_for_async(self, max_chunks: int = 1) -> None:
        self._send(("run_for", max_chunks), "run_for")

    def run_for_wait(self) -> bool:
        return self._recv(self.rpc_timeout_s, "run_for")

    def results(self) -> List[SessionResult]:
        out = self._rpc("results")
        self.pending -= len(out)
        return out

    def stats(self) -> EngineStats:
        st = self._rpc("stats")
        st.health = self.health
        return st

    def prewarm(self) -> None:
        """Warm-start the child's engine (see LocalReplica.prewarm)."""
        self._rpc("prewarm")

    def close(self) -> None:
        """Stop the child, escalating stop → terminate → kill so no zombie
        survives (join() after each signal reaps the process entry)."""
        if self._proc.is_alive() and self.health != HEALTH_DEAD:
            try:
                _put(self._conn, ("stop",))
            except (BrokenPipeError, OSError):
                pass
            self._proc.join(timeout=5)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(timeout=5)
        try:
            self._conn.close()
        except OSError:
            pass
        self.health = HEALTH_DEAD


def _share_kernel_library(engine_kw: Dict[str, Any]) -> Dict[str, Any]:
    """For process replicas on a card: build the kernel library once, here
    in the parent, into the directory every child will load it from (the
    engine's `compilation_cache_dir`, else this process's build directory),
    and point the children at it. No child then runs nvcc, and R children
    do not compile the same sources at once. CPU replicas need no library."""
    if resolve_device(engine_kw.get("device", "cuda")).type != "cuda":
        return engine_kw
    directory = os.path.abspath(str(engine_kw.get("compilation_cache_dir") or _build.BUILD_DIR))
    _build.build(directory)
    return {**engine_kw, "compilation_cache_dir": directory}


def start_fleet(
    count: int,
    transport: str = "local",
    factory=make_engine,
    faults: Optional[FaultPlan] = None,
    rpc_timeout_s: Optional[float] = 120.0,
    rpc_retries: int = 3,
    rpc_backoff_s: float = 0.05,
    **engine_kw,
) -> List[Any]:
    """Start `count` replicas of one engine config. Process replicas are
    all spawned before any ready-handshake is awaited, so their imports and
    engine builds overlap instead of serializing; on a card they share one
    kernel library that the parent built (`_share_kernel_library`). A
    `faults` plan, if given, is threaded into EVERY replica (build
    per-replica plans by constructing replicas directly)."""
    if transport == "local":
        return [LocalReplica(factory, faults=faults, **engine_kw) for _ in range(count)]
    if transport == "process":
        engine_kw = _share_kernel_library(engine_kw)
        reps = [
            ProcessReplica(
                factory,
                _defer_ready=True,
                rpc_timeout_s=rpc_timeout_s,
                rpc_retries=rpc_retries,
                rpc_backoff_s=rpc_backoff_s,
                faults=faults,
                **engine_kw,
            )
            for _ in range(count)
        ]
        for r in reps:
            r.wait_ready()
        return reps
    raise ValueError(f"transport must be 'local' or 'process'; got {transport!r}")
