"""Session router for the fleet tier: per-bucket pools + sticky affinity.

Placement happens at TWO granularities, and the split is the point:

- POOLS are keyed by reservoir size N. A replica only ever serves one
  compiled spec, so an N=16 tenant physically cannot queue behind an
  N=1024 tenant — head-of-line isolation is structural, not scheduled.
- WITHIN a pool, a new session goes to the least-loaded replica (live
  `pending` count), and every later interaction with that session —
  pushed ticks, close, results — follows the AFFINITY map to the replica
  that owns its slot state.

Affinity is sticky but not permanent: `migrate(sid)` checkpoints the
session out of its replica (`ReservoirEngine.checkpoint_session`, which
snapshots the SlotStore magnetization column and in-flight RLS P/Wl
lanes) and restores it into another, after which the stream continues
bit-identically — the mechanism behind drain-for-maintenance and
rebalancing, and it works across process transports because checkpoints
are host data only (numpy, and params as 0-d CPU tensors).

FAILOVER rides the same checkpoint machinery, automatically. With
`checkpoint_every=k` the router keeps a PARENT-SIDE checkpoint of every
live session: an initial t=0 checkpoint at submit, refreshed by a
non-destructive `snapshot()` of every replica each k pump rounds, plus a
replay buffer of ticks pushed since the last snapshot. When a replica is
detected dead (its transport raises `ReplicaError` with
health == "dead" — child exited, hung past the RPC deadline, or send
retries exhausted), `_reap` removes it from the pool, reaps the process,
respawns a replacement through the registered factory (warm via the
process-wide PlanCache, or a process replica loading the kernel library
its fleet built), restores every checkpointed session the dead
replica owned — in-flight RLS/LMS lanes included — and replays the
buffered ticks. Because checkpoint/restore is bit-exact and the replay
re-offers exactly the rows the checkpoint had not yet seen, a recovered
stream's full output is bit-identical to an uninterrupted run (scan
backend; tests/test_torch_fleet_faults.py pins predictions AND learned
weights). Without `checkpoint_every`, a death still reaps the replica
but its sessions are lost (counted in `fault_stats`).

The router is transport-agnostic and synchronous; `fleet.frontend` wraps
it in asyncio and adds planner-driven admission control.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.constants import STOParams
from repro_torch.serve.reservoir import (
    SessionCheckpoint,
    SessionResult,
    StreamSession,
    _spec_host,
)
from repro_torch.serve.state_store import _host

from .planner import CapacityModel
from .replica import HEALTH_DEAD, ReplicaError


@dataclasses.dataclass
class FleetFaultStats:
    """Failover observability counters, accumulated by the router."""

    replica_deaths: int = 0  # replicas reaped after a detected death
    failovers: int = 0  # reap events that recovered at least one session
    sessions_recovered: int = 0  # sessions restored from a parent-side ckpt
    sessions_lost: int = 0  # orphans with no checkpoint / no live pool
    replayed_ticks: int = 0  # buffered push rows re-applied after restore
    rpc_retries: int = 0  # send retries accumulated from reaped replicas

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _initial_checkpoint(session: StreamSession) -> SessionCheckpoint:
    """A t=0 checkpoint synthesized host-side from a session ABOUT to be
    submitted — the failover floor until the first periodic snapshot
    lands. Copies every array the engine (or the tenant) could later
    mutate, so the checkpoint is immune to both. Host data only, as the
    engine's own checkpoints: params as 0-d CPU tensors, the readout
    weights as numpy (from a tensor that may live on the card), the spec
    through `_spec_host`."""
    u = np.array(_host(session.u_seq), copy=True)
    targets = None if session.targets is None else np.array(_host(session.targets), copy=True)
    readout_w = None
    washout = 0
    if session.readout is not None:
        readout_w = np.array(_host(session.readout.w_out), copy=True)
        washout = session.readout.washout
    if readout_w is not None:
        n_out = int(readout_w.shape[1])
    elif targets is not None and targets.ndim == 2:
        n_out = int(targets.shape[1])
    else:
        n_out = 1
    params = None
    if session.params is not None:
        params = STOParams(
            *(torch.as_tensor(x).detach().cpu().clone() for x in session.params)
        )
    return SessionCheckpoint(
        sid=session.sid,
        u_seq=u,
        t=0,
        m=None if session.m0 is None else np.array(_host(session.m0), copy=True),
        params=params,
        readout_w=readout_w,
        readout_washout=washout,
        collect_states=session.collect_states,
        targets=targets,
        learn_washout=session.learn_washout,
        open=session.open,
        n_out=n_out,
        states=None,
        outs=None,
        preds=None,
        P=None if session.learn_P0 is None else np.array(_host(session.learn_P0), copy=True),
        Wl=None if session.learn_w0 is None else np.array(_host(session.learn_w0), copy=True),
        spec=_spec_host(session.spec),
    )


class FleetRouter:
    def __init__(
        self,
        planner: Optional[CapacityModel] = None,
        checkpoint_every: Optional[int] = None,
    ):
        if checkpoint_every is not None and (
            not isinstance(checkpoint_every, int)
            or isinstance(checkpoint_every, bool)
            or checkpoint_every < 1
        ):
            raise ValueError(
                f"checkpoint_every must be an int >= 1 (pump rounds between "
                f"fleet snapshots) or None to disable failover; got "
                f"{checkpoint_every!r}"
            )
        self.planner = planner
        self.checkpoint_every = checkpoint_every
        self.pools: Dict[int, List] = {}  # reservoir size N -> replicas
        self._affinity: Dict[int, object] = {}  # sid -> owning replica
        self._sids = itertools.count(1)
        self.faults = FleetFaultStats()
        # failover state, all PARENT side so it survives replica death:
        # sid -> last checkpoint; sid -> ticks pushed since that checkpoint
        self._ckpts: Dict[int, SessionCheckpoint] = {}
        self._replay: Dict[int, List[Tuple[np.ndarray, Optional[np.ndarray]]]] = {}
        self._respawn: Dict[object, Callable[[], object]] = {}
        self._rounds = 0

    # -- fleet membership ---------------------------------------------------

    def add_replica(self, replica, respawn: Optional[Callable[[], object]] = None) -> None:
        """Register a replica; `respawn` is a zero-arg factory the failover
        path calls to build its replacement (same config — typically a
        `start_fleet(1, ...)` or replica-constructor closure). Replacement
        engines draw from the process-wide PlanCache, so respawn after a
        death is warm, not a cold compile."""
        self.pools.setdefault(replica.n, []).append(replica)
        if respawn is not None:
            self._respawn[replica] = respawn

    def replicas(self) -> List:
        return [r for pool in self.pools.values() for r in pool]

    def pool(self, n: int) -> List:
        if n not in self.pools:
            raise KeyError(
                f"no replica pool for reservoir size N={n}; pools exist for "
                f"{sorted(self.pools)}"
            )
        return self.pools[n]

    @staticmethod
    def _is_dead(replica) -> bool:
        return getattr(replica, "health", None) == HEALTH_DEAD

    # -- placement ----------------------------------------------------------

    def next_sid(self) -> int:
        return next(self._sids)

    def select(self, n: int):
        """Least-loaded replica in the N-pool (live pending count)."""
        pool = self.pool(n)
        if not pool:
            raise ReplicaError(f"pool N={n} has no live replicas")
        return min(pool, key=lambda r: r.pending)

    def submit(self, n: int, session: StreamSession):
        """Place a session in the N-pool; returns the owning replica. With
        failover enabled the session's t=0 checkpoint is taken BEFORE the
        replica sees it, so even a replica that dies on its very first
        chunk loses nothing. A placement that lands on a dying replica
        fails over and retries on the survivors."""
        if session.sid in self._affinity:
            raise ValueError(f"sid {session.sid} is already being served")
        if self.checkpoint_every is not None:
            self._ckpts[session.sid] = _initial_checkpoint(session)
        while True:
            replica = self.select(n)
            try:
                replica.submit(session)
            except ReplicaError:
                if self._is_dead(replica):
                    self._reap(replica)
                    continue
                if self.checkpoint_every is not None:
                    self._ckpts.pop(session.sid, None)
                raise
            self._affinity[session.sid] = replica
            return replica

    def replica_for(self, sid: int):
        try:
            return self._affinity[sid]
        except KeyError:
            raise KeyError(f"no live session with sid {sid}") from None

    # -- per-session forwarding (affinity-routed) ---------------------------

    def append_ticks(self, sid: int, u, targets=None) -> None:
        replica = self.replica_for(sid)
        try:
            replica.append_ticks(sid, u, targets)
        except ReplicaError:
            if not self._is_dead(replica):
                raise
            # the owner died under this push: fail its sessions over, then
            # re-offer the rows to the recovered owner (the dead child
            # never applied them — its last checkpoint predates this call)
            self._reap(replica)
            self.replica_for(sid).append_ticks(sid, u, targets)
        if self.checkpoint_every is not None and sid in self._ckpts:
            self._replay.setdefault(sid, []).append(
                (
                    np.array(_host(u), copy=True),
                    None if targets is None else np.array(_host(targets), copy=True),
                )
            )

    def close_session(self, sid: int) -> None:
        replica = self.replica_for(sid)
        try:
            replica.close_session(sid)
        except ReplicaError:
            if not self._is_dead(replica):
                raise
            self._reap(replica)
            self.replica_for(sid).close_session(sid)
        if self.checkpoint_every is not None and sid in self._ckpts:
            # the recovery path must not resurrect the stream as open
            self._ckpts[sid] = dataclasses.replace(self._ckpts[sid], open=False)

    def migrate(self, sid: int, dst=None):
        """Move a live session to another replica in its pool (or to an
        explicit `dst`, which may live in a different process). The
        checkpoint/restore round trip is bit-exact, so the tenant sees one
        uninterrupted stream. Returns the destination replica."""
        src = self.replica_for(sid)
        if dst is None:
            others = [r for r in self.pool(src.n) if r is not src]
            if not others:
                raise ValueError(
                    f"pool N={src.n} has no other replica to migrate sid "
                    f"{sid} to"
                )
            dst = min(others, key=lambda r: r.pending)
        if dst is src:
            return src
        # warm-start the destination BEFORE moving the stream: dst's hot
        # path (and adjacent autoscale buckets) compile and warm through the
        # shared plan cache now, so the restored session's next chunk pays
        # no first dispatch mid-migration.
        # getattr-guarded: third-party replica objects without prewarm
        # migrate exactly as before.
        dst_prewarm = getattr(dst, "prewarm", None)
        if dst_prewarm is not None:
            dst_prewarm()
        try:
            ckpt = src.checkpoint_session(sid)
        except ReplicaError:
            if not self._is_dead(src):
                raise
            # the source died under us — failover already moves the
            # session (from its last parent-side checkpoint)
            self._reap(src)
            return self._affinity.get(sid)
        dst.restore_session(ckpt)
        self._affinity[sid] = dst
        return dst

    # -- failover -----------------------------------------------------------

    def snapshot(self) -> int:
        """Refresh the parent-side checkpoint of every live session via a
        non-destructive `snapshot()` RPC to each replica (sessions keep
        serving, bit-identically). Returns the number of sessions
        checkpointed. Called automatically every `checkpoint_every` pump
        rounds; callable explicitly for a pre-maintenance fence."""
        count = 0
        for r in list(self.replicas()):
            try:
                ckpts = r.snapshot()
            except ReplicaError:
                if self._is_dead(r):
                    self._reap(r)
                    continue
                raise
            for ckpt in ckpts:
                if self._affinity.get(ckpt.sid) is r:
                    self._ckpts[ckpt.sid] = ckpt
                    # rows pushed before this snapshot are inside its u_seq
                    # (append_ticks applies to the engine first): buffer resets
                    self._replay.pop(ckpt.sid, None)
                    count += 1
        return count

    def _reap(self, replica) -> None:
        """Handle a detected replica death: remove it from its pool, reap
        the child (terminate-then-join — no zombies), respawn a
        replacement through the registered factory, and restore every
        session the dead replica owned from its parent-side checkpoint,
        replaying ticks buffered since. Sessions without a checkpoint
        (failover disabled) or without a surviving pool are counted lost."""
        self.faults.replica_deaths += 1
        self.faults.rpc_retries += getattr(replica, "rpc_retries_total", 0)
        pool = self.pools.get(replica.n, [])
        if replica in pool:
            pool.remove(replica)
        respawn = self._respawn.pop(replica, None)
        try:
            replica.close()
        except Exception:  # noqa: BLE001 — reaping a corpse; nothing to save
            pass
        replacement = None
        if respawn is not None:
            replacement = respawn()
            self.add_replica(replacement, respawn=respawn)
        orphans = [sid for sid, r in self._affinity.items() if r is replica]
        if not orphans:
            return
        recovered = 0
        warmed = set()
        for sid in orphans:
            ckpt = self._ckpts.get(sid)
            dst = None
            pool_now = self.pools.get(replica.n, [])
            if ckpt is not None and pool_now:
                dst = (
                    replacement
                    if replacement is not None
                    else min(pool_now, key=lambda r: r.pending)
                )
            if dst is None:
                self._affinity.pop(sid, None)
                self._ckpts.pop(sid, None)
                self._replay.pop(sid, None)
                self.faults.sessions_lost += 1
                continue
            if id(dst) not in warmed:
                dst_prewarm = getattr(dst, "prewarm", None)
                if dst_prewarm is not None:
                    dst_prewarm()
                warmed.add(id(dst))
            # rows pushed after the checkpoint but before a close_session
            # still have to land: restore as open, replay, then re-close
            rows = self._replay.get(sid, ())
            reopen = bool(rows) and not ckpt.open
            dst.restore_session(
                dataclasses.replace(ckpt, open=True) if reopen else ckpt
            )
            for u, targets in rows:
                dst.append_ticks(sid, u, targets)
                self.faults.replayed_ticks += int(np.shape(u)[0]) if np.ndim(u) else 1
            if reopen:
                dst.close_session(sid)
            self._affinity[sid] = dst
            recovered += 1
        self.faults.sessions_recovered += recovered
        if recovered:
            self.faults.failovers += 1

    # -- serving ------------------------------------------------------------

    def run_for(self, max_chunks: int = 1) -> bool:
        """One overlapped pump round: LAUNCH max_chunks on every replica,
        then collect. Process replicas genuinely run their chunks in
        parallel between the send and recv phases; local replicas execute
        inline. True while any replica still has work. A replica that dies
        in either phase is reaped (and its sessions failed over) after the
        survivors' round completes."""
        self._rounds += 1
        if (
            self.checkpoint_every is not None
            and self._rounds % self.checkpoint_every == 0
        ):
            self.snapshot()
        reps = self.replicas()
        dead: List = []
        for r in reps:
            try:
                r.run_for_async(max_chunks)
            except ReplicaError:
                if not self._is_dead(r):
                    raise
                dead.append(r)
        worked = False
        for r in reps:
            if any(r is d for d in dead):
                continue
            try:
                worked = r.run_for_wait() or worked
            except ReplicaError:
                if not self._is_dead(r):
                    raise
                dead.append(r)
        for r in dead:
            self._reap(r)
            worked = True  # recovered sessions still need serving
        return worked

    def results(self) -> Dict[int, SessionResult]:
        """Drain finished results from every replica; affinity entries (and
        failover checkpoints) for finished sessions are released."""
        out: Dict[int, SessionResult] = {}
        for r in list(self.replicas()):
            try:
                batch = r.results()
            except ReplicaError:
                if self._is_dead(r):
                    self._reap(r)
                    continue
                raise
            for res in batch:
                out[res.sid] = res
                self._affinity.pop(res.sid, None)
                self._ckpts.pop(res.sid, None)
                self._replay.pop(res.sid, None)
        return out

    def drain(self, max_rounds: int = 100_000) -> Dict[int, SessionResult]:
        """Pump until no replica has work; returns everything that
        finished. Open (push) streams idle rather than finish — they stay
        resident and keep their affinity."""
        out = self.results()
        for _ in range(max_rounds):
            if not self.run_for(1):
                break
            out.update(self.results())
        out.update(self.results())
        return out

    # -- observability ------------------------------------------------------

    def stats(self) -> Dict[int, List]:
        """Pool -> per-replica EngineStats, the live side of the planner's
        predicted-vs-measured comparison."""
        out: Dict[int, List] = {}
        for n in list(self.pools):
            col = []
            for r in list(self.pools[n]):
                try:
                    col.append(r.stats())
                except ReplicaError:
                    if self._is_dead(r):
                        self._reap(r)
                        continue
                    raise
            out[n] = col
        return out

    def fault_stats(self) -> dict:
        """Failover/quarantine counters: the router's own recovery tally
        plus live-replica send retries and engine-side quarantined lanes
        (the latter via a stats round trip)."""
        d = self.faults.to_dict()
        d["rpc_retries"] += sum(
            getattr(r, "rpc_retries_total", 0) for r in self.replicas()
        )
        quarantined = 0
        for col in self.stats().values():
            quarantined += sum(st.quarantined_lanes for st in col)
        d["quarantined_lanes"] = quarantined
        return d

    def close(self) -> None:
        for r in self.replicas():
            r.close()
        self._ckpts.clear()
        self._replay.clear()
        self._respawn.clear()
