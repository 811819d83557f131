"""Fault tolerance of the port's fleet on the CPU: supervision, failover,
quarantine, and the fault harness; then each against the reference's.

Restates tests/test_fleet_faults.py on the port with the reference's
ENGINE_KW (n = 10, 4 slots, hold 6, seed 3, scan, K = 5) and device="cpu".
The recovery contract is the migration contract under fire: a session
whose replica is killed, hung, or starved mid-stream comes back
BIT-IDENTICAL — states, predictions, and in-flight learned readout weights
all equal to the same stream served by one unmolested scan engine of the
port. Every failure is injected deterministically through
`repro_torch.serve.fleet.faults`. The NaN tests pin the blast radius:
quarantining a poisoned tenant moves no bit of any co-tenant's output.

Against the reference (repro.serve.fleet): a crash failover plan gives the
same `fault_stats()` dict, and the same over-limit submit in degraded mode
raises OverloadError with the same `to_dict()`.

Four cases spawn process replicas (children that import torch); each
carries its own rpc_timeout_s.
"""

import asyncio
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro.serve import fleet as jfleet
from repro_torch.serve import fleet
from repro.serve.reservoir import StreamSession as JSession
from repro_torch.api import make_spec
from repro_torch.serve.fleet import (
    CRASH_EXIT_CODE,
    Fault,
    FaultPlan,
    FleetFrontend,
    FleetRouter,
    HEALTH_DEAD,
    HEALTH_DEGRADED,
    HEALTH_HEALTHY,
    LocalReplica,
    OverloadError,
    ProcessReplica,
    ReplicaError,
    validate_supervision,
)
from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

torch.set_num_threads(2)

# same tiny deterministic config as test_torch_fleet: scan is the bit-exact oracle
ENGINE_KW = dict(
    n=10, num_slots=4, hold_steps=6, seed=3, backend="scan", chunk_ticks=5, device="cpu"
)
LEARN_KW = dict(ENGINE_KW, learn="rls")


def _stream(rng, t=23, n_in=1):
    return rng.uniform(0.0, 0.5, size=(t, n_in)).astype(np.float32)


def _learn_sessions(k=4, t=23, seed=7):
    """k independent RLS tenants — learned weights are part of the
    recovery contract, so every failover test streams learners."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        u = _stream(rng, t=t)
        y = (0.3 * u + 0.1 * np.roll(u, 1, axis=0)).astype(np.float32)
        out.append(dict(sid=i, u_seq=u, targets=y, learn_washout=3))
    return out


def _copy(kw):
    return {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in kw.items()}


def _drain_router(router):
    while router.run_for(1):
        pass
    return router.results()


def _clean_fleet_results(session_kws, engine_kw=LEARN_KW, replicas=2):
    """Reference: the same tenants through an unfaulted fleet."""
    router = FleetRouter()
    for _ in range(replicas):
        router.add_replica(LocalReplica(**engine_kw))
    for kw in session_kws:
        router.submit(engine_kw["n"], StreamSession(**_copy(kw)))
    try:
        return _drain_router(router)
    finally:
        router.close()


def _engine(**kw):
    spec = make_spec(10, hold_steps=6, seed=3, device="cpu")
    return ReservoirEngine(spec, backend="scan", chunk_ticks=5, device="cpu", **kw)


# ---------------------------------------------------------------------------
# fault plan: validation + determinism
# ---------------------------------------------------------------------------


class TestFaultPlan:
    def test_fault_validation(self):
        with pytest.raises(ValueError):
            Fault("meteor")
        with pytest.raises(ValueError):
            Fault("crash", at_chunk=-1)
        with pytest.raises(ValueError):
            Fault("drop", count=0)
        with pytest.raises(ValueError):
            Fault("delay")  # delay faults need delay_s > 0
        with pytest.raises(ValueError):
            Fault("nan")  # nan faults need a target sid
        with pytest.raises(TypeError):
            FaultPlan((Fault("crash"), "not a fault"))

    def test_random_plan_deterministic(self):
        a = FaultPlan.random(42, n_faults=5)
        b = FaultPlan.random(42, n_faults=5)
        assert a == b and a.faults == b.faults
        c = FaultPlan.random(43, n_faults=5)
        assert a != c

    def test_runtime_counts_events(self):
        plan = FaultPlan(
            (Fault("delay", op="stats", delay_s=0.001, count=2),
             Fault("drop", op="run_for", count=1))
        )
        rt = plan.runtime()
        drop, delay = rt.before_send("stats")
        assert not drop and delay == 0.001
        drop, delay = rt.before_send("stats")
        assert not drop and delay == 0.001
        drop, _ = rt.before_send("stats")
        assert not drop  # count exhausted
        drop, _ = rt.before_send("run_for")
        assert drop
        drop, _ = rt.before_send("run_for")
        assert not drop
        assert rt.delays_fired == 2 and rt.drops_fired == 1


# ---------------------------------------------------------------------------
# knob validation
# ---------------------------------------------------------------------------


class TestKnobValidation:
    @pytest.mark.parametrize(
        "kw",
        [
            dict(rpc_timeout_s=0.0),
            dict(rpc_timeout_s=-1.0),
            dict(rpc_retries=-1),
            dict(rpc_retries=True),
            dict(rpc_retries=1.5),
            dict(rpc_backoff_s=0.0),
        ],
    )
    def test_supervision_rejects_nonpositive(self, kw):
        base = dict(rpc_timeout_s=60.0, rpc_retries=3, rpc_backoff_s=0.05)
        base.update(kw)
        with pytest.raises(ValueError):
            validate_supervision(**base)

    def test_supervision_accepts_none_timeout(self):
        validate_supervision(None, 0, 0.01)  # no deadline is a valid choice

    @pytest.mark.parametrize("bad", [0, -3, True, 1.5])
    def test_router_rejects_bad_checkpoint_every(self, bad):
        with pytest.raises(ValueError):
            FleetRouter(checkpoint_every=bad)


# ---------------------------------------------------------------------------
# failover: killed replica, bit-exact recovery
# ---------------------------------------------------------------------------


class TestFailover:
    def _chaotic_router(self, engine_kw=LEARN_KW, at_chunk=2):
        """Two replicas; the first crashes at `at_chunk` and respawns."""
        router = FleetRouter(checkpoint_every=2)
        plan = FaultPlan((Fault("crash", at_chunk=at_chunk),))
        router.add_replica(
            LocalReplica(faults=plan, **engine_kw),
            respawn=lambda: LocalReplica(**engine_kw),
        )
        router.add_replica(LocalReplica(**engine_kw))
        return router

    def test_crash_failover_bit_exact(self):
        kws = _learn_sessions(k=4)
        clean = _clean_fleet_results(kws)

        router = self._chaotic_router()
        for kw in kws:
            router.submit(LEARN_KW["n"], StreamSession(**_copy(kw)))
        try:
            chaotic = _drain_router(router)
            fs = router.fault_stats()
        finally:
            router.close()

        assert sorted(chaotic) == sorted(clean)
        for sid in clean:
            np.testing.assert_array_equal(chaotic[sid].states, clean[sid].states)
            np.testing.assert_array_equal(
                chaotic[sid].predictions, clean[sid].predictions
            )
            np.testing.assert_array_equal(
                chaotic[sid].learned_readout.w_out.numpy(),
                clean[sid].learned_readout.w_out.numpy(),
            )
            assert chaotic[sid].error is None
        assert fs["replica_deaths"] == 1 and fs["failovers"] == 1
        assert fs["sessions_lost"] == 0 and fs["sessions_recovered"] >= 1

    def test_crash_before_first_checkpoint_recovers_from_submit(self):
        # crash at chunk 0: only the synthesized t=0 checkpoint exists —
        # recovery must restart the stream from the submit-time snapshot
        kws = _learn_sessions(k=2)
        clean = _clean_fleet_results(kws)
        router = self._chaotic_router(at_chunk=0)
        for kw in kws:
            router.submit(LEARN_KW["n"], StreamSession(**_copy(kw)))
        try:
            chaotic = _drain_router(router)
            fs = router.fault_stats()
        finally:
            router.close()
        assert fs["sessions_lost"] == 0
        for sid in clean:
            np.testing.assert_array_equal(chaotic[sid].states, clean[sid].states)
            np.testing.assert_array_equal(
                chaotic[sid].learned_readout.w_out.numpy(),
                clean[sid].learned_readout.w_out.numpy(),
            )

    def test_push_stream_replay_recovery(self):
        # rows pushed after the last checkpoint live in the router's replay
        # buffer; failover must replay them so the open stream is whole
        rng = np.random.default_rng(11)
        u = _stream(rng, t=20)

        solo = LocalReplica(**ENGINE_KW)
        solo.submit(StreamSession(sid=0, u_seq=u.copy()))
        while solo.run_for(1):
            pass
        (control,) = solo.results()

        router = FleetRouter(checkpoint_every=100)  # only the t=0 ckpt lands
        plan = FaultPlan((Fault("crash", at_chunk=2),))
        router.add_replica(
            LocalReplica(faults=plan, **ENGINE_KW),
            respawn=lambda: LocalReplica(**ENGINE_KW),
        )
        sid = router.next_sid()
        router.submit(
            ENGINE_KW["n"],
            StreamSession(sid=sid, u_seq=u[:8].copy(), open=True),
        )
        router.run_for(1)
        router.append_ticks(sid, u[8:].copy())
        try:
            router.close_session(sid)
            res = _drain_router(router)[sid]
            fs = router.fault_stats()
        finally:
            router.close()
        np.testing.assert_array_equal(res.states, control.states)
        np.testing.assert_array_equal(res.final_m, control.final_m)
        assert fs["replica_deaths"] == 1
        assert fs["replayed_ticks"] >= 12  # the pushed tail came from replay

    def test_snapshot_is_non_perturbing(self):
        # auto-checkpointing must never change what a healthy fleet serves
        kws = _learn_sessions(k=3)
        clean = _clean_fleet_results(kws)
        router = FleetRouter(checkpoint_every=1)  # snapshot every round
        for _ in range(2):
            router.add_replica(LocalReplica(**LEARN_KW))
        for kw in kws:
            router.submit(LEARN_KW["n"], StreamSession(**_copy(kw)))
        try:
            snapped = _drain_router(router)
        finally:
            router.close()
        for sid in clean:
            np.testing.assert_array_equal(snapped[sid].states, clean[sid].states)
            np.testing.assert_array_equal(
                snapped[sid].learned_readout.w_out.numpy(),
                clean[sid].learned_readout.w_out.numpy(),
            )


# ---------------------------------------------------------------------------
# NaN quarantine: poisoned tenant out, co-tenants untouched
# ---------------------------------------------------------------------------


class TestQuarantine:
    def test_quarantine_isolates_tenant(self):
        rng = np.random.default_rng(13)
        streams = {i: _stream(rng, t=23) for i in range(3)}

        solo = {}
        for i, u in streams.items():
            rep = LocalReplica(**ENGINE_KW)
            rep.submit(StreamSession(sid=0, u_seq=u.copy()))
            while rep.run_for(1):
                pass
            solo[i] = rep.results()[0]

        eng = _engine(num_slots=4)
        poisoned = streams[1].copy()
        poisoned[7, 0] = np.nan
        sessions = [
            StreamSession(sid=0, u_seq=streams[0].copy()),
            StreamSession(sid=1, u_seq=poisoned),
            StreamSession(sid=2, u_seq=streams[2].copy()),
        ]
        results = eng.run(sessions)

        assert "non_finite" in results[1].error
        assert np.isfinite(results[1].states).all()  # clean prefix only
        assert results[1].states.shape[0] < streams[1].shape[0]
        for i in (0, 2):  # co-tenants: not a single bit moved
            assert results[i].error is None
            np.testing.assert_array_equal(results[i].states, solo[i].states)
            np.testing.assert_array_equal(results[i].final_m, solo[i].final_m)
        assert eng.stats().quarantined_lanes == 1

    def test_nan_fault_injection_through_replica(self):
        rng = np.random.default_rng(14)
        plan = FaultPlan((Fault("nan", sid=5, tick=4),))
        rep = LocalReplica(faults=plan, **ENGINE_KW)
        rep.submit(StreamSession(sid=5, u_seq=_stream(rng, t=23)))
        rep.submit(StreamSession(sid=6, u_seq=_stream(rng, t=23)))
        while rep.run_for(1):
            pass
        results = {r.sid: r for r in rep.results()}
        assert "non_finite" in results[5].error
        assert results[6].error is None
        assert rep.stats().quarantined_lanes == 1

    def test_nan_guard_off_is_legacy_behavior(self):
        rng = np.random.default_rng(15)
        u = _stream(rng, t=13)
        u[3, 0] = np.inf
        eng = _engine(num_slots=2, nan_guard=False)
        (res,) = eng.run([StreamSession(sid=0, u_seq=u)]).values()
        assert res.error is None  # guard off: garbage flows through
        assert not np.isfinite(res.states).all()


# ---------------------------------------------------------------------------
# process transport supervision (real child processes)
# ---------------------------------------------------------------------------


class TestProcessSupervision:
    def test_drop_faults_retry_then_degrade(self):
        plan = FaultPlan((Fault("drop", op="stats", count=2),))
        rep = ProcessReplica(
            faults=plan, rpc_timeout_s=60.0, rpc_retries=3,
            rpc_backoff_s=0.01, **ENGINE_KW
        )
        try:
            assert rep.health == HEALTH_HEALTHY
            st = rep.stats()  # both drops swallowed by resends
            assert st.active == 0
            assert rep.rpc_retries_total == 2
            assert rep.health == HEALTH_DEGRADED  # sticky: retries fired
        finally:
            rep.close()
        assert not rep._proc.is_alive()  # close() reaps, no zombie

    def test_child_crash_raises_with_exit_code(self):
        rng = np.random.default_rng(16)
        plan = FaultPlan((Fault("crash", at_chunk=1),))
        rep = ProcessReplica(faults=plan, rpc_timeout_s=30.0, **ENGINE_KW)
        try:
            rep.submit(StreamSession(sid=1, u_seq=_stream(rng, t=23)))
            with pytest.raises(ReplicaError) as ei:
                while rep.run_for(1):
                    pass
            assert ei.value.exit_code == CRASH_EXIT_CODE
            assert rep.health == HEALTH_DEAD
            with pytest.raises(ReplicaError):
                rep.stats()  # dead replica fails fast, never blocks
        finally:
            rep.close()
        assert not rep._proc.is_alive()

    def test_hung_child_trips_rpc_deadline(self):
        rng = np.random.default_rng(17)
        plan = FaultPlan((Fault("hang", at_chunk=1),))
        rep = ProcessReplica(faults=plan, rpc_timeout_s=1.5, **ENGINE_KW)
        try:
            rep.submit(StreamSession(sid=1, u_seq=_stream(rng, t=23)))
            t0 = time.monotonic()
            with pytest.raises(ReplicaError, match="timed out"):
                while rep.run_for(1):
                    pass
            assert time.monotonic() - t0 < 30.0  # deadline, not forever
            assert rep.health == HEALTH_DEAD
        finally:
            rep.close()
        assert not rep._proc.is_alive()  # hung child force-killed

    def test_process_crash_failover_bit_exact(self):
        rng = np.random.default_rng(18)
        u = _stream(rng, t=23)
        solo = LocalReplica(**ENGINE_KW)
        solo.submit(StreamSession(sid=0, u_seq=u.copy()))
        while solo.run_for(1):
            pass
        (control,) = solo.results()

        router = FleetRouter(checkpoint_every=1)
        plan = FaultPlan((Fault("crash", at_chunk=2),))
        router.add_replica(
            ProcessReplica(faults=plan, rpc_timeout_s=60.0, **ENGINE_KW),
            respawn=lambda: LocalReplica(**ENGINE_KW),
        )
        sid = router.next_sid()
        router.submit(ENGINE_KW["n"], StreamSession(sid=sid, u_seq=u.copy()))
        try:
            res = _drain_router(router)[sid]
            fs = router.fault_stats()
        finally:
            router.close()
        np.testing.assert_array_equal(res.states, control.states)
        np.testing.assert_array_equal(res.final_m, control.final_m)
        assert fs["replica_deaths"] == 1 and fs["sessions_lost"] == 0


# ---------------------------------------------------------------------------
# frontend: overload shed + retry + counters
# ---------------------------------------------------------------------------


class TestFrontend:
    def test_overload_shed_structured_error(self):
        rng = np.random.default_rng(19)
        router = FleetRouter()
        router.add_replica(LocalReplica(**ENGINE_KW))

        async def main():
            async with FleetFrontend(router, degraded=True) as fleet:
                assert fleet.degraded and fleet.pool_degraded(10)
                limit = fleet.pool_limit(10, degraded=True)
                sids = [
                    await fleet.submit_stream(10, _stream(rng, t=5), open=True)
                    for _ in range(limit)
                ]
                with pytest.raises(OverloadError) as ei:
                    await fleet.submit_stream(10, _stream(rng, t=5))
                err = ei.value
                assert err.to_dict()["error"] == "overload"
                assert err.n == 10 and err.inflight >= err.limit
                assert fleet.shed_streams == 1
                assert fleet.fault_stats()["shed_streams"] == 1
                fleet.set_degraded(False)
                assert not fleet.pool_degraded(10)  # healthy pool again
                for sid in sids:
                    await fleet.close_stream(sid)
                await fleet.drain_results()

        asyncio.run(main())

    def test_unhealthy_replica_forces_degraded(self):
        router = FleetRouter()
        rep = LocalReplica(**ENGINE_KW)
        router.add_replica(rep)

        async def main():
            async with FleetFrontend(router) as fleet:
                assert not fleet.pool_degraded(10)
                rep.health = HEALTH_DEGRADED
                assert fleet.pool_degraded(10)

        asyncio.run(main())

    def test_frontend_retry_knob_validation(self):
        router = FleetRouter()
        with pytest.raises(ValueError):
            FleetFrontend(router, rpc_retries=-1)
        with pytest.raises(ValueError):
            FleetFrontend(router, rpc_backoff_s=0.0)
        with pytest.raises(ValueError):
            FleetFrontend(router, rpc_backoff_max_s=0.001, rpc_backoff_s=0.05)

    def test_fleet_fault_stats_roundtrip(self):
        router = FleetRouter()
        router.add_replica(LocalReplica(**ENGINE_KW))
        fs = router.fault_stats()
        for key in (
            "replica_deaths", "failovers", "sessions_recovered",
            "sessions_lost", "replayed_ticks", "rpc_retries",
            "quarantined_lanes",
        ):
            assert fs[key] == 0
        router.close()


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

JENGINE_KW = {k: v for k, v in ENGINE_KW.items() if k != "device"}


def _crash_fault_stats(fleet, session_cls, engine_kw, at_chunk):
    """A two-replica fleet, the first crashing at `at_chunk` and respawned,
    serving four RLS learners and one open stream pushed after the first
    round; returns fault_stats() after the drain."""
    kw = dict(engine_kw, learn="rls")
    router = fleet.FleetRouter(checkpoint_every=2)
    plan = fleet.FaultPlan((fleet.Fault("crash", at_chunk=at_chunk),))
    router.add_replica(
        fleet.LocalReplica(faults=plan, **kw), respawn=lambda: fleet.LocalReplica(**kw)
    )
    router.add_replica(fleet.LocalReplica(**kw))
    for s in _learn_sessions(k=4):
        router.submit(10, session_cls(**_copy(s)))
    rng = np.random.default_rng(25)
    u, y = _stream(rng, t=20), _stream(rng, t=20)
    router.submit(10, session_cls(sid=9, u_seq=u[:6], targets=y[:6], learn_washout=2, open=True))
    router.run_for(1)
    router.append_ticks(9, u[6:], y[6:])
    router.close_session(9)
    try:
        out = _drain_router(router)
        assert sorted(out) == [0, 1, 2, 3, 9]
        return router.fault_stats()
    finally:
        router.close()


@pytest.mark.parametrize("at_chunk", [0, 2])
def test_fault_stats_match_reference(at_chunk):
    ours = _crash_fault_stats(
        fleet, StreamSession, ENGINE_KW,
        at_chunk,
    )
    theirs = _crash_fault_stats(jfleet, JSession, JENGINE_KW, at_chunk)
    assert ours == theirs
    assert ours["replica_deaths"] == 1 and ours["sessions_lost"] == 0


def _overload(fleet, engine_kw):
    rng = np.random.default_rng(26)
    router = fleet.FleetRouter()
    router.add_replica(fleet.LocalReplica(**engine_kw))

    async def main():
        async with fleet.FleetFrontend(router, degraded=True) as front:
            limit = front.pool_limit(10, degraded=True)
            sids = [await front.submit_stream(10, _stream(rng, t=5), open=True)
                    for _ in range(limit)]
            with pytest.raises(fleet.OverloadError) as ei:
                await front.submit_stream(10, _stream(rng, t=5))
            front.set_degraded(False)
            for sid in sids:
                await front.close_stream(sid)
            await front.drain_results()
            return ei.value.to_dict(), str(ei.value), front.fault_stats()

    return asyncio.run(main())


def test_overload_error_matches_reference():
    ours = _overload(fleet, ENGINE_KW)
    theirs = _overload(jfleet, JENGINE_KW)
    assert ours == theirs
    assert ours[0]["error"] == "overload" and ours[2]["shed_streams"] == 1
