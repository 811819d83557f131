"""The port's fleet tier (repro_torch.serve.fleet) on the CPU: the planner,
router placement, bit-exact migration, the async front end's admission, and
the replica transports; then each against the reference's fleet.

Restates tests/test_fleet.py on the port with the reference's ENGINE_KW
(n = 10, 4 slots, hold 6, seed 3, scan, K = 5) and device="cpu": anything
the fleet does to a stream — placing it on a replica, pushing ticks through
the affinity map, checkpointing it out of one engine and restoring it into
another (process boundaries included) — leaves the served states and
outputs BIT-IDENTICAL to the same stream served by one unmigrated engine of
the port.

Against the reference (repro.serve.fleet):
  - the planner is the same numpy arithmetic: CapacityModel.from_bench on
    the committed BENCH_serve.json and on a synthetic grid gives the
    reference's coefficients, prediction_error, plan_fleet and
    fleet_sessions_per_sec (cores given) within PLANNER_RTOL = 1e-12
    relative;
  - the same submits give the same sid -> replica placement and affinity;
  - streams served through the port's fleet match the reference fleet's
    within F32_ATOL = 5e-5 (tests/test_torch_api.py) on states and final_m;
  - a session checkpointed out of a reference replica and restored into a
    port replica (convert.checkpoint_from_numpy), and the other way
    (convert.checkpoint_to_numpy), finishes within F32_ATOL of the
    reference serving it unmoved.

One case spawns a process replica (a child that imports torch); it carries
its own rpc_timeout_s.
"""

import asyncio
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.constants import STOParams as JSTOParams
from repro.core.constants import default_params as jdefault_params
from repro.serve import fleet as jfleet
from repro.serve.reservoir import SessionCheckpoint as JCheckpoint
from repro.serve.reservoir import StreamSession as JSession
from repro_torch import convert
from repro_torch.api import compile_plan, make_spec
from repro_torch.core.reservoir import fit_ridge
from repro_torch.serve.fleet import (
    AdmissionError,
    CapacityModel,
    FleetFrontend,
    FleetRouter,
    LocalReplica,
    WorkloadClass,
    start_fleet,
)
from repro_torch.serve.fleet import replica as replica_mod
from repro_torch.serve.reservoir import EngineStats, StreamSession

torch.set_num_threads(2)

ENGINE_KW = dict(
    n=10, num_slots=4, hold_steps=6, seed=3, backend="scan", chunk_ticks=5, device="cpu"
)
# the reference's replicas take the same keywords but the device
JENGINE_KW = {k: v for k, v in ENGINE_KW.items() if k != "device"}
BENCH_PATH = os.path.join(os.path.dirname(__file__), "..", "BENCH_serve.json")
F32_ATOL = 5e-5
PLANNER_RTOL = 1e-12


def _stream(rng, t=23, n_in=1):
    return rng.uniform(0.0, 0.5, size=(t, n_in)).astype(np.float32)


def _serve_solo(u, targets=None, engine_kw=ENGINE_KW, **session_kw):
    """Reference: the same stream through one unmigrated LocalReplica."""
    rep = LocalReplica(**engine_kw)
    rep.submit(StreamSession(sid=0, u_seq=u, targets=targets, **session_kw))
    while rep.run_for(1):
        pass
    (res,) = rep.results()
    return res


def test_exports_match_reference():
    from repro_torch.serve import fleet

    assert fleet.__all__ == jfleet.__all__
    assert all(hasattr(fleet, name) for name in fleet.__all__)
    assert fleet.FAULT_KINDS == jfleet.FAULT_KINDS
    assert fleet.CRASH_EXIT_CODE == jfleet.CRASH_EXIT_CODE


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


def _synthetic_bench(coef, burst_slowdown=1.5, k=8, h=5):
    """A grid generated FROM the model family: fit must recover it."""
    cells = []
    for n in (16, 64, 256):
        for e in (8, 32, 128):
            t = float(CapacityModel._features(n, e, k, h) @ np.asarray(coef))
            cells.append(
                dict(
                    n=n,
                    e=e,
                    steady_chunk_s=t,
                    ticks_per_sec_burst=e * k / (t * burst_slowdown),
                    learn_overhead=1.4,
                    precision_speedup=1.2,
                )
            )
    return dict(
        cells=cells,
        chunk_ticks=k,
        hold_steps=h,
        ref_stream_ticks=7,
        backend_platform="cpu",
    )


class TestPlanner:
    COEF = np.array([2e-4, 1e-6, 3e-12, 2e-10, 5e-13])

    def test_fit_recovers_synthetic_grid(self):
        m = CapacityModel.from_bench(_synthetic_bench(self.COEF))
        err = m.prediction_error()
        assert err["max"] < 1e-6  # noise-free grid: exact recovery
        assert err["sustained_max"] < 1e-6
        # sustained family carries the churn slowdown
        ratio = m.t_chunk(64, 32, sustained=True) / m.t_chunk(64, 32)
        assert ratio == pytest.approx(1.5, rel=1e-6)

    def test_multipliers_and_capacity_shape(self):
        m = CapacityModel.from_bench(_synthetic_bench(self.COEF))
        base = m.sessions_per_sec(64, 32)
        assert m.sessions_per_sec(64, 32, learn=True) == pytest.approx(base / 1.4, rel=1e-6)
        assert m.sessions_per_sec(64, 32, precision="mixed") == pytest.approx(
            base * 1.2, rel=1e-6
        )
        # fleet scaling is min(replicas, cores): never super-linear
        assert m.fleet_sessions_per_sec(64, 32, replicas=4, cores=2) == pytest.approx(
            2 * base, rel=1e-6
        )
        with pytest.raises(ValueError):
            m.sessions_per_sec(64, 32, platform="gpu")

    def test_recalibrate_rescales_both_families(self):
        m = CapacityModel.from_bench(_synthetic_bench(self.COEF))
        d0 = m.drain_seconds(64, 32, sessions=16, stream_ticks=40, cores=1)
        err0 = m.prediction_error()
        # probe says the host now runs at half the calibration speed
        half_rate = 0.5 * 32 * m.chunk_ticks / m.t_chunk(64, 32, sustained=True)
        scale = m.recalibrate({64: {32: half_rate}})
        assert scale == pytest.approx(0.5, rel=1e-6)
        assert m.drain_seconds(64, 32, sessions=16, stream_ticks=40, cores=1) == pytest.approx(
            2 * d0, rel=1e-6
        )
        # fit error is evaluated at calibration scale
        err1 = m.prediction_error()
        assert err1["max"] == pytest.approx(err0["max"], abs=1e-12)
        with pytest.raises(ValueError):
            m.recalibrate({})

    def test_plan_fleet_covers_offered_load(self):
        m = CapacityModel.from_bench(_synthetic_bench(self.COEF))
        plan = m.plan_fleet(
            [WorkloadClass(n=16, rate=50.0), WorkloadClass(n=256, rate=5.0)],
            headroom=0.2,
            cores=64,  # enough cores that replica counts are demand math
        )
        assert len(plan.replicas) == 2
        for spec in plan.replicas:
            offered = {16: 50.0, 256: 5.0}[spec.n]
            assert spec.count * spec.sessions_per_sec >= offered * 1.2
        assert 0.0 < plan.utilization <= 1.0 / 1.2 + 1e-9

    def test_committed_grid_sanity_bounds(self):
        """Predicted-vs-measured on the committed grid: the model sits
        within the fit-error band the planner itself publishes."""
        m = CapacityModel.from_bench(BENCH_PATH)
        err = m.prediction_error()
        assert err["max"] < 0.35, err["per_cell"]
        if "sustained_max" in err:
            assert err["sustained_max"] < 0.35, err["per_cell_sustained"]
        for c in m.cells:
            assert m.t_chunk(c["n"], c["e"], sustained=True) > 0.5 * m.t_chunk(c["n"], c["e"])

    def test_probe_rates_on_the_cpu(self):
        """measure_probe_rates builds its probe engines through the port's
        make_spec / PLAN_CACHE on the caller's device; recalibrate takes its
        mapping."""
        from repro_torch.serve.fleet import measure_probe_rates

        probe = measure_probe_rates([(10, 4)], hold_steps=2, chunk_ticks=2, stream_ticks=4,
                                    waves=1, device="cpu")
        assert list(probe) == [10] and list(probe[10]) == [4] and probe[10][4] > 0
        m = CapacityModel.from_bench(_synthetic_bench(self.COEF))
        assert m.recalibrate(probe) > 0


def _planner_numbers(model_cls, workload_cls, bench):
    m = model_cls.from_bench(bench)
    err = m.prediction_error()
    plan = m.plan_fleet(
        [workload_cls(n=16, rate=50.0), workload_cls(n=256, rate=5.0, learn=True),
         workload_cls(n=64, rate=12.0, precision="mixed")],
        headroom=0.2, cores=6,
    )
    scalars = {"coef": np.asarray(m.coef)}
    if m.burst_coef is not None:
        scalars["burst_coef"] = np.asarray(m.burst_coef)
    for key in ("median", "max", "sustained_median", "sustained_max"):
        if key in err:
            scalars[key] = err[key]
    for cell, v in err["per_cell"].items():
        scalars[f"cell_{cell}"] = v
    scalars["total_capacity"] = plan.total_capacity
    scalars["utilization"] = plan.utilization
    for i, r in enumerate(plan.replicas):
        scalars[f"replica{i}"] = np.array([r.n, r.num_slots, r.count, r.sessions_per_sec])
    for n, e, reps in ((16, 32, 4), (256, 8, 2), (64, 128, 9)):
        scalars[f"fleet_{n}_{e}_{reps}"] = m.fleet_sessions_per_sec(n, e, replicas=reps, cores=6)
        scalars[f"degraded_{n}_{e}_{reps}"] = m.degraded_fleet_sessions_per_sec(
            n, e, replicas=reps, cores=6
        )
        scalars[f"drain_{n}_{e}_{reps}"] = m.drain_seconds(
            n, e, sessions=40, stream_ticks=30, replicas=reps, cores=6
        )
    return scalars, plan


@pytest.mark.parametrize("grid", ["committed", "synthetic"])
def test_planner_matches_reference(grid):
    bench = BENCH_PATH if grid == "committed" else _synthetic_bench(TestPlanner.COEF)
    ours, plan = _planner_numbers(CapacityModel, WorkloadClass, bench)
    theirs, jplan = _planner_numbers(jfleet.CapacityModel, jfleet.WorkloadClass, bench)
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        np.testing.assert_allclose(ours[key], theirs[key], rtol=PLANNER_RTOL, atol=0, err_msg=key)
    assert [(r.learn, r.precision) for r in plan.replicas] == [
        (r.learn, r.precision) for r in jplan.replicas
    ]


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


class TestRouter:
    def test_pools_are_bucketed_by_n(self):
        router = FleetRouter()
        for r in start_fleet(2, "local", **ENGINE_KW):
            router.add_replica(r)
        for r in start_fleet(1, "local", **{**ENGINE_KW, "n": 20}):
            router.add_replica(r)
        assert sorted(router.pools) == [10, 20]
        assert len(router.pool(10)) == 2
        with pytest.raises(KeyError):
            router.pool(1024)  # no cross-bucket head-of-line sharing
        router.close()

    def test_least_loaded_placement_and_affinity(self):
        rng = np.random.default_rng(0)
        router = FleetRouter()
        reps = start_fleet(2, "local", **ENGINE_KW)
        for r in reps:
            router.add_replica(r)
        owners = [
            router.submit(10, StreamSession(sid=i, u_seq=_stream(rng))) for i in range(4)
        ]
        # least-loaded placement alternates across the empty pool
        assert {owners.count(reps[0]), owners.count(reps[1])} == {2}
        for i, owner in enumerate(owners):
            assert router.replica_for(i) is owner
        with pytest.raises(ValueError):
            router.submit(10, StreamSession(sid=0, u_seq=_stream(rng)))
        out = router.drain()
        assert sorted(out) == [0, 1, 2, 3]
        with pytest.raises(KeyError):
            router.replica_for(0)  # affinity released on finish
        router.close()


def _placement_script(router_cls, session_cls, replica_cls, engine_kw):
    """Submits of ragged streams interleaved with pump rounds and a drain;
    returns each sid's replica index at submit and the affinity map after
    every step, as replica indices."""
    rng = np.random.default_rng(21)
    router = router_cls()
    reps = [replica_cls(**engine_kw) for _ in range(3)]
    for r in reps:
        router.add_replica(r)
    index = {id(r): i for i, r in enumerate(reps)}
    placed, affinity = [], []
    for sid in range(9):
        owner = router.submit(10, session_cls(sid=sid, u_seq=_stream(rng, t=4 + 3 * sid)))
        placed.append(index[id(owner)])
        if sid % 3 == 2:
            router.run_for(1)
            router.results()
        affinity.append(sorted((s, index[id(r)]) for s, r in router._affinity.items()))
    out = router.drain()
    router.close()
    return placed, affinity, sorted(out)


def test_placement_matches_reference():
    ours = _placement_script(FleetRouter, StreamSession, LocalReplica, ENGINE_KW)
    theirs = _placement_script(jfleet.FleetRouter, JSession, jfleet.LocalReplica, JENGINE_KW)
    assert ours == theirs


def _serve_through_fleet(router_cls, session_cls, replica_cls, engine_kw, streams):
    router = router_cls()
    for _ in range(2):
        router.add_replica(replica_cls(**engine_kw))
    for sid, u in enumerate(streams):
        router.submit(10, session_cls(sid=sid, u_seq=u.copy()))
    out = router.drain()
    router.close()
    return out


def test_fleet_streams_match_reference():
    rng = np.random.default_rng(22)
    streams = [_stream(rng, t=int(rng.integers(6, 24))) for _ in range(7)]
    ours = _serve_through_fleet(FleetRouter, StreamSession, LocalReplica, ENGINE_KW, streams)
    theirs = _serve_through_fleet(jfleet.FleetRouter, JSession, jfleet.LocalReplica,
                                  JENGINE_KW, streams)
    assert sorted(ours) == sorted(theirs) == list(range(7))
    for sid in ours:
        np.testing.assert_allclose(ours[sid].states, np.asarray(theirs[sid].states),
                                   rtol=0, atol=F32_ATOL)
        np.testing.assert_allclose(ours[sid].final_m, np.asarray(theirs[sid].final_m),
                                   rtol=0, atol=F32_ATOL)


# ---------------------------------------------------------------------------
# checkpoint -> migrate -> resume
# ---------------------------------------------------------------------------


class TestMigration:
    def test_midstream_migration_bit_exact(self):
        rng = np.random.default_rng(1)
        u = _stream(rng, t=23)
        control = _serve_solo(u)
        router = FleetRouter()
        for r in start_fleet(2, "local", **ENGINE_KW):
            router.add_replica(r)
        router.submit(10, StreamSession(sid=7, u_seq=u))
        src = router.replica_for(7)
        router.run_for(2)  # mid-stream: 10 of 23 ticks done
        dst = router.migrate(7)
        assert dst is not src and router.replica_for(7) is dst
        out = router.drain()
        np.testing.assert_array_equal(out[7].states, control.states)
        np.testing.assert_array_equal(out[7].final_m, control.final_m)
        router.close()

    def test_migration_with_inflight_rls_learner(self):
        """P and Wl lanes of an in-progress RLS learner ride the checkpoint;
        the learned readout finishes bit-identical to never having moved."""
        kw = {**ENGINE_KW, "learn": "rls"}
        rng = np.random.default_rng(2)
        u, y = _stream(rng, t=23), _stream(rng, t=23)
        control = _serve_solo(u, targets=y, engine_kw=kw, learn_washout=3)
        router = FleetRouter()
        for r in start_fleet(2, "local", **kw):
            router.add_replica(r)
        router.submit(10, StreamSession(sid=1, u_seq=u, targets=y, learn_washout=3))
        router.run_for(2)  # learner has already absorbed ticks
        router.migrate(1)
        out = router.drain()
        np.testing.assert_array_equal(
            out[1].learned_readout.w_out.numpy(), control.learned_readout.w_out.numpy()
        )
        np.testing.assert_array_equal(out[1].predictions, control.predictions)
        np.testing.assert_array_equal(out[1].states, control.states)
        router.close()

    def test_migration_of_queued_session(self):
        """A session still waiting for a slot migrates too (checkpoint at
        t=0) and serves identically on the destination."""
        rng = np.random.default_rng(3)
        streams = [_stream(rng, t=12) for _ in range(5)]
        control = _serve_solo(streams[4])
        kw = {**ENGINE_KW, "num_slots": 2}
        router = FleetRouter()
        reps = start_fleet(2, "local", **kw)
        for r in reps:
            router.add_replica(r)
        for i, u in enumerate(streams):
            reps[0].submit(StreamSession(sid=i, u_seq=u))
            router._affinity[i] = reps[0]
        dst = router.migrate(4, dst=reps[1])
        assert dst is reps[1]
        out = router.drain()
        assert sorted(out) == [0, 1, 2, 3, 4]
        np.testing.assert_array_equal(out[4].states, control.states)
        router.close()


def _checkpoint_midstream(replica, session, chunks=2):
    replica.submit(session)
    for _ in range(chunks):
        replica.run_for(1)
    return replica.checkpoint_session(session.sid)


def _finish(replica):
    while replica.run_for(1):
        pass
    (res,) = replica.results()
    return res


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_checkpoint_crosses_packages(direction):
    """A session checkpointed mid-stream out of one package's replica and
    restored into the other's (convert.checkpoint_from_numpy /
    checkpoint_to_numpy) finishes within F32_ATOL of the reference serving
    it unmoved; the prefix harvested before the move is carried exactly."""
    rng = np.random.default_rng(23)
    u = _stream(rng, t=23)
    jparams = jdefault_params(jnp.float32)._replace(
        current=jnp.float32(2.6e-3), a_in=jnp.float32(1.2)
    )
    control = jfleet.LocalReplica(**JENGINE_KW)
    control.submit(JSession(sid=4, u_seq=u.copy(), params=jparams))
    want = _finish(control)
    if direction == "reference_to_port":
        src = jfleet.LocalReplica(**JENGINE_KW)
        ckpt = _checkpoint_midstream(src, JSession(sid=4, u_seq=u.copy(), params=jparams))
        dst = LocalReplica(**ENGINE_KW)
        dst.restore_session(convert.checkpoint_from_numpy(ckpt))
    else:
        src = LocalReplica(**ENGINE_KW)
        tparams = convert.params_from_numpy(
            {f: np.asarray(v) for f, v in jparams._asdict().items()}, device="cpu"
        )
        ckpt = _checkpoint_midstream(src, StreamSession(sid=4, u_seq=u.copy(), params=tparams))
        fields = convert.checkpoint_to_numpy(ckpt)
        assert fields["spec"] is None
        assert all(isinstance(v, np.ndarray) for v in fields["params"].values())
        fields["params"] = JSTOParams(**fields["params"])
        dst = jfleet.LocalReplica(**JENGINE_KW)
        dst.restore_session(JCheckpoint(**fields))
    assert ckpt.t == 10
    got = _finish(dst)
    np.testing.assert_array_equal(np.asarray(got.states)[:10], np.asarray(ckpt.states))
    np.testing.assert_allclose(np.asarray(got.states), np.asarray(want.states), rtol=0,
                               atol=F32_ATOL)
    np.testing.assert_allclose(np.asarray(got.final_m), np.asarray(want.final_m), rtol=0,
                               atol=F32_ATOL)


def test_checkpoint_to_numpy_carries_a_spec():
    """A checkpoint of a spec-carrying session converts to fields from which
    the reference rebuilds a SimSpec that hashes as the reference's own spec
    of the same seeds (so a restore there routes as it does here)."""
    from repro.api import make_spec as jmake_spec
    from repro.api import spec_structural_hash as jhash
    from repro.api.spec import SimSpec as JSimSpec

    rep = LocalReplica(**ENGINE_KW)
    rep.submit(StreamSession(sid=3, u_seq=_stream(np.random.default_rng(27)),
                             spec=make_spec(10, n_in=1, seed=3, hold_steps=6, device="cpu")))
    rep.run_for(1)
    fields = convert.checkpoint_to_numpy(rep.checkpoint_session(3))
    d = fields["spec"]
    spec = JSimSpec(**dict(d, params=JSTOParams(**d["params"])))
    assert jhash(spec) == jhash(jmake_spec(10, n_in=1, seed=3, hold_steps=6, dtype=jnp.float32))
    assert JCheckpoint(**dict(fields, spec=spec, params=None)).t == 5


# ---------------------------------------------------------------------------
# async front-end
# ---------------------------------------------------------------------------


class TestFrontend:
    def _router(self, planner=None, replicas=2, **overrides):
        router = FleetRouter(planner=planner)
        for r in start_fleet(replicas, "local", **{**ENGINE_KW, **overrides}):
            router.add_replica(r)
        return router

    def test_submit_push_drain_round_trip(self):
        rng = np.random.default_rng(4)
        u = _stream(rng, t=23)
        control = _serve_solo(u)

        async def main():
            async with FleetFrontend(self._router()) as fleet:
                sids = [await fleet.submit_stream(10, _stream(rng)) for _ in range(3)]
                # open stream fed in two pushes: must equal the one-shot serve
                osid = await fleet.submit_stream(10, u[:9], open=True)
                await fleet.push_ticks(osid, u[9:])
                await fleet.close_stream(osid)
                res = await fleet.result(osid)
                np.testing.assert_array_equal(res.states, control.states)
                rest = await fleet.drain_results()
                assert sorted(rest) == sorted(sids)

        asyncio.run(main())

    def test_pool_limit_and_admission_error(self):
        planner = CapacityModel.from_bench(_synthetic_bench(TestPlanner.COEF))
        # a glacial host: the planner ceiling collapses to the slot floor
        planner.host_scale = 1e-9
        rng = np.random.default_rng(5)

        async def main():
            router = self._router(planner=None)
            async with FleetFrontend(router) as fleet:
                assert fleet.pool_limit(10) is None  # no planner: unlimited
            router = self._router(planner=planner)
            async with FleetFrontend(router, admit_window_s=0.01, max_waiters=0) as fleet:
                limit = fleet.pool_limit(10)
                assert limit == 2 * ENGINE_KW["num_slots"]  # slot floor
                sids = [
                    await fleet.submit_stream(10, _stream(rng, t=5), open=True)
                    for _ in range(limit)
                ]
                with pytest.raises(AdmissionError):
                    await fleet.submit_stream(10, _stream(rng, t=5))
                for sid in sids:
                    await fleet.close_stream(sid)
                    await fleet.result(sid)

        asyncio.run(main())


# ---------------------------------------------------------------------------
# per-session n_out through the fleet
# ---------------------------------------------------------------------------


def test_per_session_n_out_round_trip():
    """Sessions with different readout widths share one replica: the
    q-column slice of the padded lane bit-matches each session served by an
    engine sized exactly to its own q."""
    rng = np.random.default_rng(6)
    spec = make_spec(10, n_in=1, seed=3, hold_steps=6, device="cpu")
    u_fit = rng.uniform(0.0, 0.5, size=(40, 1)).astype(np.float32)
    _, states_fit = compile_plan(spec, impl="scan", device="cpu").drive(torch.from_numpy(u_fit))
    ro2 = fit_ridge(
        states_fit,
        torch.from_numpy(rng.uniform(0.0, 0.5, size=(40, 2)).astype(np.float32)),
        washout=4,
    )
    ro1 = fit_ridge(states_fit, torch.from_numpy(u_fit[:, 0]), washout=4)
    u = _stream(rng, t=17)
    narrow = _serve_solo(u, readout=ro1)  # engine n_out=1
    wide = _serve_solo(u, readout=ro2, engine_kw={**ENGINE_KW, "n_out": 2})

    router = FleetRouter()
    for r in start_fleet(1, "local", **{**ENGINE_KW, "n_out": 2}):
        router.add_replica(r)
    router.submit(10, StreamSession(sid=1, u_seq=u, readout=ro2))
    router.submit(10, StreamSession(sid=2, u_seq=u, readout=ro1))
    out = router.drain()
    assert out[1].outputs.shape == (13, 2) and out[2].outputs.shape == (13, 1)
    np.testing.assert_array_equal(out[1].outputs, wide.outputs)
    np.testing.assert_array_equal(out[2].outputs, narrow.outputs)
    router.close()


# ---------------------------------------------------------------------------
# observability + process transport
# ---------------------------------------------------------------------------


def test_stats_through_replica_protocol():
    rng = np.random.default_rng(8)
    rep = LocalReplica(**ENGINE_KW)
    for i in range(3):
        rep.submit(StreamSession(sid=i, u_seq=_stream(rng, t=11)))
    rep.run_for(1)
    st = rep.stats()
    assert isinstance(st, EngineStats)
    assert st.n == 10 and st.num_slots == 4 and st.backend == "scan"
    assert st.active == 3 and 0.0 < st.occupancy <= 1.0
    assert st.chunk_median_s is not None and st.chunk_median_s > 0.0
    assert st.health == "healthy"
    d = st.to_dict()
    assert d["active"] == 3 and d["ticks_per_sec"] > 0.0 and d["health"] == "healthy"
    while rep.run_for(1):
        pass
    assert rep.stats().active == 0


class _TensorDevices(pickle.Pickler):
    """Pickles into a buffer and records the device of every tensor met."""

    def __init__(self, file):
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self.devices = set()

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            self.devices.add(obj.device.type)
        return None


def _tensor_devices(msg):
    import io

    p = _TensorDevices(io.BytesIO())
    p.dump(msg)
    return p.devices


def test_pipe_messages_are_host_data():
    """Every message type the process transport pickles — a submitted
    session (params, a readout, m0, a spec), pushed ticks, a checkpoint, a
    snapshot, results with a learned readout, stats — holds no tensor
    off the CPU."""
    kw = {**ENGINE_KW, "learn": "rls"}
    rep = LocalReplica(**kw)
    rng = np.random.default_rng(24)
    spec = rep.engine.res
    sess = StreamSession(
        sid=1, u_seq=_stream(rng), targets=_stream(rng), learn_washout=2,
        params=spec.params._replace(current=torch.tensor(2.7e-3)),
        readout=fit_ridge(torch.from_numpy(rng.normal(size=(30, 10)).astype(np.float32)),
                          torch.from_numpy(_stream(rng, t=30)), washout=0),
        m0=spec.m0.clone(), spec=spec, open=True,
    )
    messages = {"submit": ("submit", replica_mod._host_session(sess))}
    assert _tensor_devices(messages["submit"]) == {"cpu"}
    rep.submit(sess)
    rep.run_for(2)
    messages["append"] = ("append", 1, _stream(rng, t=3), _stream(rng, t=3))
    rep.append_ticks(*messages["append"][1:])
    messages["snapshot"] = ("ok", rep.snapshot())
    messages["checkpoint"] = ("ok", rep.checkpoint_session(1))
    rep.restore_session(messages["checkpoint"][1])
    rep.close_session(1)
    while rep.run_for(1):
        pass
    messages["results"] = ("ok", rep.results())
    messages["stats"] = ("ok", rep.stats())
    assert messages["results"][1][0].learned_readout is not None
    for op, msg in messages.items():
        assert _tensor_devices(msg) <= {"cpu"}, op
        pickle.loads(pickle.dumps(msg))


@pytest.mark.parametrize("transport", ["process"])
def test_process_transport_end_to_end(transport):
    """One spawned replica: serve, stats, and a cross-process checkpoint
    restored into an in-process engine — all bit-exact with local."""
    rng = np.random.default_rng(9)
    u = _stream(rng, t=23)
    control = _serve_solo(u)
    (rep,) = start_fleet(1, transport, rpc_timeout_s=120.0, **ENGINE_KW)
    try:
        rep.submit(StreamSession(sid=5, u_seq=u))
        for _ in range(2):
            rep.run_for(1)
        st = rep.stats()
        assert st.active == 1 and st.backend == "scan"
        ckpt = rep.checkpoint_session(5)  # crosses the pipe as host data
        local = LocalReplica(**ENGINE_KW)
        local.restore_session(ckpt)
        while local.run_for(1):
            pass
        (res,) = local.results()
        np.testing.assert_array_equal(res.states, control.states)
        np.testing.assert_array_equal(res.final_m, control.final_m)
    finally:
        rep.close()
    assert not rep._proc.is_alive()
