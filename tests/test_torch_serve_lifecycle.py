"""The port's reservoir engine lifecycle on the CPU: the per-tick step(), push
streams, checkpoint / restore and snapshots, port against port and against
the JAX reference.

Restates the contracts of tests/test_serve_chunked.py
(TestEnginePipelinedParity), tests/test_serve_reservoir.py (TestScheduler),
the engine-level halves of tests/test_fleet.py (TestMigration: mid-stream,
an RLS learner in flight, a queued session; through checkpoint_session /
restore_session, no router), tests/test_rls_learning.py's LMS checkpoint and
tests/test_fleet_faults.py's push-stream and non-destructive-snapshot cases.

Tolerances:
  - port against port: bit-equal. run() equals a step() loop on the scan
    impl, and a migrated, restored or snapshotted session equals one that
    never moved (on the CPU every impl computes a lane with the same
    arithmetic at any lane position); run() against step() on the planes
    impls, F32_ATOL.
  - port against the reference: F32_ATOL = 5e-5 on states and final_m
    (tests/test_torch_serve.py); outputs are a readout of N + 1 states, so
    ||w_out||_1 * F32_ATOL; a learner's predictions and learned W
    ENGINE_ATOL = 2e-3 (tests/test_torch_rls.py: the 5e-5 state differences
    amplified by the gain of an RLS with reg = 1e-2 over <= 23 samples).
"""

import dataclasses
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import make_spec as jmake_spec
from repro.core.reservoir import Readout as JReadout
from repro.serve.reservoir import ReservoirEngine as JEngine
from repro.serve.reservoir import SessionCheckpoint as JCheckpoint
from repro.serve.reservoir import StreamSession as JSession
from repro_torch import convert
from repro_torch.api import compile_plan
from repro_torch.core.ensemble import broadcast_params
from repro_torch.core.reservoir import fit_ridge
from repro_torch.serve.reservoir import ReservoirEngine, SessionCheckpoint, StreamSession
from repro_torch.serve.scheduler import SlotScheduler

torch.set_num_threads(2)

F32_ATOL = 5e-5
ENGINE_ATOL = 2e-3
# the reference's tests/test_fleet.py engine
ENGINE_KW = dict(num_slots=4, backend="scan", chunk_ticks=5)
N, HOLD, SEED = 10, 6, 3


def _spec_pair(n=N, hold=HOLD, seed=SEED):
    sj = jmake_spec(n, n_in=1, seed=seed, hold_steps=hold, dtype=jnp.float32)
    st = convert.spec_from_numpy(
        type(sj.params)(*[np.asarray(x) for x in sj.params]),
        np.asarray(sj.w_cp), np.asarray(sj.w_in), np.asarray(sj.m0), sj.dt,
        sj.hold_steps, device="cpu",
    )
    return sj, st


@pytest.fixture(scope="module")
def specs():
    return _spec_pair()


def _engine(st, **kw):
    return ReservoirEngine(st, device="cpu", **{**ENGINE_KW, **kw})


def _stream(rng, t=23):
    return rng.uniform(0.0, 0.5, size=(t, 1)).astype(np.float32)


def _drain(eng):
    while eng.step_chunk():
        pass
    return eng.pop_results()


def _serve_solo(st, u, targets=None, engine_kw=None, **session_kw):
    """The same stream through one engine that never moves it."""
    eng = _engine(st, **(engine_kw or {}))
    eng.submit(StreamSession(sid=0, u_seq=u.copy(), targets=targets, **session_kw))
    return _drain(eng)[0]


def _assert_same(a, b):
    """Two port results, bit for bit."""
    for f in ("states", "outputs", "final_m", "predictions"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.array_equal(x, y), f
    if a.learned_readout is not None:
        assert torch.equal(a.learned_readout.w_out, b.learned_readout.w_out)


# -- run() against the per-tick step() -------------------------------------------------


def _sessions(st, count, lengths, seed, with_readout=True):
    """Sessions with a readout fit on each stream's scan states, twice (the
    engine mutates what it serves)."""
    rng = np.random.default_rng(seed)
    solo = compile_plan(st, impl="scan", device="cpu")
    rows = []
    for sid in range(count):
        u = _stream(rng, lengths[sid % len(lengths)])
        ro = None
        if with_readout:
            _, states = solo.drive(u)
            ro = fit_ridge(states, torch.from_numpy(u[:, 0]), washout=2, reg=1e-3)
        rows.append((sid, u, ro))

    def make():
        return [StreamSession(sid=sid, u_seq=u.copy(), readout=ro) for sid, u, ro in rows]

    return make


def _step_loop(eng, sessions):
    for s in sessions:
        eng.submit(s)
    while eng.scheduler.has_work():
        eng.step()
    return eng.results


@pytest.mark.parametrize("backend", ["scan", "ref", "chunk", "fused", "tiled"])
def test_run_bitexact_vs_step_loop(backend):
    """The pipelined chunked path and the per-tick path across slot turnover
    and mid-chunk finishes: bit for bit on scan (states, outputs, final_m),
    within F32_ATOL on the planes impls (the plain versions here)."""
    _, st = _spec_pair(n=12, hold=8)
    make = _sessions(st, 9, (5, 9, 14), seed=0)
    r_chunk = _engine(st, num_slots=3, backend=backend, chunk_ticks=4).run(make())
    r_step = _step_loop(_engine(st, num_slots=3, backend=backend), make())
    assert sorted(r_chunk) == sorted(r_step) == list(range(9))
    for sid, a in r_chunk.items():
        b = r_step[sid]
        if backend == "scan":
            _assert_same(a, b)
        else:
            np.testing.assert_allclose(a.states, b.states, atol=F32_ATOL)
            np.testing.assert_allclose(a.final_m, b.final_m, atol=F32_ATOL)


def test_chunk_ticks_one_matches_step():
    """K = 1 pipelining (bulk harvest, no per-slot slicing) is still the
    per-tick math."""
    _, st = _spec_pair(n=10, hold=6)
    make = _sessions(st, 5, (4, 7), seed=1, with_readout=False)
    a = _engine(st, num_slots=2, chunk_ticks=1).run(make())
    b = _step_loop(_engine(st, num_slots=2), make())
    for sid in a:
        assert np.array_equal(a[sid].states, b[sid].states)
        assert np.array_equal(a[sid].final_m, b[sid].final_m)


def test_resume_across_engines(specs):
    """final_m from a chunked run resumes on another engine."""
    _, st = specs
    u = _stream(np.random.default_rng(3), 12)
    _, full = compile_plan(st, impl="scan", device="cpu").drive(u)
    first = _engine(st, num_slots=2, chunk_ticks=3).run([StreamSession(sid=0, u_seq=u[:7])])[0]
    second = _engine(st, num_slots=2, chunk_ticks=3).run(
        [StreamSession(sid=1, u_seq=u[7:], m0=first.final_m)]
    )[1]
    stitched = np.concatenate([first.states, second.states])
    np.testing.assert_allclose(stitched, full.numpy(), atol=F32_ATOL)


def test_step_refuses_learning_engines_and_open_streams(specs):
    _, st = specs
    learner = _engine(st, learn="rls")
    learner.submit(StreamSession(sid=0, u_seq=np.zeros(3), targets=np.zeros(3)))
    with pytest.raises(RuntimeError, match="chunked"):
        learner.step()
    eng = _engine(st)
    eng.submit(StreamSession(sid=0, u_seq=np.zeros(3), open=True))
    with pytest.raises(RuntimeError, match="open"):
        eng.step()
    assert not _engine(st).step()  # nothing to do: drained


# -- the scheduler ---------------------------------------------------------------------


class TestScheduler:
    def test_fifo_order_and_slot_reuse(self):
        sched = SlotScheduler(2)
        for sid in range(4):
            sched.submit(f"s{sid}")
        placed = sched.admissions([0, 1])
        assert placed == [(0, "s0"), (1, "s1")]
        assert sched.admissions([]) == []
        assert sched.retire(0) == "s0"
        assert sched.admissions([0]) == [(0, "s2")]
        assert sched.stats.admitted == 3 and sched.stats.retired == 1

    def test_has_work(self):
        sched = SlotScheduler(1)
        assert not sched.has_work()
        sched.submit("x")
        assert sched.has_work()
        sched.admissions([0])
        assert sched.has_work()
        sched.retire(0)
        assert not sched.has_work()

    def test_detach_and_remove_queued_count_as_detached(self):
        sched = SlotScheduler(2)
        for sid in range(3):
            sched.submit(f"s{sid}")
        sched.admissions([0, 1])
        assert sched.detach(1) == "s1" and 1 not in sched.running
        assert sched.remove_queued("s2") and not sched.remove_queued("s2")
        assert sched.stats.detached == 2 and sched.stats.retired == 0
        assert not sched.queue and sched.has_work()


# -- checkpoint / restore (the engine-level halves of the migration contract) ----------


def test_midstream_migration_bit_exact(specs):
    _, st = specs
    u = _stream(np.random.default_rng(1))
    control = _serve_solo(st, u)
    src = _engine(st)
    src.submit(StreamSession(sid=7, u_seq=u.copy()))
    src.step_chunk()
    src.step_chunk()  # mid-stream: 10 of 23 ticks by the quiesce
    ck = src.checkpoint_session(7)
    assert ck.t == 10 and ck.states.shape == (10, N) and ck.m.shape == (N, 3)
    assert src.stats().detached == 1 and not src.scheduler.has_work()
    ck = pickle.loads(pickle.dumps(ck))  # host-only fields
    dst = _engine(st)
    dst.restore_session(ck)
    out = _drain(dst)[7]
    assert np.array_equal(out.states, control.states)
    assert np.array_equal(out.final_m, control.final_m)
    assert _drain(src) == {}  # detached, not retired


@pytest.mark.parametrize("learn", ["rls", "lms"])
def test_migration_with_inflight_learner(specs, learn):
    """The P and Wl lanes of a learner in flight ride the checkpoint (LMS: Wl
    alone); the learned readout finishes bit-identical to never moving."""
    _, st = specs
    kw = dict(learn=learn, learn_reg=1e-2, learn_mu=0.5)
    rng = np.random.default_rng(2)
    u, y = _stream(rng), _stream(rng)
    control = _serve_solo(st, u, targets=y.copy(), engine_kw=kw, learn_washout=3)
    src = _engine(st, **kw)
    src.submit(StreamSession(sid=1, u_seq=u.copy(), targets=y.copy(), learn_washout=3))
    src.step_chunk()
    src.step_chunk()  # the learner has absorbed ticks
    ck = src.checkpoint_session(1)
    assert ck.Wl.shape == (N + 1, 1) and ck.preds.shape == (10, 1)
    assert (ck.P is None) == (learn == "lms")
    if learn == "rls":
        assert ck.P.shape == (N + 1, N + 1)
    dst = _engine(st, **kw)
    dst.restore_session(ck)
    out = _drain(dst)[1]
    _assert_same(out, control)
    assert out.learn_nmse == control.learn_nmse


def test_migration_of_queued_session(specs):
    """A session still waiting for a slot migrates too (checkpoint at t = 0)
    and serves identically on the destination; the source serves the rest."""
    _, st = specs
    rng = np.random.default_rng(3)
    streams = [_stream(rng, 12) for _ in range(5)]
    control = _serve_solo(st, streams[4])
    src = _engine(st, num_slots=2)
    for i, u in enumerate(streams):
        src.submit(StreamSession(sid=i, u_seq=u.copy()))
    ck = src.checkpoint_session(4)
    assert ck.t == 0 and ck.m is None and ck.states is None
    dst = _engine(st)
    dst.restore_session(ck)
    assert np.array_equal(_drain(dst)[4].states, control.states)
    assert sorted(_drain(src)) == [0, 1, 2, 3]


def test_push_stream_equals_one_shot(specs):
    """An open stream fed in two pushes (the second after its lane idled)
    equals the same stream served in one piece; an all-idle boundary
    launches nothing and keeps the clock still."""
    _, st = specs
    rng = np.random.default_rng(4)
    u = _stream(rng)
    others = [_stream(rng, 7) for _ in range(3)]
    control = _serve_solo(st, u)
    eng = _engine(st)
    eng.submit(StreamSession(sid=0, u_seq=u[:9].copy(), open=True))
    for i, o in enumerate(others):
        eng.submit(StreamSession(sid=10 + i, u_seq=o.copy()))
    eng.run()  # returns with the open stream idle and resident
    assert 0 not in eng.results and eng.scheduler.running
    ticks = eng.tick_count
    assert not eng.step_chunk() and eng.tick_count == ticks
    eng.append_ticks(0, u[9:].copy())
    eng.close_session(0)
    res = eng.run()[0]
    assert np.array_equal(res.states, control.states)
    assert np.array_equal(res.final_m, control.final_m)
    assert sorted(eng.results) == [0, 10, 11, 12]


def test_push_learning_stream_and_empty_open_start(specs):
    """A learner submitted open with no rows, then pushed in two parts with
    its targets, equals the learner served in one piece. The push splits on
    a chunk boundary (K = 5): a block RLS update over other blocks is the
    same recursion summed in another order."""
    _, st = specs
    kw = dict(learn="rls", learn_reg=1e-2)
    rng = np.random.default_rng(5)
    u, y = _stream(rng, 17), _stream(rng, 17)
    control = _serve_solo(st, u, targets=y.copy(), engine_kw=kw, learn_washout=2)
    eng = _engine(st, **kw)
    eng.submit(
        StreamSession(sid=3, u_seq=np.zeros((0, 1), np.float32), targets=np.zeros((0, 1), np.float32),
                      learn_washout=2, open=True)
    )
    eng.run()
    for lo, hi in ((0, 10), (10, 17)):
        eng.append_ticks(3, u[lo:hi].copy(), y[lo:hi].copy())
        eng.run()
    eng.close_session(3)
    _assert_same(eng.run()[3], control)


def test_append_ticks_and_close_validation(specs):
    _, st = specs
    eng = _engine(st, learn="lms")
    eng.submit(StreamSession(sid=0, u_seq=np.zeros(3)))
    eng.submit(StreamSession(sid=1, u_seq=np.zeros(3), open=True))
    eng.submit(StreamSession(sid=2, u_seq=np.zeros(3), targets=np.zeros(3), open=True))
    with pytest.raises(ValueError, match="not an open stream"):
        eng.append_ticks(0, np.zeros(2))
    with pytest.raises(ValueError, match="inference-only"):
        eng.append_ticks(1, np.zeros(2), np.zeros(2))
    with pytest.raises(ValueError, match="target rows"):
        eng.append_ticks(2, np.zeros(2))
    with pytest.raises(ValueError, match="targets shape"):
        eng.append_ticks(2, np.zeros(2), np.zeros(3))
    with pytest.raises(KeyError):
        eng.close_session(99)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(StreamSession(sid=3, u_seq=np.zeros((0, 1))))


def _learn_rows(rng, k=3):
    return [(sid, _stream(rng, 13 + 4 * sid), _stream(rng, 13 + 4 * sid)) for sid in range(k)]


def test_snapshot_is_non_perturbing_and_restores(specs):
    """snapshot_sessions after every chunk leaves each stream (states,
    predictions, learned W) bit-identical to a run never snapshotted, and
    the last snapshot restored on a fresh engine finishes them alike."""
    _, st = specs
    kw = dict(learn="rls", learn_reg=1e-2, num_slots=2)
    rows = _learn_rows(np.random.default_rng(6))
    make = lambda: [  # noqa: E731
        StreamSession(sid=sid, u_seq=u.copy(), targets=y.copy(), learn_washout=2) for sid, u, y in rows
    ]
    clean = _engine(st, **kw).run(make())
    eng = _engine(st, **kw)
    for s in make():
        eng.submit(s)
    eng.step_chunk()
    snap = eng.snapshot_sessions()
    assert sorted(c.sid for c in snap) == [0, 1, 2]
    assert [c.t for c in snap] == [5, 5, 0]  # two resident, one queued
    while eng.step_chunk():
        eng.snapshot_sessions()
    for sid in clean:
        _assert_same(eng.results[sid], clean[sid])
    revived = _engine(st, **kw)
    for ck in snap:
        revived.restore_session(ck)
    got = _drain(revived)
    for sid in clean:
        _assert_same(got[sid], clean[sid])


def test_snapshot_leaves_out_quarantined_lanes(specs):
    _, st = specs
    eng = _engine(st)
    bad = StreamSession(sid=9, u_seq=np.full((12, 1), 0.2, np.float32),
                        params=st.params._replace(current=torch.tensor(float("nan"))))
    eng.submit(bad)
    eng.submit(StreamSession(sid=1, u_seq=_stream(np.random.default_rng(7), 20)))
    eng.step_chunk()
    eng.step_chunk()  # the harvest of chunk 1 flags sid 9
    assert [c.sid for c in eng.snapshot_sessions()] == [1]


def test_restore_rejects_foreign_specs_and_mismatched_learners(specs):
    _, st = specs
    eng = _engine(st, learn="rls")
    eng.submit(StreamSession(sid=0, u_seq=_stream(np.random.default_rng(8), 8),
                             targets=np.zeros((8, 1), np.float32)))
    eng.step_chunk()
    ck = eng.checkpoint_session(0)
    with pytest.raises(ValueError, match="learn_P0"):
        _engine(st, learn="lms").restore_session(ck)
    with pytest.raises(ValueError, match="learning engine"):
        _engine(st).restore_session(ck)
    # a checkpoint that carries the template's own spec restores into a
    # primary lane; one with ensemble-leaved params is refused
    same = _engine(st, learn="rls")
    same.restore_session(dataclasses.replace(ck, spec=st))
    assert same.stats().sub_engines == 0 and same.stats().queued == 1
    swept = st._replace(params=broadcast_params(st.params, 2))
    with pytest.raises(ValueError, match="scalar-leaved"):
        _engine(st, learn="rls").restore_session(dataclasses.replace(ck, spec=swept))


# -- against the reference ---------------------------------------------------------------


def _ref_engine(sj, **kw):
    return JEngine(sj, prewarm=False, **{**ENGINE_KW, **kw})


def _close(got, want, w_out=None):
    np.testing.assert_allclose(got.states, np.asarray(want.states), atol=F32_ATOL)
    np.testing.assert_allclose(got.final_m, np.asarray(want.final_m), atol=F32_ATOL)
    if w_out is not None:
        np.testing.assert_allclose(
            got.outputs, np.asarray(want.outputs), atol=F32_ATOL * np.abs(w_out).sum()
        )
    if want.learned_readout is not None:
        np.testing.assert_allclose(got.predictions, np.asarray(want.predictions), atol=ENGINE_ATOL)
        np.testing.assert_allclose(
            got.learned_readout.w_out.numpy(), np.asarray(want.learned_readout.w_out),
            atol=ENGINE_ATOL,
        )


def test_checkpoint_fields_match_reference():
    assert [f.name for f in dataclasses.fields(SessionCheckpoint)] == [
        f.name for f in dataclasses.fields(JCheckpoint)
    ]


def test_step_loop_matches_reference(specs):
    """The same sessions through the reference's step() loop and the port's
    (scan on both)."""
    sj, st = specs
    rng = np.random.default_rng(9)
    rows = [(sid, _stream(rng, (5, 9, 14)[sid % 3]), rng.normal(0, 0.3, (N + 1, 1)).astype(np.float32))
            for sid in range(7)]
    want = _step_loop(
        _ref_engine(sj, num_slots=3),
        [JSession(sid=sid, u_seq=u.copy(), readout=JReadout(jnp.asarray(w), 1)) for sid, u, w in rows],
    )
    got = _step_loop(
        _engine(st, num_slots=3),
        [StreamSession(sid=sid, u_seq=u.copy(), readout=convert.readout_from_numpy(w, 1, "cpu"))
         for sid, u, w in rows],
    )
    assert sorted(got) == sorted(want)
    for sid, u, w in rows:
        _close(got[sid], want[sid], w)
        assert (got[sid].admitted_tick, got[sid].finished_tick) == (
            want[sid].admitted_tick, want[sid].finished_tick)


def test_push_stream_matches_reference(specs):
    sj, st = specs
    rng = np.random.default_rng(10)
    u = _stream(rng)
    ref = _ref_engine(sj)
    ref.submit(JSession(sid=0, u_seq=u[:9].copy(), open=True))
    ref.run()
    ref.append_ticks(0, u[9:].copy())
    ref.close_session(0)
    want = ref.run()[0]
    eng = _engine(st)
    eng.submit(StreamSession(sid=0, u_seq=u[:9].copy(), open=True))
    eng.run()
    eng.append_ticks(0, u[9:].copy())
    eng.close_session(0)
    got = eng.run()[0]
    _close(got, want)
    assert (got.admitted_tick, got.finished_tick) == (want.admitted_tick, want.finished_tick)


@pytest.mark.parametrize("learn", [None, "rls"])
def test_reference_checkpoint_restores_on_the_port(specs, learn):
    """A session checkpointed mid-stream on the reference engine, restored
    on the port's through convert.checkpoint_from_numpy, finishes within
    tolerance of the reference's uninterrupted run."""
    sj, st = specs
    kw = {} if learn is None else dict(learn=learn, learn_reg=1e-2)
    rng = np.random.default_rng(11)
    u, y = _stream(rng), _stream(rng)
    w = rng.normal(0, 0.3, (N + 1, 1)).astype(np.float32)
    current = 2.4e-3

    def jsess(sid):
        return JSession(
            sid=sid, u_seq=u.copy(), readout=JReadout(jnp.asarray(w), 2),
            params=sj.params._replace(current=jnp.asarray(current, jnp.float32)),
            targets=None if learn is None else y.copy(), learn_washout=3,
        )

    want = _ref_engine(sj, **kw).run([jsess(0)])[0]
    ref = _ref_engine(sj, **kw)
    ref.submit(jsess(0))
    ref.step_chunk()
    ref.step_chunk()
    jck = ref.checkpoint_session(0)
    ck = convert.checkpoint_from_numpy(jck)
    assert ck.t == jck.t == 10
    assert float(ck.params.current) == pytest.approx(current)
    eng = _engine(st, **kw)
    eng.restore_session(ck)
    got = _drain(eng)[0]
    _close(got, want, w)
    assert got.states.shape == (23, N) and got.outputs.shape == (21, 1)
