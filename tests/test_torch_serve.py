"""The port's serving engine against the JAX reference's, on the CPU.

About twenty sessions of mixed length, with per-tenant params on some lanes
and a readout on each, stream through the reference's
ReservoirEngine(backend="ref", chunk_ticks=4) and through the port's engine
for every backend (on the CPU each runs its kernel's plain version).
Tolerance: F32_ATOL = 5e-5 on states and final_m (tests/test_kernels_sto.py's
f32 bound); outputs are a readout of N+1 states, so OUT_ATOL = ||w_out||_1 *
F32_ATOL bounds them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import make_spec as jmake_spec
from repro.core.reservoir import Readout as JReadout
from repro.serve.reservoir import ReservoirEngine as JEngine
from repro.serve.reservoir import StreamSession as JSession
from repro_torch import convert
from repro_torch.api import cache
from repro_torch.core.constants import STOParams
from repro_torch.core.ensemble import broadcast_params
from repro_torch.kernels import _build
from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

torch.set_num_threads(2)

F32_ATOL = 5e-5
N, SLOTS, K, HOLD, N_SESSIONS = 12, 4, 4, 3, 20


def _workload(seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for sid in range(N_SESSIONS):
        t = int(rng.integers(2, 11))  # lengths straddle chunk boundaries
        u = rng.uniform(0.0, 0.5, (t, 1)).astype(np.float32)
        w = rng.normal(0.0, 0.3, (N + 1, 1)).astype(np.float32)
        current = float(rng.uniform(2e-3, 3e-3)) if sid % 3 == 0 else None
        rows.append((sid, u, w, current))
    return rows


@pytest.fixture(scope="module")
def spec_pair():
    sj = jmake_spec(N, n_in=1, seed=2, hold_steps=HOLD, dtype=jnp.float32)
    st = convert.spec_from_numpy(
        type(sj.params)(*[np.asarray(x) for x in sj.params]),
        np.asarray(sj.w_cp), np.asarray(sj.w_in), np.asarray(sj.m0), sj.dt,
        sj.hold_steps, device="cpu",
    )
    return sj, st


@pytest.fixture(scope="module")
def reference_results(spec_pair):
    sj, _ = spec_pair
    eng = JEngine(sj, num_slots=SLOTS, backend="ref", chunk_ticks=K, prewarm=False)
    sessions = []
    for sid, u, w, current in _workload():
        params = None if current is None else sj.params._replace(current=jnp.asarray(current, jnp.float32))
        sessions.append(JSession(sid=sid, u_seq=u, params=params, readout=JReadout(jnp.asarray(w), 1)))
    return eng.run(sessions)


def _port_sessions(st):
    sessions = []
    for sid, u, w, current in _workload():
        params = None
        if current is not None:
            params = st.params._replace(current=torch.tensor(current, dtype=torch.float32))
        sessions.append(
            StreamSession(sid=sid, u_seq=u, params=params, readout=convert.readout_from_numpy(w, 1, "cpu"))
        )
    return sessions


@pytest.mark.parametrize("backend", ["ref", "chunk", "fused", "tiled"])
def test_engine_matches_reference(spec_pair, reference_results, backend):
    _, st = spec_pair
    eng = ReservoirEngine(st, num_slots=SLOTS, backend=backend, chunk_ticks=K, device="cpu")
    sessions = _port_sessions(st)
    got = eng.run(sessions)
    assert len(got) == len(reference_results) == N_SESSIONS
    for sess in sessions:
        a, b = got[sess.sid], reference_results[sess.sid]
        np.testing.assert_allclose(a.states, np.asarray(b.states), atol=F32_ATOL)
        np.testing.assert_allclose(a.final_m, np.asarray(b.final_m), atol=F32_ATOL)
        out_atol = F32_ATOL * np.abs(sess.readout.w_out.numpy()).sum()
        np.testing.assert_allclose(a.outputs, np.asarray(b.outputs), atol=out_atol)
        assert (a.admitted_tick, a.finished_tick) == (b.admitted_tick, b.finished_tick)
        assert a.error is None
    stats = eng.stats()
    assert stats.session_ticks == sum(len(s.u_seq) for s in sessions)
    assert tuple(eng.store.params_vec.shape) == (10, SLOTS)
    assert stats.backend == backend and stats.active == stats.queued == 0


def test_double_buffer_equals_one_chunk_at_a_time(spec_pair):
    _, st = spec_pair
    piped = ReservoirEngine(st, num_slots=SLOTS, backend="chunk", chunk_ticks=K, device="cpu")
    a = piped.run(_port_sessions(st))
    drained = ReservoirEngine(st, num_slots=SLOTS, backend="chunk", chunk_ticks=K, device="cpu")
    for s in _port_sessions(st):
        drained.submit(s)
    while drained.step_chunk():
        drained.quiesce()  # harvest each chunk before the next launches
    b = drained.results
    assert sorted(a) == sorted(b)
    for sid in a:
        assert np.array_equal(a[sid].states, b[sid].states)
        assert np.array_equal(a[sid].outputs, b[sid].outputs)
        assert np.array_equal(a[sid].final_m, b[sid].final_m)


def test_nan_guard_quarantines_only_the_bad_lane(spec_pair):
    _, st = spec_pair
    clean = ReservoirEngine(st, num_slots=SLOTS, backend="chunk", chunk_ticks=K, device="cpu")
    base = clean.run(_port_sessions(st))
    eng = ReservoirEngine(st, num_slots=SLOTS, backend="chunk", chunk_ticks=K, device="cpu")
    sessions = _port_sessions(st)
    bad = StreamSession(
        sid=99, u_seq=np.full((9, 1), 0.2, np.float32),
        params=st.params._replace(current=torch.tensor(float("nan"))),
    )
    got = eng.run([bad] + sessions)
    assert got[99].error is not None and "non_finite_state" in got[99].error
    assert eng.stats().quarantined_lanes == 1
    for sess in sessions:
        assert got[sess.sid].error is None
        assert np.array_equal(got[sess.sid].states, base[sess.sid].states)


def test_pop_results_and_max_retained(spec_pair):
    _, st = spec_pair
    eng = ReservoirEngine(st, num_slots=SLOTS, chunk_ticks=K, max_retained=3, device="cpu")
    eng.run(_port_sessions(st))
    assert len(eng.results) == 3
    popped = eng.pop_results()
    assert len(popped) == 3 and eng.results == {}
    assert eng.backend == "ref"  # auto on the CPU


def test_submit_contract_and_waiting_features(spec_pair, tmp_path, monkeypatch):
    _, st = spec_pair
    # enable_persistent_cache pins process-wide state: restore it afterwards
    monkeypatch.setattr(_build, "_PINNED_DIR", None)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    eng = ReservoirEngine(st, num_slots=SLOTS, chunk_ticks=K, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(StreamSession(sid=0, u_seq=np.zeros((0, 1))))
    with pytest.raises(ValueError):
        eng.submit(StreamSession(sid=0, u_seq=np.zeros((1, 5))))
    with pytest.raises(ValueError):
        eng.submit(
            StreamSession(sid=0, u_seq=np.zeros(3), readout=convert.readout_from_numpy(np.zeros((5, 1)), 0, "cpu"))
        )
    # targets need a learning engine (the reference's ValueError)
    with pytest.raises(ValueError, match="learning"):
        eng.submit(StreamSession(sid=1, u_seq=np.zeros(3), targets=np.zeros(3)))
    # mixed-spec tenancy is served (a spec of the template's hash rides a
    # primary lane; an ensemble-leaved one is refused); the plan cache's
    # options are served: prewarm without autoscale has no bucket to warm,
    # and compilation_cache_dir pins the kernel library's build directory
    eng.submit(StreamSession(sid=1, u_seq=np.zeros(3), spec=st))
    assert eng.stats().sub_engines == 0 and eng.stats().queued == 1
    eng.scheduler.remove_queued(eng._find_session(1)[1])
    with pytest.raises(ValueError, match="scalar-leaved"):
        eng.submit(StreamSession(sid=1, u_seq=np.zeros(3), spec=st._replace(
            params=broadcast_params(st.params, 2))))
    warmed = ReservoirEngine(st, num_slots=SLOTS, prewarm=True, device="cpu")
    assert warmed._prewarm_thread is None and warmed.prewarm_buckets(block=True) == ()
    cache_dir = str(tmp_path / "x")
    pinned = ReservoirEngine(st, num_slots=SLOTS, compilation_cache_dir=cache_dir, device="cpu")
    assert cache.persistent_cache_dir() == cache_dir and _build.BUILD_DIR == (tmp_path / "x").resolve()
    assert pinned.sim is warmed.sim  # the key leaves the directory out
    # push streams and autoscale are served: an empty stream is refused
    # unless it is open
    eng.submit(StreamSession(sid=2, u_seq=np.zeros((0, 1)), open=True))
    assert eng._find_session(2)[1].open
    assert ReservoirEngine(st, num_slots=SLOTS, autoscale=True, device="cpu").autoscale is not None
    with pytest.raises(TypeError):
        ReservoirEngine(st, num_slots=SLOTS, bogus=1, device="cpu")
    with pytest.raises(TypeError):
        ReservoirEngine(st, device="cpu")


def test_params_from_numpy_forms():
    leaves = [np.float32(i + 1) for i in range(len(STOParams._fields))]
    a = convert.params_from_numpy(leaves, device="cpu")
    b = convert.params_from_numpy(dict(zip(STOParams._fields, leaves)), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        convert.params_from_numpy(leaves[:3], device="cpu")
