"""Autoscale in the port's reservoir engine on the CPU: the bucket rule, the
policies, rescale accounting, and grow / shrink moving every occupied column
(learn columns included), port against port and against the JAX reference.

Restates tests/test_serve_chunked.py's TestAutoscale.

Tolerances:
  - a rescale moves columns, which is pure data movement: every occupied
    column (m, params, readout, P, Wl) is bit-equal across it; a session
    served across grows and shrinks is bit-equal to its replay alone at the
    same widths in the same slots (the engine's own CompiledSim per width,
    no column ever moved); a learner's W is bit-equal to fit_rls(block=K) /
    fit_lms over its harvested states (the learn tail computes a lane alike
    at any width on the CPU, tests/test_torch_rls.py).
  - against a run at one fixed width: F32_ATOL = 5e-5 on states and final_m
    (tests/test_torch_serve.py's bound), not bit-equality. The coupling
    GEMM's BLAS may round a lane differently at another ensemble width (on
    the CPU this was read at N = 10 for E < 9 and N = 100 for E < 5; a lane's
    position within one width never changed it).
  - port against the reference: F32_ATOL on states and final_m.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import make_spec as jmake_spec
from repro.serve.reservoir import ReservoirEngine as JEngine
from repro.serve.reservoir import StreamSession as JSession
from repro.serve.reservoir import _bucket_ladder as j_bucket_ladder
from repro.serve.reservoir import _bucket_slots as j_bucket_slots
from repro.serve.scheduler import QueueDepthPolicy as JQueueDepthPolicy
from repro_torch import convert
from repro_torch.api import ExecPlan, compile_plan
from repro_torch.core.ensemble import broadcast_params
from repro_torch.core.reservoir import fit_lms, fit_rls
from repro_torch.serve.reservoir import (
    ReservoirEngine,
    StreamSession,
    _apply_readouts_chunk,
    _bucket_ladder,
    _bucket_slots,
)
from repro_torch.serve.scheduler import AutoscalePolicy, QueueDepthPolicy, SlotScheduler

torch.set_num_threads(2)

F32_ATOL = 5e-5
N, HOLD = 10, 6


@pytest.fixture(scope="module")
def specs():
    sj = jmake_spec(N, n_in=1, seed=0, hold_steps=HOLD, dtype=jnp.float32)
    st = convert.spec_from_numpy(
        type(sj.params)(*[np.asarray(x) for x in sj.params]),
        np.asarray(sj.w_cp), np.asarray(sj.w_in), np.asarray(sj.m0), sj.dt,
        sj.hold_steps, device="cpu",
    )
    return sj, st


def _rows(count=20, seed=0, learn=False):
    rng = np.random.default_rng(seed)
    rows = []
    for sid in range(count):
        t = (6, 10, 14)[sid % 3]
        u = rng.uniform(0.0, 0.5, (t, 1)).astype(np.float32)
        w = rng.normal(0.0, 0.3, (N + 1, 1)).astype(np.float32)
        y = rng.normal(size=(t, 1)).astype(np.float32) if learn else None
        rows.append((sid, u, w, y))
    return rows


def _port_sessions(rows):
    return [
        StreamSession(sid=sid, u_seq=u.copy(), readout=convert.readout_from_numpy(w, 1, "cpu"),
                      targets=None if y is None else y.copy(), learn_washout=2)
        for sid, u, w, y in rows
    ]


def _logged(eng):
    """Record each launched chunk's width and, per served session, its slot,
    input rows and lane-mask column."""
    log = []
    launch = eng._launch_chunk

    def wrapped(plan):
        log.append((eng.num_slots, {
            sess.sid: (slot, plan.u[:, slot].copy(), plan.mask[:, slot].copy())
            for sess, slot, _ in plan.entries
        }))
        launch(plan)

    eng._launch_chunk = wrapped
    return log


def _expected_rescales(eng):
    """Count, as each rescale starts, whether the engine's rule must call it
    cold: a width it never served that PLAN_CACHE does not hold warm. The
    prewarm thread is joined first (it runs beside the chunks in between),
    so what it warmed is settled when the rule reads it."""
    from repro_torch.serve import reservoir

    served, expect = {eng.num_slots}, {"cold": 0, "warm": 0}
    rescale = eng._rescale

    def wrapped(new_e):
        if eng._prewarm_thread is not None:
            eng._prewarm_thread.join()
        plan = dataclasses.replace(eng.sim.plan, ensemble=new_e)
        warm = new_e in served or reservoir.PLAN_CACHE.is_warm(
            eng.sim.spec, plan, n_out=eng.store.n_out, device=eng.device
        )
        expect["warm" if warm else "cold"] += 1
        served.add(new_e)
        rescale(new_e)

    eng._rescale = wrapped
    return expect


def _replay(eng, log, sid, w_out):
    """Session sid alone through the engine's CompiledSim of each chunk's
    width, in the slot it had there, every other lane masked: the same
    session served with no column ever moved. Returns (states, final_m,
    outputs)."""
    spec = eng.res
    col = spec.m0.T  # (3, N)
    states, outs = [], []
    for e, entries in log:
        if sid not in entries:
            continue
        slot, u_col, mask_col = entries[sid]
        k = u_col.shape[0]
        m = spec.m0.T[:, :, None].expand(3, N, e).clone()
        m[:, :, slot] = col
        u = torch.zeros((k, e, 1))
        u[:, slot] = torch.from_numpy(u_col)
        mask = torch.zeros((k, e), dtype=torch.bool)
        mask[:, slot] = torch.from_numpy(mask_col)
        m, st = eng._sims[e].tick_chunk(m, u, lane_mask=mask)
        w = torch.zeros((e, N + 1, 1))
        w[slot] = torch.from_numpy(w_out)
        n = int(mask_col.sum())
        states.append(st[:n, :, slot])
        outs.append(_apply_readouts_chunk(st, w)[:n, slot])
        col = m[:, :, slot]
    return torch.cat(states).numpy(), col.T.numpy(), torch.cat(outs).numpy()


@pytest.mark.parametrize("backend", ["scan", "ref", "chunk", "fused", "tiled"])
def test_grow_and_shrink_preserve_dynamics(specs, backend):
    """A burst grows the batch (bucketed), the drain shrinks it; every
    session equals its replay at the same widths bit for bit, and its run at
    one fixed width within F32_ATOL."""
    _, st = specs
    rows = _rows()
    kw = dict(backend=backend, chunk_ticks=4, device="cpu")
    fixed = ReservoirEngine(st, num_slots=4, **kw).run(_port_sessions(rows))
    eng = ReservoirEngine(st, num_slots=4, autoscale=QueueDepthPolicy(), min_slots=2,
                          max_slots=16, **kw)
    log = _logged(eng)
    expect = _expected_rescales(eng)
    results = eng.run(_port_sessions(rows))
    assert len(results) == 20
    stats = eng.stats()
    assert stats.grows >= 1 and stats.shrinks >= 1
    assert len(eng._sims) >= 2  # one CompiledSim per bucket visited
    widths = {e for e, _ in log}
    assert len(widths) >= 2 and widths <= set(eng._sims)
    # the prewarm thread (on by default) ran beside the serving loop: every
    # session below is still bit-equal to its replay. A bucket's first visit
    # is cold unless PLAN_CACHE already held it warm; a revisit is warm.
    assert not eng.prewarm_errors
    assert stats.cold_rescales == expect["cold"] and stats.warm_rescales == expect["warm"]
    assert stats.cold_rescales + stats.warm_rescales == stats.grows + stats.shrinks
    assert stats.rescale_stall_s >= 0.0
    for sid, u, w, _ in rows:
        r = results[sid]
        states, final_m, outs = _replay(eng, log, sid, w)
        assert np.array_equal(r.states, states) and np.array_equal(r.final_m, final_m), sid
        assert np.array_equal(r.outputs, outs[1:]), sid  # readout washout 1
        np.testing.assert_allclose(r.states, fixed[sid].states, atol=F32_ATOL)
        np.testing.assert_allclose(r.final_m, fixed[sid].final_m, atol=F32_ATOL)


@pytest.mark.parametrize("learn", ["rls", "lms"])
def test_rescale_moves_learn_columns(specs, learn):
    """Learners streaming across grows and shrinks keep their P / W lanes:
    each learned W is bit-equal to the oracle over its harvested states."""
    _, st = specs
    rows = _rows(12, seed=1, learn=True)
    kw = dict(backend="scan", chunk_ticks=4, learn=learn, learn_reg=1e-2, learn_mu=0.7,
              device="cpu")
    eng = ReservoirEngine(st, num_slots=2, autoscale=True, min_slots=2, max_slots=8, **kw)
    results = eng.run(_port_sessions(rows))
    assert eng.stats().grows >= 1 and eng.stats().shrinks >= 1
    for sid, u, w, y in rows:
        r = results[sid]
        states = torch.from_numpy(r.states)
        w0 = torch.from_numpy(w)
        if learn == "rls":
            oracle = fit_rls(states, y, washout=2, reg=1e-2, block=4, w0=w0)
        else:
            oracle = fit_lms(states, y, washout=2, mu=0.7, w0=w0)
        assert torch.equal(r.learned_readout.w_out, oracle.w_out), sid


@pytest.mark.parametrize("learn", [None, "rls", "lms"])
def test_rescale_moves_every_column_exactly(specs, learn):
    """Across one grow and one shrink at a quiesced boundary, each resident
    session's m, params, readout, P and Wl columns come out bit-equal at its
    new slot, and the store's other lanes hold the template."""
    _, st = specs
    rows = _rows(5, seed=3, learn=learn is not None)
    kw = dict(backend="scan", chunk_ticks=4, learn=learn, learn_reg=1e-2, device="cpu")
    eng = ReservoirEngine(st, num_slots=8, autoscale=True, min_slots=2, max_slots=16, **kw)
    sessions = _port_sessions(rows)
    sessions[2].params = st.params._replace(current=torch.tensor(2.7e-3))
    for s in sessions:
        eng.submit(s)
    eng.step_chunk()
    eng.quiesce()  # 4 ticks served, every session resident
    assert len(eng.scheduler.running) == 5
    eng.store.retire(sessions[1]._slot)  # a hole below residents
    eng.scheduler.retire(sessions[1]._slot)

    def columns():
        store = eng.store
        out = {}
        for slot, sess in eng.scheduler.running.items():
            cols = [store.m[:, :, slot], store.w_out[slot],
                    torch.from_numpy(store._params_np[:, slot].copy())]
            if store.Wl is not None:
                cols.append(store.Wl[slot])
            if store.P is not None:
                cols.append(store.P[slot])
            out[sess.sid] = [c.clone() for c in cols]
        return out

    before = columns()
    assert len(before) == 4
    for width in (16, 4):
        eng._rescale(width)
        assert eng.num_slots == eng.store.num_slots == eng.sim.plan.ensemble == width
        after = columns()
        assert sorted(after) == sorted(before)
        for sid, cols in before.items():
            assert all(torch.equal(a, b) for a, b in zip(cols, after[sid])), sid
        slots = sorted(eng.scheduler.running)
        assert slots == list(range(4))
        assert eng.store.free_slots() == list(range(4, width))
        idle = eng.store.state_columns(list(range(4, width)))
        assert torch.equal(idle, st.m0.expand(width - 4, N, 3))
    assert eng.stats().grows == 1 and eng.stats().shrinks == 1
    assert len(eng.run()) == 4


def test_rescale_mid_stream_then_checkpoint(specs):
    """A learner moved by a grow checkpoints and restores at its new slot,
    in an engine of the same width."""
    _, st = specs
    rows = _rows(6, seed=2, learn=True)
    kw = dict(backend="scan", chunk_ticks=4, learn="rls", learn_reg=1e-2, device="cpu")
    fixed = ReservoirEngine(st, num_slots=8, **kw).run(_port_sessions(rows))
    eng = ReservoirEngine(st, num_slots=2, autoscale=True, min_slots=2, max_slots=8, **kw)
    for s in _port_sessions(rows):
        eng.submit(s)
    eng.step_chunk()
    assert eng.num_slots == 8
    eng.step_chunk()
    ck = eng.checkpoint_session(5)
    other = ReservoirEngine(st, num_slots=8, **kw)
    other.restore_session(ck)
    got = other.run()[5]
    assert torch.equal(got.learned_readout.w_out, fixed[5].learned_readout.w_out)
    assert np.array_equal(got.states, fixed[5].states)


def test_matches_reference_autoscale(specs):
    """The same burst through the reference's autoscaling engine and the
    port's: the same rescales, admissions and slots, states within
    F32_ATOL."""
    sj, st = specs
    rows = _rows()
    want = JEngine(
        sj, num_slots=4, backend="scan", chunk_ticks=4, prewarm=False,
        autoscale=JQueueDepthPolicy(), min_slots=2, max_slots=16,
    )
    want_res = want.run([JSession(sid=sid, u_seq=u.copy()) for sid, u, _, _ in rows])
    got = ReservoirEngine(st, num_slots=4, backend="scan", chunk_ticks=4, device="cpu",
                          autoscale=QueueDepthPolicy(), min_slots=2, max_slots=16)
    got_res = got.run([StreamSession(sid=sid, u_seq=u.copy()) for sid, u, _, _ in rows])
    js, ts = want.scheduler.stats, got.scheduler.stats
    assert (ts.grows, ts.shrinks) == (js.grows, js.shrinks)
    assert got.num_slots == want.num_slots
    for sid in want_res:
        a, b = got_res[sid], want_res[sid]
        np.testing.assert_allclose(a.states, np.asarray(b.states), atol=F32_ATOL)
        np.testing.assert_allclose(a.final_m, np.asarray(b.final_m), atol=F32_ATOL)
        assert (a.admitted_tick, a.finished_tick, a.slot) == (b.admitted_tick, b.finished_tick, b.slot)


def test_bucketing():
    assert _bucket_slots(1, 2, 16) == 2
    assert _bucket_slots(3, 2, 16) == 4
    assert _bucket_slots(9, 2, 16) == 16
    assert _bucket_slots(100, 2, 16) == 16
    assert _bucket_slots(5, 8, 64) == 8
    assert _bucket_ladder(2, 16) == [2, 4, 8, 16]
    assert _bucket_ladder(64, 256) == [64, 128, 256]
    assert _bucket_ladder(3, 20) == [3, 6, 12, 20]
    for lo, hi in ((1, 1), (2, 16), (3, 20), (64, 256)):
        assert _bucket_ladder(lo, hi) == j_bucket_ladder(lo, hi)
        for d in range(0, hi + 3):
            assert _bucket_slots(d, lo, hi) == j_bucket_slots(d, lo, hi)
            assert _bucket_slots(d, lo, hi) in _bucket_ladder(lo, hi)


def test_autoscale_true_uses_default_policy(specs):
    _, st = specs
    eng = ReservoirEngine(st, num_slots=2, backend="scan", autoscale=True, max_slots=8, device="cpu")
    assert isinstance(eng.autoscale, QueueDepthPolicy)
    assert (eng.min_slots, eng.max_slots) == (2, 8)
    assert ReservoirEngine(st, num_slots=2, backend="scan", device="cpu").autoscale is None


def test_custom_policy_plugs_in(specs):
    class AlwaysMax(AutoscalePolicy):
        def target_slots(self, *, active, queued, num_slots, min_slots, max_slots):
            return max_slots

    _, st = specs
    eng = ReservoirEngine(st, num_slots=2, backend="scan", chunk_ticks=2, device="cpu",
                          autoscale=AlwaysMax(), min_slots=2, max_slots=8)
    u = np.random.default_rng(1).uniform(0, 0.5, (4, 1)).astype(np.float32)
    eng.run([StreamSession(sid=0, u_seq=u)])
    assert eng.num_slots == 8 and eng.sim.plan.ensemble == 8
    assert eng.scheduler.stats.grows == 1
    with pytest.raises(NotImplementedError):
        AutoscalePolicy().target_slots(active=0, queued=0, num_slots=1, min_slots=1, max_slots=1)


def test_revisited_bucket_is_warm(specs):
    """A bucket compiled once is reused: the second grow is warm."""
    class Toggle(AutoscalePolicy):
        def __init__(self):
            self.n = 0

        def target_slots(self, *, active, queued, num_slots, min_slots, max_slots):
            self.n += 1
            return max_slots if self.n % 2 else min_slots

    _, st = specs
    eng = ReservoirEngine(st, num_slots=2, backend="scan", chunk_ticks=2, device="cpu",
                          autoscale=Toggle(), min_slots=2, max_slots=4)
    # bucket 4 is warm in PLAN_CACHE before serving starts: the construction's
    # prewarm thread (joined here) warmed it, or an earlier engine of this
    # process did. So the first grow is warm too, and every later rescale
    # revisits a bucket this engine served
    assert eng.prewarm_buckets(block=True) == ()
    assert not eng.prewarm_errors
    u = np.random.default_rng(2).uniform(0, 0.5, (9, 1)).astype(np.float32)
    eng.run([StreamSession(sid=0, u_seq=u)])
    s = eng.stats()
    assert s.grows >= 2 and s.shrinks >= 1
    assert s.cold_rescales == 0 and s.warm_rescales == s.grows + s.shrinks
    assert s.rescale_stall_s == 0.0
    assert sorted(eng._sims) == [2, 4]


def test_rejects_bad_bounds(specs):
    _, st = specs
    with pytest.raises(ValueError, match="min_slots"):
        ReservoirEngine(st, num_slots=4, backend="scan", autoscale=True, min_slots=8,
                        max_slots=16, device="cpu")
    with pytest.raises(ValueError, match="max_slots"):
        ReservoirEngine(st, num_slots=4, backend="scan", autoscale=True, max_slots=2, device="cpu")
    swept = st._replace(params=broadcast_params(st.params, 4))
    sim = compile_plan(swept, ExecPlan(impl="scan", ensemble=4), device="cpu")
    with pytest.raises(ValueError, match="scalar-leaved"):
        ReservoirEngine(sim, autoscale=True, max_slots=8)


def test_scheduler_load_signals():
    sched = SlotScheduler(4)
    for sid in range(3):
        sched.submit(f"s{sid}")
    assert sched.queue_depth() == 3
    sched.admissions([0, 1])
    sched.on_ticks(4, 8)
    assert sched.stats.slot_ticks == 16
    assert sched.occupancy() == pytest.approx(0.5)
    sched.admissions([2])  # s2 waited 4 ticks
    assert sched.stats.queue_wait_ticks == 4
    assert sched.mean_queue_wait() == pytest.approx(4 / 3)
    sched.remap({0: 0, 1: 1, 2: 2}, 8)
    assert sched.num_slots == 8 and sched.stats.grows == 1
    sched.remap({0: 1, 1: 0, 2: 2}, 4)
    assert sched.stats.shrinks == 1 and sorted(sched.running) == [0, 1, 2]
    assert sched.running[1] == "s0"
    sched.on_tick()
    assert sched.stats.slot_ticks == 20 and sched.stats.session_ticks == 11


@pytest.mark.parametrize("script", [
    [(0, 1), (9, 0), (0, 0), (0, 0), (1, 0), (0, 0), (0, 0)],
    [(3, 5), (2, 0), (1, 0), (1, 0), (5, 9), (0, 0), (2, 0), (2, 0)],
])
def test_queue_depth_policy_matches_reference(script):
    """The default policy's targets, step for step, against the reference's
    (grow on demand, shrink after `hysteresis` low boundaries)."""
    ours, theirs = QueueDepthPolicy(), JQueueDepthPolicy()
    width = 2
    for active, queued in script:
        kw = dict(active=active, queued=queued, num_slots=width, min_slots=2, max_slots=16)
        t = ours.target_slots(**kw)
        assert t == theirs.target_slots(**kw)
        width = _bucket_slots(max(t, active, 1), 2, 16)
