"""Mixed-spec tenancy in the port's engine, on the CPU: one engine, tenants
with different SimSpecs.

Restates the eight cases of tests/conformance/test_mixed_tenants.py: a
session that carries its own SimSpec is routed by structural hash — the
template's hash rides a primary lane (the spec's scalar params become the
lane values), another lands on a sub-engine drawn through PLAN_CACHE — and
every tenant's result is bit-identical to its spec served alone on a
dedicated engine (tenancy is an arrangement, never a numerical change).
Then the port against the reference: a mixed run's results, and a family
tenant checkpointed on the reference's engine restored on the port's
through convert.checkpoint_from_numpy, with the tolerances of
tests/test_torch_serve_lifecycle.py: states and final_m F32_ATOL = 5e-5, a
learner's predictions and learned W ENGINE_ATOL = 2e-3.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import make_array_transient_spec as jmake_array_transient_spec
from repro.api import make_spec as jmake_spec
from repro.api import make_time_multiplexed_spec as jmake_time_multiplexed_spec
from repro.serve.reservoir import ReservoirEngine as JEngine
from repro.serve.reservoir import StreamSession as JSession
from repro_torch import convert
from repro_torch.api import make_array_transient_spec, make_spec, make_time_multiplexed_spec
from repro_torch.core.ensemble import broadcast_params
from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

torch.set_num_threads(2)

F32_ATOL = 5e-5
ENGINE_ATOL = 2e-3
CPU = dict(device="cpu")


def _ca():
    return make_spec(8, hold_steps=5, **CPU)


def _tm():
    return make_time_multiplexed_spec(6, hold_steps=4, **CPU)


def _at():
    return make_array_transient_spec(8, readout_window=3, hold_steps=5, seed=3, **CPU)


def _engine(spec, **kw):
    return ReservoirEngine(spec, **{"num_slots": 4, "backend": "scan", "chunk_ticks": 4, **kw}, **CPU)


def _solo(spec, sid, u, **session_kw):
    eng = _engine(spec)
    eng.submit(StreamSession(sid=sid, u_seq=u, **session_kw))
    return eng.run()[sid]


class TestMixedSpecs:
    def test_three_families_one_engine_bitexact_vs_solo(self):
        rng = np.random.default_rng(0)
        spec_ca, spec_tm, spec_at = _ca(), _tm(), _at()
        u1, u2, u3 = (rng.uniform(0, 1, t).astype(np.float32) for t in (13, 17, 11))
        eng = _engine(spec_ca)
        eng.submit(StreamSession(sid=1, u_seq=u1))
        eng.submit(StreamSession(sid=2, u_seq=u2, spec=spec_tm))
        eng.submit(StreamSession(sid=3, u_seq=u3, spec=spec_at))
        res = eng.run()
        assert sorted(res) == [1, 2, 3]
        assert eng.stats().sub_engines == 2
        for sid, spec, u in ((1, spec_ca, u1), (2, spec_tm, u2), (3, spec_at, u3)):
            solo = _solo(spec, sid, u)
            assert np.array_equal(res[sid].states, solo.states)
            assert np.array_equal(res[sid].final_m, solo.final_m)

    def test_same_hash_spec_rides_a_primary_lane(self):
        rng = np.random.default_rng(1)
        base = _ca()
        tweaked = base._replace(
            params=base.params._replace(a_cp=torch.tensor(0.7), a_in=torch.tensor(1.3))
        )
        u = rng.uniform(0, 1, 13).astype(np.float32)
        eng = _engine(base)
        eng.submit(StreamSession(sid=9, u_seq=u, spec=tweaked))
        res = eng.run()[9]
        assert eng.stats().sub_engines == 0
        assert np.array_equal(res.states, _solo(tweaked, 9, u).states)
        assert not np.array_equal(res.states, _solo(base, 9, u).states)

    def test_explicit_session_params_beat_spec_params(self):
        base = _ca()
        tweaked = base._replace(params=base.params._replace(a_cp=torch.tensor(0.7)))
        u = np.random.default_rng(2).uniform(0, 1, 9).astype(np.float32)
        eng = _engine(base, num_slots=2)
        eng.submit(StreamSession(sid=1, u_seq=u, params=base.params, spec=tweaked))
        res = eng.run()[1]
        assert np.array_equal(res.states, _solo(base, 1, u).states)

    def test_one_subengine_per_distinct_hash(self):
        rng = np.random.default_rng(3)
        eng = _engine(_ca())
        spec_tm = _tm()
        for sid in (1, 2, 3):
            u = rng.uniform(0, 1, 8).astype(np.float32)
            # a twin built anew routes to the same sub-engine (same hash)
            eng.submit(StreamSession(sid=sid, u_seq=u, spec=spec_tm if sid < 3 else _tm()))
        res = eng.run()
        assert sorted(res) == [1, 2, 3]
        assert eng.stats().sub_engines == 1

    def test_ensemble_leaved_session_spec_refused(self):
        spec_ca = _ca()
        swept = spec_ca._replace(params=broadcast_params(spec_ca.params, 4))
        eng = _engine(spec_ca, num_slots=2)
        with pytest.raises(ValueError, match="scalar-leaved"):
            eng.submit(StreamSession(sid=1, u_seq=np.ones(4, np.float32), spec=swept))

    def test_chunk_template_gives_a_transient_tenant_auto(self):
        """array_transient's "chunk" is the eager plain body, so a chunk
        template's array_transient sub-engine resolves "auto" (on the CPU
        the plain "ref", bit-equal to "chunk"); a time_multiplexed tenant
        keeps the template's "chunk"."""
        rng = np.random.default_rng(5)
        u_at, u_tm = (rng.uniform(0, 1, t).astype(np.float32) for t in (11, 9))
        eng = _engine(_ca(), backend="chunk")
        eng.submit(StreamSession(sid=1, u_seq=u_at, spec=_at()))
        eng.submit(StreamSession(sid=2, u_seq=u_tm, spec=_tm()))
        res = eng.run()
        subs = {sub.sim.spec.topology: sub for sub in eng._subengines.values()}
        assert subs["array_transient"].sim.plan.impl == "auto"
        assert subs["array_transient"].backend == "ref"
        assert subs["time_multiplexed"].backend == "chunk"
        solo = _engine(_at(), backend="chunk")
        solo.submit(StreamSession(sid=1, u_seq=u_at))
        want = solo.run()[1]
        assert np.array_equal(res[1].states, want.states)
        assert np.array_equal(res[1].final_m, want.final_m)

    def test_per_tick_step_refuses_mixed_specs(self):
        eng = ReservoirEngine(_ca(), num_slots=2, backend="scan", **CPU)
        eng.submit(StreamSession(sid=1, u_seq=np.ones(4, np.float32), spec=_tm()))
        with pytest.raises(RuntimeError, match="chunked path"):
            eng.step()


class TestMixedSpecLifecycle:
    def test_learning_tenant_checkpoint_migrates_bitexact(self):
        """A learning time_multiplexed tenant on a coupled-array engine,
        checkpointed mid-stream, pickled, restored into a fresh engine: the
        whole stream matches a never-migrated solo run bit for bit."""
        rng = np.random.default_rng(1)
        spec_ca, spec_tm = _ca(), _tm()
        u = rng.uniform(0, 1, 16).astype(np.float32)
        y = rng.uniform(0, 1, 16).astype(np.float32)
        src = _engine(spec_ca, learn="rls")
        src.submit(StreamSession(sid=5, u_seq=u, targets=y, learn_washout=2, spec=spec_tm))
        for _ in range(3):
            src.step_chunk()
        ckpt = pickle.loads(pickle.dumps(src.checkpoint_session(5)))
        assert ckpt.spec is not None and ckpt.spec.topology == "time_multiplexed"
        assert ckpt.spec.device.type == "cpu" and 0 < ckpt.t < len(u)
        dst = _engine(spec_ca, learn="rls")
        dst.restore_session(ckpt)
        res = dst.run()[5]
        solo_eng = _engine(spec_tm, learn="rls")
        solo_eng.submit(StreamSession(sid=5, u_seq=u, targets=y, learn_washout=2))
        solo = solo_eng.run()[5]
        assert np.array_equal(res.states, solo.states)
        assert np.array_equal(res.predictions, solo.predictions)
        assert torch.equal(res.learned_readout.w_out, solo.learned_readout.w_out)

    def test_push_stream_reaches_subengine_tenant(self):
        rng = np.random.default_rng(4)
        spec_tm = _tm()
        u_all = rng.uniform(0, 1, 12).astype(np.float32)
        eng = _engine(_ca(), num_slots=2)
        eng.submit(StreamSession(sid=7, u_seq=u_all[:6], open=True, spec=spec_tm))
        for _ in range(3):
            eng.step_chunk()
        eng.append_ticks(7, u_all[6:])
        eng.close_session(7)
        res = eng.run()[7]
        solo = _solo(spec_tm, 7, u_all)
        assert np.array_equal(res.states, solo.states)
        assert np.array_equal(res.final_m, solo.final_m)

    def test_snapshots_cover_subengine_tenants(self):
        rng = np.random.default_rng(6)
        eng = _engine(_ca())
        eng.submit(StreamSession(sid=1, u_seq=rng.uniform(0, 1, 12).astype(np.float32)))
        eng.submit(StreamSession(sid=2, u_seq=rng.uniform(0, 1, 12).astype(np.float32),
                                 spec=_at()))
        eng.step_chunk()
        snaps = {c.sid: c for c in eng.snapshot_sessions()}
        assert sorted(snaps) == [1, 2]
        assert snaps[1].spec is None and snaps[2].spec.topology == "array_transient"
        assert sorted(eng.run()) == [1, 2]


# -- against the reference ---------------------------------------------------------


def _jspecs():
    return (
        jmake_spec(8, hold_steps=5),
        jmake_time_multiplexed_spec(6, hold_steps=4),
        jmake_array_transient_spec(8, readout_window=3, hold_steps=5, seed=3),
    )


@pytest.mark.parametrize("backend", ["scan", "chunk"])
def test_mixed_run_matches_reference(backend):
    """The same three tenants through the reference's engine and the
    port's, with the same backend."""
    rng = np.random.default_rng(8)
    us = [rng.uniform(0, 1, t).astype(np.float32) for t in (13, 17, 11)]
    jca, jtm, jat = _jspecs()
    ref = JEngine(jca, num_slots=4, backend=backend, chunk_ticks=4)
    for sid, (u, spec) in enumerate(zip(us, (None, jtm, jat))):
        ref.submit(JSession(sid=sid, u_seq=u.copy(), spec=spec))
    want = ref.run()
    eng = _engine(_ca(), backend=backend)
    for sid, (u, spec) in enumerate(zip(us, (None, _tm(), _at()))):
        eng.submit(StreamSession(sid=sid, u_seq=u.copy(), spec=spec))
    got = eng.run()
    assert eng.stats().sub_engines == ref.stats().sub_engines == 2
    for sid in range(3):
        np.testing.assert_allclose(got[sid].states, want[sid].states, rtol=0, atol=F32_ATOL)
        np.testing.assert_allclose(got[sid].final_m, np.asarray(want[sid].final_m), rtol=0,
                                   atol=F32_ATOL)


def test_reference_family_checkpoint_restores_on_the_port():
    """A learning time_multiplexed tenant checkpointed mid-stream on the
    reference's coupled-array engine, restored on the port's through
    convert.checkpoint_from_numpy: it routes to a family sub-engine and
    finishes within tolerance of the reference's uninterrupted run."""
    rng = np.random.default_rng(12)
    u = rng.uniform(0, 1, 16).astype(np.float32)
    y = rng.uniform(0, 1, 16).astype(np.float32)
    jca, jtm, _ = _jspecs()
    kw = dict(num_slots=4, backend="scan", chunk_ticks=4, learn="rls", learn_reg=1e-2)

    def jsess():
        return JSession(sid=3, u_seq=u.copy(), targets=y.copy(), learn_washout=2, spec=jtm)

    want = JEngine(jca, **kw).run([jsess()])[3]
    ref = JEngine(jca, **kw)
    ref.submit(jsess())
    for _ in range(2):
        ref.step_chunk()
    jck = ref.checkpoint_session(3)
    ck = convert.checkpoint_from_numpy(jck)
    assert ck.t == jck.t > 0 and ck.spec.topology == "time_multiplexed"
    eng = _engine(_ca(), learn="rls", learn_reg=1e-2)
    eng.restore_session(ck)
    got = eng.run()[3]
    assert eng.stats().sub_engines == 1
    np.testing.assert_allclose(got.states, want.states, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got.predictions, want.predictions, rtol=0, atol=ENGINE_ATOL)
    np.testing.assert_allclose(
        got.learned_readout.w_out.numpy(), np.asarray(want.learned_readout.w_out), rtol=0,
        atol=ENGINE_ATOL,
    )
