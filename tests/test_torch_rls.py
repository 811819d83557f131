"""Online readout learning in the port (kernels/rls.py, fit_rls / fit_lms,
ExecPlan.learn, the learning engine) against the JAX reference, on the CPU.
Mirrors tests/test_rls_learning.py without autoscale, sharded plans,
checkpoints and the per-tick step() (not ported yet).

Contracts, with their tolerances:
  - the update and chunk functions, and tick_chunk's learn outputs, agree
    with the reference's on the same numbers: f64 1e-10, f32 UPD_RTOL = 1e-5
    relative to the largest magnitude (one f32 rounding per op, sums in
    another order; P = I / reg starts at 1e2 here);
  - on the CPU the lane-0 result at batch width E is bit-equal to the E = 1
    run (every reduction a multiply + trailing sum or a batched GEMM; at
    K = 1 the P' outer product an elementwise multiply-add), and
    P' = baddbmm(P, ...) is bit-equal to P - bmm(...);
  - a served lane's learned W equals the port's fit_rls(block=K) / fit_lms
    over its harvested states bit for bit on the scan backend (and on every
    planes backend, whose learn tail is the same torch code);
  - fit_rls(lam=1) matches fit_ridge to 2e-3 (float roundoff of two
    algorithms); fit_rls / fit_lms match the reference's over 400-600 rows
    to FIT_F32_ATOL = 5e-4 in f32 (roundoff accumulated over the rank-1
    updates, |W| ~ 0.1-1) and 1e-10 in f64; NARMA-10 online NMSE within 5 %
    of ridge;
  - the planes backends learn within the reference's atol of scan (P, W
    1e-2; predictions 1e-3);
  - the engine against the reference's engine on the same sessions (spec
    and warm-start weights carried across): states 5e-5, predictions and
    learned W ENGINE_ATOL = 2e-3 (the 5e-5 state differences, amplified by
    the gain of an RLS with reg = 1e-2 over <= 14 samples).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecPlan as JPlan
from repro.api import compile_plan as jcompile
from repro.api import make_spec as jmake_spec
from repro.core import reservoir as jres
from repro.core.reservoir import Readout as JReadout
from repro.kernels import ops as jops
from repro.kernels import rls as jrls
from repro.serve.reservoir import ReservoirEngine as JEngine
from repro.serve.reservoir import StreamSession as JSession
from repro_torch import convert
from repro_torch.api import ExecPlan, compile_plan, make_spec
from repro_torch.core import constants, fit_lms, fit_ridge, fit_rls, nmse, predict, tasks
from repro_torch.core.reservoir import Readout
from repro_torch.kernels import ops
from repro_torch.kernels import rls as krls
from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

torch.set_num_threads(2)

ATOL = 5e-5
UPD_RTOL = 1e-5
F64_ATOL = 1e-10
ENGINE_ATOL = 2e-3
FIT_F32_ATOL = 5e-4
TDT = {"f32": torch.float32, "f64": torch.float64}
JDT = {"f32": jnp.float32, "f64": jnp.float64}


def _t(*arrays, dtype=None):
    return [torch.tensor(np.asarray(a), dtype=dtype) for a in arrays]


def _learn_inputs(rng, k, e, s, o, dt):
    f = np.float32 if dt == "f32" else np.float64
    a = rng.normal(size=(e, s, s))
    p = (np.eye(s)[None] * 100.0 + 0.1 * (a + a.transpose(0, 2, 1))).astype(f)
    w = rng.normal(size=(e, s, o)).astype(f)
    x = rng.normal(size=(k, e, s)).astype(f)
    y = rng.normal(size=(k, e, o)).astype(f)
    mask = rng.uniform(size=(k, e)) > 0.25
    mask[:, 0] = True
    return p, w, x, y, mask


def _assert_close(got, want, dt):
    for a, b in zip(got, want):
        b = np.asarray(b)
        if dt == "f64":
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=F64_ATOL * max(1.0, np.abs(b).max()))
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=UPD_RTOL * np.abs(b).max())


# -- the update and chunk functions against the reference --------------------


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("lam", [1.0, 0.99])
def test_rls_update_and_chunk_match_reference(lam, dt):
    rng = np.random.default_rng(0)
    for k in (1, 6):
        p, w, x, y, mask = _learn_inputs(rng, k, 4, 9, 2, dt)
        with jax.enable_x64(True):
            want_u = [np.asarray(v) for v in jrls.rls_update(*map(jnp.asarray, (p, w, x[0], y[0], mask[0])), lam)]
            want_c = [np.asarray(v) for v in jrls.rls_chunk(*map(jnp.asarray, (p, w, x, y, mask)), lam)]
        pt, wt, xt, yt, mt = _t(p, w, x, y, mask)
        _assert_close(krls.rls_update(pt, wt, xt[0], yt[0], mt[0], lam), want_u, dt)
        _assert_close(krls.rls_chunk(pt, wt, xt, yt, mt, lam), want_c, dt)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_lms_update_and_chunk_match_reference(dt):
    rng = np.random.default_rng(1)
    _, w, x, y, mask = _learn_inputs(rng, 5, 4, 9, 2, dt)
    with jax.enable_x64(True):
        want_u = [np.asarray(v) for v in jrls.lms_update(*map(jnp.asarray, (w, x[0], y[0], mask[0])), 0.7)]
        want_c = [np.asarray(v) for v in jrls.lms_chunk(*map(jnp.asarray, (w, x, y, mask)), 0.7)]
    wt, xt, yt, mt = _t(w, x, y, mask)
    _assert_close(krls.lms_update(wt, xt[0], yt[0], mt[0], 0.7), want_u, dt)
    _assert_close(krls.lms_chunk(wt, xt, yt, mt, 0.7), want_c, dt)


def test_init_matches_reference():
    p, w = krls.rls_init(3, 5, 2, 1e-2, torch.float32, device="cpu")
    pj, wj = jrls.rls_init(3, 5, 2, 1e-2, jnp.float32)
    assert np.array_equal(p.numpy(), np.asarray(pj)) and np.array_equal(w.numpy(), np.asarray(wj))
    assert np.array_equal(krls.lms_init(3, 5, 2, torch.float32, device="cpu").numpy(), np.asarray(jrls.lms_init(3, 5, 2, jnp.float32)))
    with pytest.raises(ValueError, match="reg"):
        krls.rls_init(1, 3, 1, 0.0, torch.float32, device="cpu")


# -- lane stability and masking, on the CPU ------------------------------------


@pytest.mark.parametrize("s", [9, 33, 257])
@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("e", [2, 5, 8])
def test_batch_width_bit_stability(k, e, s):
    """Lane 0 of an E-lane update / chunk == the E = 1 run, bit for bit:
    what a served lane == the E = 1 oracle rests on. (At K = 1 and S = 33 a
    batched GEMM of inner size 1 for P' failed this; rls_chunk uses an
    elementwise multiply-add there.)"""
    rng = np.random.default_rng(5)
    p, w, x, y, mask = _learn_inputs(rng, k, 1, s, 2, "f32")
    mask[min(4, k - 1)] = False
    many = lambda a, axis: torch.tensor(np.repeat(a, e, axis))  # noqa: E731
    one = _t(p, w, x, y, mask)
    wide = [many(p, 0), many(w, 0), many(x, 1), many(y, 1), many(mask, 1)]
    for lam in (1.0, 0.99):
        a, b = krls.rls_chunk(*one, lam), krls.rls_chunk(*wide, lam)
        assert torch.equal(a[0][0], b[0][0]) and torch.equal(a[1][0], b[1][0])
        assert torch.equal(a[2][:, 0], b[2][:, 0])
        a = krls.rls_update(one[0], one[1], one[2][0], one[3][0], one[4][0], lam)
        b = krls.rls_update(wide[0], wide[1], wide[2][0], wide[3][0], wide[4][0], lam)
        assert all(torch.equal(u[0], v[0]) for u, v in zip(a, b))
    a, b = krls.lms_chunk(*one[1:], 0.5), krls.lms_chunk(*wide[1:], 0.5)
    assert torch.equal(a[0][0], b[0][0]) and torch.equal(a[1][:, 0], b[1][:, 0])


@pytest.mark.parametrize("e,s,k", [(1, 9, 6), (5, 33, 8), (2, 257, 8)])
def test_p_update_spelling_is_bit_equal(e, s, k):
    """rls_chunk forms P' with baddbmm (no second (E, S, S) temporary); on
    the CPU that is bit-equal to P - bmm(gains^T, px)."""
    g = torch.Generator().manual_seed(e * s)
    p, gst, pxst = (torch.randn(sh, generator=g) for sh in ((e, s, s), (e, k, s), (e, k, s)))
    ref = p - torch.bmm(gst.transpose(1, 2), pxst)
    assert torch.equal(torch.baddbmm(p, gst.transpose(1, 2), pxst, alpha=-1), ref)
    assert torch.equal(p.clone().baddbmm_(gst.transpose(1, 2), pxst, alpha=-1), ref)


def test_masked_update_is_bit_frozen():
    rng = np.random.default_rng(3)
    p, w, x, y, _ = _learn_inputs(rng, 3, 2, 4, 1, "f32")
    p, w, x, y = _t(p, w, x, y)
    mask = torch.tensor([True, False])
    for lam in (1.0, 0.9):
        p2, w2, pred = krls.rls_update(p, w, x[0], y[0], mask, lam)
        assert torch.equal(p2[1], p[1]) and torch.equal(w2[1], w[1])
        assert not torch.equal(p2[0], p[0])
        np.testing.assert_allclose(pred[1].numpy(), (w[1].T @ x[0, 1]).numpy(), rtol=1e-6)
        pc, wc, _ = krls.rls_chunk(p, w, x, y, mask[None].expand(3, 2), lam)
        assert torch.equal(pc[1], p[1]) and torch.equal(wc[1], w[1])
    w2, pred = krls.lms_update(w, x[0], y[0], mask, 0.5)
    assert torch.equal(w2[1], w[1]) and not torch.equal(w2[0], w[0])


# -- the offline oracles ----------------------------------------------------------


def test_fit_rls_lam_one_matches_ridge_and_reference():
    rng = np.random.default_rng(0)
    states = rng.normal(size=(400, 12)).astype(np.float32)
    targets = rng.normal(size=(400, 2)).astype(np.float32)
    ridge = fit_ridge(torch.tensor(states), targets, washout=20, reg=1e-2)
    rls = fit_rls(torch.tensor(states), targets, washout=20, reg=1e-2, lam=1.0)
    np.testing.assert_allclose(rls.w_out.numpy(), ridge.w_out.numpy(), atol=2e-3)
    assert rls.washout == 20
    # against the reference's oracle: f32 roundoff over 400 rank-1 updates
    # (read: 6.1e-5 at |W| ~ 0.1), and f64 to 1e-10
    want = jres.fit_rls(states, targets, washout=20, reg=1e-2, lam=1.0, block=8)
    got = fit_rls(torch.tensor(states), targets, washout=20, reg=1e-2, lam=1.0, block=8)
    np.testing.assert_allclose(got.w_out.numpy(), np.asarray(want.w_out), atol=FIT_F32_ATOL)
    with jax.enable_x64(True):
        want = np.asarray(
            jres.fit_rls(states.astype(np.float64), targets, washout=20, reg=1e-2, lam=0.99, block=8).w_out
        )
    got = fit_rls(torch.tensor(states, dtype=torch.float64), targets, washout=20, reg=1e-2, lam=0.99, block=8)
    np.testing.assert_allclose(got.w_out.numpy(), want, rtol=0, atol=F64_ATOL)


@pytest.mark.parametrize("lam", [1.0, 0.99])
def test_fit_rls_blocks_solve_the_sequential_problem(lam):
    rng = np.random.default_rng(4)
    states = torch.tensor(rng.normal(size=(203, 10)).astype(np.float32))
    targets = rng.normal(size=(203, 1)).astype(np.float32)
    seq = fit_rls(states, targets, washout=7, reg=1e-2, lam=lam)
    blk = fit_rls(states, targets, washout=7, reg=1e-2, lam=lam, block=8)
    np.testing.assert_allclose(blk.w_out.numpy(), seq.w_out.numpy(), atol=2e-3)


def test_fit_rls_forgetting_tracks_a_switch():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(400, 4)).astype(np.float32)
    w_a, w_b = rng.normal(size=(2, 4)).astype(np.float32)
    y = np.concatenate([x[:200] @ w_a, x[200:] @ w_b]).astype(np.float32)
    xt = torch.tensor(x)
    forgetful = fit_rls(xt, y, reg=1e-2, lam=0.98)
    stubborn = fit_rls(xt, y, reg=1e-2, lam=1.0)
    err_f = nmse(predict(forgetful._replace(washout=0), xt[350:])[:, 0], y[350:])
    err_s = nmse(predict(stubborn._replace(washout=0), xt[350:])[:, 0], y[350:])
    assert err_f < 0.1 * err_s


def test_fit_warm_start_and_validation():
    states = torch.ones((3, 4))
    targets = np.ones((3, 1), np.float32)
    w0 = np.arange(5, dtype=np.float32)[:, None]
    assert np.array_equal(fit_rls(states, targets, washout=3, reg=1e-2, w0=w0).w_out.numpy(), w0)
    assert np.array_equal(fit_lms(states, targets, washout=3, w0=w0).w_out.numpy(), w0)
    s = torch.zeros((5, 3))
    with pytest.raises(ValueError, match="targets"):
        fit_rls(s, np.zeros((1, 5), np.float32))
    for lam in (0.0, 1.5):
        with pytest.raises(ValueError, match="lam"):
            fit_rls(s, np.zeros(5, np.float32), lam=lam)
    with pytest.raises(ValueError, match="block"):
        fit_rls(s, np.zeros(5, np.float32), block=0)
    with pytest.raises(ValueError, match="mu"):
        fit_lms(torch.zeros((4, 3)), np.zeros((4, 1)), mu=2.5)


def test_fit_lms_learns_and_matches_reference():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(600, 6)).astype(np.float32)
    y = x @ rng.normal(size=(6, 1)).astype(np.float32)
    readout = fit_lms(torch.tensor(x), y, washout=10, mu=0.5)
    assert nmse(predict(readout._replace(washout=0), torch.tensor(x[300:])), y[300:]) < 0.05
    want = jres.fit_lms(x, y, washout=10, mu=0.5)
    np.testing.assert_allclose(readout.w_out.numpy(), np.asarray(want.w_out), atol=FIT_F32_ATOL)


# -- tick_chunk learning and the serving engine ----------------------------------


def _spec_pair(n=8, hold=4, seed=1):
    sj = jmake_spec(n, n_in=1, seed=seed, hold_steps=hold, dtype=jnp.float32)
    st = convert.spec_from_numpy(
        type(sj.params)(*[np.asarray(x) for x in sj.params]),
        np.asarray(sj.w_cp), np.asarray(sj.w_in), np.asarray(sj.m0), sj.dt,
        sj.hold_steps, device="cpu",
    )
    return sj, st


def _sessions(rng, count, lengths, n_out=1, washout=2):
    return [
        StreamSession(
            sid=sid,
            u_seq=rng.uniform(0, 0.5, (lengths[sid % len(lengths)], 1)).astype(np.float32),
            targets=rng.normal(size=(lengths[sid % len(lengths)], n_out)).astype(np.float32),
            learn_washout=washout,
        )
        for sid in range(count)
    ]


@pytest.mark.parametrize("learn", ["rls", "lms"])
@pytest.mark.parametrize("impl", ["scan", "ref"])
def test_tick_chunk_learning_matches_reference(impl, learn):
    """One learning chunk through both packages from the same (P, W) lanes
    (carried across with convert.learn_state_from_numpy)."""
    e, k = 3, 4
    sj, st = _spec_pair()
    rng = np.random.default_rng(0)
    u = rng.uniform(0, 0.5, (k, e, 1)).astype(np.float32)
    y = rng.normal(size=(k, e, 1)).astype(np.float32)
    mask = np.ones((k, e), bool)
    mask[2, 1] = False
    lmask = mask.copy()
    lmask[0] = False
    kw = dict(ensemble=e, chunk_ticks=k, learn=learn, learn_reg=1e-2, learn_mu=0.7)
    simj = jcompile(sj, JPlan(impl=impl, **kw))
    m0 = jops.to_planes(jnp.broadcast_to(sj.m0, (e, 8, 3)))
    pj, wj = simj.init_learn_state()
    want = simj.tick_chunk(m0, u, jnp.asarray(mask), targets=y, learn_state=(pj, wj), learn_mask=jnp.asarray(lmask))
    sim = compile_plan(st, ExecPlan(impl=impl, **kw), device="cpu")
    state = convert.learn_state_from_numpy(None if pj is None else np.asarray(pj), np.asarray(wj), "cpu")
    p0, w0 = sim.init_learn_state()
    assert (p0 is None) == (state[0] is None) and torch.equal(w0, state[1])
    if p0 is not None:
        assert torch.equal(p0, state[0])
    got = sim.tick_chunk(torch.tensor(np.asarray(m0)), u, mask, targets=y, learn_state=state, learn_mask=lmask)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=ATOL)
    for a, b in zip(got[2], want[2]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ENGINE_ATOL * max(1.0, float(np.abs(b).max())))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=ENGINE_ATOL)
    # the integration is the inference-only chunk's, bit for bit
    infer = compile_plan(st, ExecPlan(impl=impl, ensemble=e, chunk_ticks=k), device="cpu")
    mi, si = infer.tick_chunk(torch.tensor(np.asarray(m0)), u, mask)
    assert torch.equal(mi, got[0]) and torch.equal(si, got[1])


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("learn", ["rls", "lms"])
@pytest.mark.parametrize("backend", ["scan", "ref", "chunk"])
def test_served_lane_matches_oracle_bitwise(backend, learn, k):
    """Every served session's learned W == fit_rls(block=K) / fit_lms over
    its harvested states, bit for bit, across slot turnover and mid-chunk
    finishes (chunk_ticks=1 included: the oracle runs rls_chunk at block 1
    too)."""
    _, st = _spec_pair(n=10, hold=6)
    sessions = _sessions(np.random.default_rng(0), 8, (5, 9, 14))
    eng = ReservoirEngine(
        st, num_slots=3, backend=backend, chunk_ticks=k, learn=learn,
        learn_reg=1e-2, learn_mu=0.7, device="cpu",
    )
    results = eng.run([dataclasses.replace(s) for s in sessions])
    assert len(results) == 8 and eng.stats().learn == learn
    for s in sessions:
        r = results[s.sid]
        states = torch.from_numpy(r.states)
        if learn == "rls":
            oracle = fit_rls(states, s.targets, washout=2, reg=1e-2, block=k)
        else:
            oracle = fit_lms(states, s.targets, washout=2, mu=0.7)
        assert torch.equal(r.learned_readout.w_out, oracle.w_out), s.sid
        assert r.predictions.shape == (len(s.u_seq), 1) and np.isfinite(r.learn_nmse)


def test_mixed_learning_and_inference_tenants_and_warm_start():
    """Inference-only sessions ride a learning engine untouched; a
    learner's readout warm-starts its learned lane (oracle: fit_rls(w0=))
    and still drives its static outputs. On an n_out = 2 engine the same
    sessions ride padded columns and come back at their own width (close to
    the n_out = 1 run: the weight sums run over another shape)."""
    _, st = _spec_pair()
    rng = np.random.default_rng(2)
    u_inf = rng.uniform(0, 0.5, (9, 1)).astype(np.float32)
    learners = _sessions(rng, 3, (7, 12))
    w0 = rng.normal(size=(9, 1)).astype(np.float32)
    learners[0].readout = Readout(torch.tensor(w0), 0)
    kw = dict(num_slots=2, backend="scan", chunk_ticks=3, learn="rls", learn_reg=1e-2, device="cpu")
    eng = ReservoirEngine(st, **kw)
    res = eng.run([StreamSession(sid=100, u_seq=u_inf.copy())] + [dataclasses.replace(s) for s in learners])
    wide = ReservoirEngine(st, n_out=2, **kw).run([dataclasses.replace(s) for s in learners])
    assert res[100].learned_readout is None and res[100].predictions is None
    plain = ReservoirEngine(st, num_slots=2, backend="scan", chunk_ticks=3, device="cpu")
    ref = plain.run([StreamSession(sid=100, u_seq=u_inf.copy())])
    assert np.array_equal(res[100].states, ref[100].states)
    for s in learners:
        r = res[s.sid]
        oracle = fit_rls(
            torch.from_numpy(r.states), s.targets, washout=2, reg=1e-2, block=3,
            w0=w0 if s.sid == 0 else None,
        )
        assert torch.equal(r.learned_readout.w_out, oracle.w_out)
        w2 = wide[s.sid].learned_readout.w_out
        assert w2.shape == (9, 1) and wide[s.sid].predictions.shape == (len(s.u_seq), 1)
        np.testing.assert_allclose(w2.numpy(), oracle.w_out.numpy(), atol=1e-4)
    assert res[0].outputs is not None


def test_lms_engine_is_chunk_size_independent():
    _, st = _spec_pair(hold=5)
    sessions = _sessions(np.random.default_rng(14), 3, (6, 9))
    outs = []
    for ct in (1, 4):
        eng = ReservoirEngine(st, num_slots=2, backend="scan", chunk_ticks=ct, learn="lms", learn_mu=0.5, device="cpu")
        rs = eng.run([dataclasses.replace(s) for s in sessions])
        outs.append({sid: r.learned_readout.w_out for sid, r in rs.items()})
    assert all(torch.equal(outs[0][sid], outs[1][sid]) for sid in outs[0])


def test_resume_weights_and_inverse_gram():
    """learn_w0 / learn_P0 start a lane mid-recursion: serving the second
    half of a stream from the first half's (P, W) lands where one session
    over the whole stream lands (within f32 roundoff)."""
    _, st = _spec_pair()
    rng = np.random.default_rng(9)
    u = rng.uniform(0, 0.5, (12, 1)).astype(np.float32)
    y = rng.normal(size=(12, 1)).astype(np.float32)
    eng = ReservoirEngine(st, num_slots=1, backend="scan", chunk_ticks=4, learn="rls", learn_reg=1e-2, device="cpu")
    whole = eng.run([StreamSession(sid=0, u_seq=u, targets=y)])[0]
    half = eng.run([StreamSession(sid=1, u_seq=u[:8], targets=y[:8])])[1]
    xb = torch.cat([torch.from_numpy(half.states), torch.ones(8, 1)], 1)
    p, w = krls.rls_init(1, 9, 1, 1e-2, torch.float32, device="cpu")
    for s0 in (0, 4):
        p, w, _ = krls.rls_chunk(p, w, xb[s0 : s0 + 4, None], torch.tensor(y[s0 : s0 + 4, None]), torch.ones(4, 1, dtype=torch.bool), 1.0)
    assert torch.equal(w[0], half.learned_readout.w_out)
    rest = eng.run(
        [StreamSession(sid=2, u_seq=u[8:], targets=y[8:], m0=half.final_m, learn_w0=w[0].numpy(), learn_P0=p[0].numpy())]
    )[2]
    np.testing.assert_allclose(rest.learned_readout.w_out.numpy(), whole.learned_readout.w_out.numpy(), atol=1e-4)


def test_narma_online_nmse_within_5pct_of_ridge():
    params = constants.default_params(torch.float32, device="cpu")._replace(a_in=torch.tensor(300.0))
    spec = make_spec(24, n_in=1, hold_steps=20, params=params, device="cpu")
    train, test, washout = 260, 80, 40
    u, y = tasks.narma_series(train + test, order=10, seed=0)
    u, y = u.astype(np.float32)[:, None], y.astype(np.float32)[:, None]
    eng = ReservoirEngine(spec, num_slots=1, backend="scan", chunk_ticks=8, learn="rls", learn_reg=1e-2, device="cpu")
    r = eng.run([StreamSession(sid=0, u_seq=u[:train], targets=y[:train], learn_washout=washout)])[0]
    _, test_states = compile_plan(spec, ExecPlan(impl="scan"), device="cpu").drive(u[train:], m0=r.final_m)
    ridge = fit_ridge(torch.from_numpy(r.states), y[:train], washout=washout, reg=1e-2)
    err_rls = nmse(predict(r.learned_readout, test_states), y[train:])
    err_ridge = nmse(predict(ridge._replace(washout=0), test_states), y[train:])
    assert err_ridge < 1.0
    assert err_rls <= err_ridge * 1.05
    assert r.learn_nmse is not None and np.isfinite(r.learn_nmse)


@pytest.mark.parametrize(
    "impl,interpret", [("ref", False), ("chunk", True), ("fused", True), ("tiled", True)]
)
def test_planes_backends_learn_close_to_scan(impl, interpret):
    _, st = _spec_pair(hold=3)
    rng = np.random.default_rng(0)
    k, e = 4, 3
    u = rng.uniform(0, 0.5, (k, e, 1)).astype(np.float32)
    y = rng.normal(size=(k, e, 1)).astype(np.float32)
    m0 = ops.to_planes(st.m0.expand(e, 8, 3)).contiguous()
    outs = {}
    for which, plan in {
        "scan": ExecPlan(impl="scan", ensemble=e, chunk_ticks=k, learn="rls", learn_reg=1e-2),
        impl: ExecPlan(impl=impl, ensemble=e, chunk_ticks=k, learn="rls", learn_reg=1e-2, interpret=interpret),
    }.items():
        sim = compile_plan(st, plan, device="cpu")
        outs[which] = sim.tick_chunk(m0, u, targets=y, learn_state=sim.init_learn_state())
    for a, b in zip(outs["scan"][2], outs[impl][2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-2)
    np.testing.assert_allclose(outs["scan"][3].numpy(), outs[impl][3].numpy(), atol=1e-3)


@pytest.mark.parametrize("learn", ["rls", "lms"])
def test_engine_matches_reference_engine(learn):
    """The same sessions (one warm-started from a readout, carried across)
    through the reference's learning engine and the port's, both on scan."""
    sj, st = _spec_pair(n=10, hold=5)
    rng = np.random.default_rng(21)
    rows = []
    for sid in range(6):
        t = int(rng.integers(5, 15))
        u = rng.uniform(0, 0.5, (t, 1)).astype(np.float32)
        y = rng.normal(size=(t, 1)).astype(np.float32)
        w0 = rng.normal(0, 0.3, (11, 1)).astype(np.float32) if sid == 0 else None
        rows.append((sid, u, y, w0))
    kw = dict(num_slots=3, backend="scan", chunk_ticks=4, learn=learn, learn_reg=1e-2, learn_mu=0.7)
    want = JEngine(sj, prewarm=False, **kw).run(
        [
            JSession(sid=sid, u_seq=u, targets=y, learn_washout=2,
                     readout=None if w0 is None else JReadout(jnp.asarray(w0), 0))
            for sid, u, y, w0 in rows
        ]
    )
    got = ReservoirEngine(st, device="cpu", **kw).run(
        [
            StreamSession(sid=sid, u_seq=u, targets=y, learn_washout=2,
                          readout=None if w0 is None else convert.readout_from_numpy(w0, 0, "cpu"))
            for sid, u, y, w0 in rows
        ]
    )
    assert sorted(got) == sorted(want)
    for sid in got:
        a, b = got[sid], want[sid]
        np.testing.assert_allclose(a.states, np.asarray(b.states), atol=ATOL)
        np.testing.assert_allclose(a.predictions, np.asarray(b.predictions), atol=ENGINE_ATOL)
        np.testing.assert_allclose(
            a.learned_readout.w_out.numpy(), np.asarray(b.learned_readout.w_out), atol=ENGINE_ATOL
        )
        np.testing.assert_allclose(a.learn_nmse, b.learn_nmse, rtol=1e-3)
        assert (a.admitted_tick, a.finished_tick, a.slot) == (b.admitted_tick, b.finished_tick, b.slot)


# -- validation ---------------------------------------------------------------------


def test_tick_chunk_rejects_mismatched_learn_args():
    _, st = _spec_pair(n=6, hold=3)
    m0 = ops.to_planes(st.m0.expand(2, 6, 3)).contiguous()
    u = np.zeros((3, 2, 1), np.float32)
    infer = compile_plan(st, ExecPlan(impl="scan", ensemble=2, chunk_ticks=3), device="cpu")
    with pytest.raises(ValueError, match="inference-only"):
        infer.tick_chunk(m0, u, targets=np.zeros((3, 2, 1)))
    with pytest.raises(ValueError, match="init_learn_state"):
        infer.init_learn_state()
    learner = compile_plan(st, ExecPlan(impl="scan", ensemble=2, chunk_ticks=3, learn="rls"), device="cpu")
    with pytest.raises(ValueError, match="learn_state"):
        learner.tick_chunk(m0, u)
    p0, w0 = learner.init_learn_state()
    with pytest.raises(ValueError, match="targets"):
        learner.tick_chunk(m0, u, targets=np.zeros((3, 2, 4)), learn_state=(p0, w0))
    with pytest.raises(ValueError, match="learn_state"):
        learner.tick_chunk(m0, u, targets=np.zeros((3, 2, 1)), learn_state=(p0[:, :3], w0))
    lms = compile_plan(st, ExecPlan(impl="scan", ensemble=2, chunk_ticks=3, learn="lms"), device="cpu")
    with pytest.raises(ValueError, match="no P block"):
        lms.tick_chunk(m0, u, targets=np.zeros((3, 2, 1)), learn_state=(p0, w0))
    assert lms.warmup() is lms and learner.warmup(n_out=2) is learner


def test_engine_validates_learning_submissions():
    _, st = _spec_pair(n=6, hold=3)
    u = np.zeros((4, 1), np.float32)
    plain = ReservoirEngine(st, num_slots=1, backend="scan", device="cpu")
    with pytest.raises(ValueError, match="learning"):
        plain.submit(StreamSession(sid=0, u_seq=u, targets=np.zeros((4, 1))))
    eng = ReservoirEngine(st, num_slots=1, backend="scan", chunk_ticks=2, learn="rls", device="cpu")
    with pytest.raises(ValueError, match="targets"):
        eng.submit(StreamSession(sid=1, u_seq=u, targets=np.zeros((3, 1))))
    with pytest.raises(ValueError, match="targets"):
        eng.submit(StreamSession(sid=1, u_seq=u, targets=np.zeros((4, 2))))
    with pytest.raises(ValueError, match="learn_washout"):
        eng.submit(StreamSession(sid=2, u_seq=u, targets=np.zeros((4, 1)), learn_washout=-1))
    with pytest.raises(ValueError, match="learn_w0"):
        eng.submit(StreamSession(sid=3, u_seq=u, targets=np.zeros((4, 1)), learn_w0=np.zeros((3, 1))))
    with pytest.raises(ValueError, match="learn_P0"):
        eng.submit(StreamSession(sid=3, u_seq=u, targets=np.zeros((4, 1)), learn_P0=np.zeros((3, 3))))
    with pytest.raises(ValueError, match="require a learning engine"):
        plain.submit(StreamSession(sid=4, u_seq=u, learn_w0=np.zeros((7, 1))))
    lms = ReservoirEngine(st, num_slots=1, backend="scan", chunk_ticks=2, learn="lms", device="cpu")
    with pytest.raises(ValueError, match="learn_P0"):
        lms.submit(StreamSession(sid=0, u_seq=u, targets=np.zeros((4, 1), np.float32), learn_P0=np.eye(7, dtype=np.float32)))
    with pytest.raises(ValueError, match="inverse-Gram"):
        lms.store.learn_P_columns([0])
    assert tuple(eng.store.learn_P_columns([0]).shape) == (1, 7, 7)
    sim = compile_plan(st, ExecPlan(impl="scan", ensemble=2), device="cpu")
    with pytest.raises(ValueError, match="ExecPlan"):
        ReservoirEngine(sim, learn="rls")
    for kwargs in (dict(learn="sgd"), dict(learn="rls", learn_lam=1.5), dict(learn="rls", learn_reg=0.0), dict(learn="lms", learn_mu=2.0)):
        with pytest.raises(ValueError):
            ExecPlan(**kwargs)
    assert dataclasses.replace(ExecPlan(learn="rls", learn_lam=0.99), ensemble=8).learn == "rls"
