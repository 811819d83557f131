"""The port's exact oracle, impl="scan", against the reference's impl="scan",
on the CPU: every entry point (drive, drive_batch, integrate, tick,
tick_chunk, the serving engine) and every tableau. Mirrors the impl="scan"
cases of tests/test_api_plan.py and tests/test_precision_chunk.py, plus the
tableau rule: the planes impls refuse a tableau other than RK4 (the
reference's "ref" impl integrates RK4 whatever the tableau; the port refuses
that instead).

The port's spec is carried across from the reference's leaves
(repro_torch.convert). Tolerances: F32_ATOL = 5e-5 (tests/
test_kernels_sto.py's f32 bound), F64_ATOL = 1e-10 over <= 40 steps. Within
the port: a K-chunk equals K tick calls bit for bit, masked lanes are
bit-frozen, precision None and "highest" are the same bits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecPlan as JPlan
from repro.api import compile_plan as jcompile
from repro.api import make_spec as jmake_spec
from repro.core.ensemble import broadcast_params as jbroadcast
from repro.serve.reservoir import ReservoirEngine as JEngine
from repro.serve.reservoir import StreamSession as JSession
from repro_torch import convert
from repro_torch.api import ExecPlan, compile_plan
from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

torch.set_num_threads(2)

F32_ATOL = 5e-5
F64_ATOL = 1e-10
TABLEAUX = ("euler", "heun", "rk4", "bs32")
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}
E, K = 3, 4


def _specs(n=8, n_in=2, hold=3, dt="f32", tableau="rk4"):
    jdt, _ = DTYPES[dt]
    sj = jmake_spec(n, n_in=n_in, seed=1, hold_steps=hold, dtype=jdt, tableau=tableau)
    st = convert.spec_from_numpy(
        type(sj.params)(*[np.asarray(x) for x in sj.params]),
        np.asarray(sj.w_cp), np.asarray(sj.w_in), np.asarray(sj.m0), sj.dt,
        sj.hold_steps, device="cpu",
    )
    return sj, st._replace(tableau=tableau)


def _u(t, *lead, n_in=2, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 0.5, (t, *lead, n_in))


def _mask(k, e, seed=1):
    mask = np.random.default_rng(seed).uniform(size=(k, e)) > 0.3
    mask[:, 0] = True
    mask[:, 1] = [t >= 2 for t in range(k)]  # admitted mid-chunk
    mask[:, 2] = [t < 2 for t in range(k)]  # retired mid-chunk
    return mask


def _planes(m0, e):
    return np.ascontiguousarray(np.broadcast_to(np.asarray(m0).T[:, :, None], (3, m0.shape[0], e)))


def _close(got, want, dt):
    atol = F32_ATOL if dt == "f32" else F64_ATOL
    for a, b in zip(got, want):
        assert a.dtype == DTYPES[dt][1]
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("tableau", TABLEAUX)
def test_drive_matches_reference_scan(tableau, dt):
    u = _u(5)
    with jax.enable_x64(True):
        sj, st = _specs(dt=dt, tableau=tableau)
        want = [np.asarray(x) for x in jcompile(sj, JPlan(impl="scan")).drive(jnp.asarray(u, sj.dtype))]
    got = compile_plan(st, ExecPlan(impl="scan"), device="cpu").drive(u)
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("tableau", TABLEAUX)
def test_batch_entry_points_match_reference_scan(tableau, dt):
    """drive_batch (per-lane inputs and params), tick, tick_chunk and
    integrate(save_every) of an E-lane scan plan."""
    u, mask = _u(5, E), _mask(K, E)
    with jax.enable_x64(True):
        sj, st = _specs(dt=dt, tableau=tableau)
        pj = jbroadcast(sj.params, E, current=np.linspace(2e-3, 3e-3, E))
        simj = jcompile(sj, JPlan(impl="scan", ensemble=E, chunk_ticks=K))
        m0 = jnp.asarray(_planes(sj.m0, E))
        uj = jnp.asarray(u, sj.dtype)
        want = {
            "drive_batch": simj.drive_batch(uj, params=pj),
            "tick": simj.tick(m0, uj[0], lane_mask=jnp.asarray(mask[1]), params=pj),
            "tick_chunk": simj.tick_chunk(m0, uj[:K], lane_mask=jnp.asarray(mask), params=pj),
            "integrate": simj.integrate(6, save_every=3, params=pj),
        }
        want = {k: [np.asarray(x) for x in v] for k, v in want.items()}
    pt = convert.params_from_numpy(type(pj)(*[np.asarray(x) for x in pj]), device="cpu")
    sim = compile_plan(st, ExecPlan(impl="scan", ensemble=E, chunk_ticks=K), device="cpu")
    m0t = torch.tensor(np.asarray(m0))
    got = {
        "drive_batch": sim.drive_batch(u, params=pt),
        "tick": sim.tick(m0t, u[0], lane_mask=mask[1], params=pt),
        "tick_chunk": sim.tick_chunk(m0t, u[:K], lane_mask=mask, params=pt),
        "integrate": sim.integrate(6, save_every=3, params=pt),
    }
    for name in want:
        _close(got[name], want[name], dt)


def test_tick_chunk_equals_k_ticks_and_freezes_masked_lanes():
    _, st = _specs(tableau="heun")
    sim = compile_plan(st, ExecPlan(impl="scan", ensemble=E, chunk_ticks=K), device="cpu")
    m0 = torch.tensor(_planes(st.m0, E))
    u, mask = _u(K, E), _mask(K, E)
    m_chunk, states = sim.tick_chunk(m0, u, lane_mask=mask)
    m = m0
    for t in range(K):
        m, x = sim.tick(m, u[t], lane_mask=mask[t])
        assert torch.equal(x, states[t])
    assert torch.equal(m, m_chunk)
    # the lane retired after tick 1 holds still; a lane masked all chunk
    # comes back bit-identical
    assert all(torch.equal(states[t, :, 2], states[1, :, 2]) for t in range(2, K))
    frozen = mask.copy()
    frozen[:, 0] = False
    m_f, _ = sim.tick_chunk(m0, u, lane_mask=frozen)
    assert torch.equal(m_f[:, :, 0], m0[:, :, 0])


def test_drive_resume_and_lanes_match_solo():
    """drive(m0=) resumes bit-exactly; each lane of a drive_batch with
    per-lane inputs is a solo drive of its series (within tolerance)."""
    _, st = _specs()
    solo = compile_plan(st, ExecPlan(impl="scan"), device="cpu")
    u = _u(10)
    _, full = solo.drive(u)
    m_half, a = solo.drive(u[:5])
    _, b = solo.drive(u[5:], m0=m_half)
    assert torch.equal(torch.cat([a, b]), full)
    ue = _u(5, 2, seed=3)
    _, states = compile_plan(st, ExecPlan(impl="scan", ensemble=2), device="cpu").drive_batch(ue)
    for i in range(2):
        _, s = solo.drive(ue[:, i])
        np.testing.assert_allclose(states[:, i].numpy(), s.numpy(), atol=F32_ATOL)


@pytest.mark.parametrize("impl", ["ref", "fused", "tiled", "chunk"])
def test_planes_impls_close_to_scan(impl):
    _, st = _specs()
    u = _u(6)
    _, s_scan = compile_plan(st, ExecPlan(impl="scan"), device="cpu").drive(u)
    _, s = compile_plan(st, ExecPlan(impl=impl), device="cpu").drive(u)
    np.testing.assert_allclose(s.numpy(), s_scan.numpy(), atol=F32_ATOL)


def test_scan_refuses_reduced_precision_and_highest_is_the_same_bits():
    for precision in ("bf16_coupling", "mixed"):
        with pytest.raises(ValueError, match="bit-exact oracle"):
            ExecPlan(impl="scan", precision=precision)
    _, st = _specs()
    m0, u, mask = torch.tensor(_planes(st.m0, E)), _u(K, E), _mask(K, E)
    outs = [
        compile_plan(st, ExecPlan(impl="scan", ensemble=E, chunk_ticks=K, precision=p), device="cpu")
        .tick_chunk(m0, u, lane_mask=mask)
        for p in (None, "highest")
    ]
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("impl", ["ref", "fused", "tiled", "chunk"])
@pytest.mark.parametrize("tableau", ["euler", "heun", "bs32"])
def test_planes_impls_refuse_other_tableaux(impl, tableau):
    _, st = _specs(tableau=tableau)
    with pytest.raises(ValueError, match="impl='scan'"):
        compile_plan(st, ExecPlan(impl=impl), device="cpu")
    assert compile_plan(st, ExecPlan(impl="auto"), device="cpu").impl == "scan"


def test_reference_ref_impl_ignores_the_tableau():
    """The divergence the tableau rule guards against: the reference's
    impl="ref" Heun drive IS its RK4 drive, bit for bit, while its scan Heun
    drive differs from it by 3.36e-4 here, well past the f32 tolerance
    (ROADMAP queue 3, known divergences)."""
    u = _u(5)
    sj, _ = _specs(tableau="heun")
    heun_ref = np.asarray(jcompile(sj, JPlan(impl="ref")).drive(jnp.asarray(u, jnp.float32))[1])
    rk4_ref = np.asarray(
        jcompile(sj._replace(tableau="rk4"), JPlan(impl="ref")).drive(jnp.asarray(u, jnp.float32))[1]
    )
    heun_scan = np.asarray(jcompile(sj, JPlan(impl="scan")).drive(jnp.asarray(u, jnp.float32))[1])
    assert np.array_equal(heun_ref, rk4_ref)
    assert np.abs(heun_scan - rk4_ref).max() > 5 * F32_ATOL


@pytest.mark.parametrize("tableau", ["euler", "heun", "bs32"])
def test_port_auto_other_tableau_matches_reference_scan(tableau):
    u = _u(5)
    sj, st = _specs(tableau=tableau)
    want = jcompile(sj, JPlan(impl="scan")).drive(jnp.asarray(u, jnp.float32))
    sim = compile_plan(st, device="cpu")
    assert sim.impl == "scan"
    _close(sim.drive(u), [np.asarray(x) for x in want], "f32")


def test_engine_scan_backend_matches_reference():
    """The serving engine on impl="scan": sessions of mixed length through
    both packages' engines."""
    sj, st = _specs(n_in=1)
    rng = np.random.default_rng(4)
    rows = [(sid, rng.uniform(0, 0.5, (int(rng.integers(2, 9)), 1)).astype(np.float32)) for sid in range(7)]
    want = JEngine(sj, num_slots=E, backend="scan", chunk_ticks=K, prewarm=False).run(
        [JSession(sid=sid, u_seq=u) for sid, u in rows]
    )
    eng = ReservoirEngine(st, num_slots=E, backend="scan", chunk_ticks=K, device="cpu")
    got = eng.run([StreamSession(sid=sid, u_seq=u) for sid, u in rows])
    assert eng.backend == "scan" and sorted(got) == sorted(want)
    for sid in got:
        np.testing.assert_allclose(got[sid].states, np.asarray(want[sid].states), atol=F32_ATOL)
        np.testing.assert_allclose(got[sid].final_m, np.asarray(want[sid].final_m), atol=F32_ATOL)
        assert (got[sid].admitted_tick, got[sid].finished_tick) == (
            want[sid].admitted_tick, want[sid].finished_tick
        )
    # the per-tick engine path and warmup run the same chunk body
    sim = compile_plan(st, ExecPlan(impl="scan", ensemble=E, chunk_ticks=K), device="cpu")
    assert sim.warmup() is sim
    assert dataclasses.replace(sim.plan, ensemble=2).impl == "scan"
