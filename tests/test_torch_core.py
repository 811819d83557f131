"""The port's core physics against the JAX reference (repro_torch.core vs
repro.core), on the CPU.

Tolerances: the numpy constructors are copied, so W^cp / W^in / tasks must be
byte-identical. f64 field evaluations agree to ~1e-12 relative (the same
expressions, rounding differences only); f32 to 1e-5 relative (one f32
rounding per op, differently ordered sums in the coupling product)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constants as jconst
from repro.core import coupling as jcoupling
from repro.core import reservoir as jres
from repro.core import sto as jsto
from repro.core import tasks as jtasks
from repro.core.ensemble import broadcast_params as jbroadcast
from repro_torch.core import constants, coupling, reservoir, sto, tasks
from repro_torch.core.ensemble import broadcast_params

torch.set_num_threads(2)

TDT = {"f32": torch.float32, "f64": torch.float64}
JDT = {"f32": jnp.float32, "f64": jnp.float64}


@pytest.mark.parametrize("n", [1, 16, 64, 2049])  # 2049 > 2048: power iteration
def test_coupling_matrix_byte_identical(n):
    a = coupling.make_coupling_matrix(n, seed=3)
    b = jcoupling.make_coupling_matrix(n, seed=3)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,n_in", [(1, 1), (16, 2), (64, 3)])
def test_input_matrix_byte_identical(n, n_in):
    a = coupling.make_input_matrix(n, n_in, seed=5)
    b = jcoupling.make_input_matrix(n, n_in, seed=5)
    assert a.tobytes() == b.tobytes()


def test_spectral_radius_equal():
    w = np.random.default_rng(0).uniform(-1, 1, (40, 40))
    assert coupling.spectral_radius(w) == jcoupling.spectral_radius(w)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_default_params_and_initial_state_equal(dt):
    with jax.enable_x64(True):
        pj = jconst.default_params(JDT[dt])
        mj = np.asarray(jconst.initial_magnetization(5, dtype=JDT[dt]))
        derived_j = [np.asarray(x) for x in (pj.llg_prefactor, pj.hs_coef, pj.demag_field)]
    pt = constants.default_params(TDT[dt], device="cpu")
    for name in constants.STOParams._fields:
        assert np.array_equal(getattr(pt, name).numpy(), np.asarray(getattr(pj, name))), name
    rtol = 1e-6 if dt == "f32" else 1e-14
    derived_t = [x.numpy() for x in (pt.llg_prefactor, pt.hs_coef, pt.demag_field)]
    for a, b in zip(derived_t, derived_j):
        np.testing.assert_allclose(a, b, rtol=rtol)
    assert np.array_equal(
        constants.initial_magnetization(5, TDT[dt], device="cpu").numpy(), mj
    )
    assert constants.DT == jconst.DT


def _field_inputs(n, e, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(e, n, 3))
    m /= np.linalg.norm(m, axis=-1, keepdims=True)
    w = jcoupling.make_coupling_matrix(n, seed=seed).astype(np.float64)
    h = rng.normal(scale=5.0, size=(e, n))
    current = rng.uniform(2e-3, 3e-3, e)
    return m, w, h, current


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_llg_field_parity(dt):
    n, e = 12, 4
    m, w, h, current = _field_inputs(n, e)
    with jax.enable_x64(True):
        pj = jbroadcast(jconst.default_params(JDT[dt]), e, current=current)
        kj = np.asarray(
            jax.jit(jsto.llg_field)(
                jnp.asarray(m, JDT[dt]), pj, jnp.asarray(w, JDT[dt]), jnp.asarray(h, JDT[dt])
            )
        )
    pt = broadcast_params(
        constants.default_params(TDT[dt], device="cpu"), e, current=current
    )
    kt = sto.llg_field(
        torch.as_tensor(m, dtype=TDT[dt]), pt, torch.as_tensor(w, dtype=TDT[dt]),
        torch.as_tensor(h, dtype=TDT[dt]),
    ).numpy()
    scale = np.abs(kj).max()
    np.testing.assert_allclose(kt, kj, rtol=0, atol=(1e-5 if dt == "f32" else 1e-12) * scale)


def test_llg_field_uncoupled_and_norm_error():
    n, e = 6, 2
    m, _, _, _ = _field_inputs(n, e)
    with jax.enable_x64(True):
        kj = np.asarray(
            jax.jit(jsto.llg_field)(jnp.asarray(m), jconst.default_params(jnp.float64), None)
        )
        ej = float(jsto.norm_error(jnp.asarray(m * 1.001)))
    mt = torch.as_tensor(m)
    kt = sto.llg_field(mt, constants.default_params(torch.float64, device="cpu"), None).numpy()
    np.testing.assert_allclose(kt, kj, rtol=0, atol=1e-12 * np.abs(kj).max())
    assert abs(float(sto.norm_error(mt * 1.001)) - ej) < 1e-12


def test_coupling_field_x_parity():
    rng = np.random.default_rng(1)
    w, mx = rng.normal(size=(9, 9)), rng.normal(size=(3, 9))
    with jax.enable_x64(True):
        hj = np.asarray(jcoupling.coupling_field_x(jnp.asarray(w), jnp.asarray(mx), 2.0))
    ht = coupling.coupling_field_x(torch.as_tensor(w), torch.as_tensor(mx), 2.0).numpy()
    np.testing.assert_allclose(ht, hj, rtol=1e-12)


def test_fit_ridge_predict_nmse_parity():
    rng = np.random.default_rng(2)
    states = rng.normal(size=(50, 8))
    targets = states @ rng.normal(size=(8,)) + 0.1 * rng.normal(size=50)
    with jax.enable_x64(True):
        fit = jax.jit(jres.fit_ridge, static_argnames=("washout", "reg"))
        rj = fit(jnp.asarray(states), jnp.asarray(targets), washout=5, reg=1e-6)
        pj = np.asarray(jres.predict(rj, jnp.asarray(states)))
        ej = jres.nmse(jnp.asarray(pj), jnp.asarray(targets[5:]))
    rt = reservoir.fit_ridge(torch.as_tensor(states), torch.as_tensor(targets), washout=5, reg=1e-6)
    pt = reservoir.predict(rt, torch.as_tensor(states))
    np.testing.assert_allclose(rt.w_out.numpy(), np.asarray(rj.w_out), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-8, atol=1e-10)
    assert abs(reservoir.nmse(pt, targets[5:]) - ej) < 1e-10
    with pytest.raises(ValueError):
        reservoir.fit_ridge(torch.as_tensor(states), torch.as_tensor(targets)[None, :])


def test_coerce_input_series_contract():
    u = reservoir.coerce_input_series(np.arange(4.0), 1, np.float32, xp=np)
    assert u.shape == (4, 1) and u.dtype == np.float32
    assert reservoir.coerce_input_series(np.ones((3, 2)), 2, torch.float64).shape == (3, 2)
    for bad, n_in in ((np.ones((1, 5)), 1), (np.ones(5), 2), (np.ones((5, 3)), 2)):
        with pytest.raises(ValueError):
            reservoir.coerce_input_series(bad, n_in, np.float32, xp=np)


def test_tasks_identical():
    for a, b in zip(tasks.narma_series(60, order=10, seed=4), jtasks.narma_series(60, order=10, seed=4)):
        assert np.array_equal(a, b)
    u = np.random.default_rng(0).uniform(size=30)
    assert np.array_equal(tasks.delay_memory_targets(u, 3), jtasks.delay_memory_targets(u, 3))
    assert tasks.memory_capacity(u[:, None], u[:, None]) == jtasks.memory_capacity(u[:, None], u[:, None])
