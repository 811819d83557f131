"""The port's integrators (repro_torch.core.integrators) against the JAX
reference's (repro.core.integrators), on the CPU. Mirrors the integrator
cases of tests/test_core_physics.py and tests/test_property_based.py.

Both packages integrate the same LLG field from the same numbers (W^cp and
m0 are byte-identical, the params carried across). Tolerances: f64 1e-12 for
one step, 1e-10 over <= 40 steps (rounding differences only); f32 5e-5
(tests/test_kernels_sto.py's f32 bound). Within the port, the python loop and
integrate_scan run the same steps and must agree bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constants as jconst
from repro.core import coupling as jcoupling
from repro.core import integrators as jint
from repro.core import sto as jsto
from repro_torch.core import constants, integrators, sto

torch.set_num_threads(2)

DT = constants.DT
F64_STEP_ATOL = 1e-12
F64_ATOL = 1e-10
F32_ATOL = 5e-5
TDT = {"f32": torch.float32, "f64": torch.float64}
JDT = {"f32": jnp.float32, "f64": jnp.float64}


def _fields(n, dt, seed=0, m0=None):
    """(port field, port m0, reference field-maker, m0 as numpy) for one
    N-oscillator array. The reference's maker must run under x64."""
    w = jcoupling.make_coupling_matrix(n, seed=seed)
    m0_np = np.asarray(constants.initial_magnetization(n, TDT[dt], device="cpu")) if m0 is None else m0
    p = constants.default_params(TDT[dt], device="cpu")
    w_t = torch.as_tensor(w).to(TDT[dt])
    field = lambda m, _: sto.llg_field(m, p, w_t)  # noqa: E731

    def jfield():
        pj = jconst.default_params(JDT[dt])
        wj = jnp.asarray(w, JDT[dt])
        return lambda m, _: jsto.llg_field(m, pj, wj)

    return field, torch.as_tensor(m0_np, dtype=TDT[dt]), jfield, m0_np


def test_tableaux_are_the_references():
    assert set(integrators.TABLEAUX) == set(jint.TABLEAUX)
    for name, tab in integrators.TABLEAUX.items():
        assert tuple(tab) == tuple(jint.TABLEAUX[name]), name
    assert integrators.BS32_B_LOW == jint.BS32_B_LOW


@pytest.mark.parametrize("name", sorted(integrators.TABLEAUX))
def test_one_step_matches_reference_f64(name):
    field, m0, jfield, m0_np = _fields(6, "f64")
    got = integrators.make_step(field, integrators.TABLEAUX[name])(
        m0, integrators.dt_tensor(DT, m0), None
    )
    with jax.enable_x64(True):
        want = jint.make_step(jfield(), jint.TABLEAUX[name])(
            jnp.asarray(m0_np), jnp.asarray(DT, jnp.float64), None
        )
        want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F64_STEP_ATOL)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("name", sorted(integrators.TABLEAUX))
def test_scan_matches_reference(name, dt):
    field, m0, jfield, m0_np = _fields(8, dt)
    got, ys = integrators.integrate_scan(field, m0, DT, 40, tableau=integrators.TABLEAUX[name])
    assert ys is None and got.dtype == TDT[dt]
    with jax.enable_x64(True):
        want, _ = jint.integrate_scan(
            jfield(), jnp.asarray(m0_np, JDT[dt]), DT, 40, tableau=jint.TABLEAUX[name]
        )
        want = np.asarray(want)
    atol = F64_ATOL if dt == "f64" else F32_ATOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_dt_rounds_in_the_state_dtype():
    """An f32 state keeps dt a 0-d f32 tensor, so dt * a_ij rounds in f32."""
    m0 = torch.zeros(3, dtype=torch.float32)
    dt = integrators.dt_tensor(DT, m0)
    assert dt.dtype == torch.float32 and dt.ndim == 0
    assert (dt * 0.5).item() == np.float32(np.float32(DT) * np.float32(0.5))


def test_save_every_trajectory_matches_reference():
    field, m0, jfield, m0_np = _fields(3, "f64")
    mT, ys = integrators.integrate_scan(field, m0, DT, 40, save_every=10)
    assert tuple(ys.shape) == (4, 3, 3)
    assert torch.equal(ys[-1], mT)
    with jax.enable_x64(True):
        _, ys_j = jint.integrate_scan(jfield(), jnp.asarray(m0_np), DT, 40, save_every=10)
        ys_j = np.asarray(ys_j)
    np.testing.assert_allclose(ys.numpy(), ys_j, rtol=0, atol=F64_ATOL)
    with pytest.raises(ValueError, match="multiple"):
        integrators.integrate_scan(field, m0, DT, 40, save_every=7)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_python_loop_equals_scan_bitwise(dt):
    """Paper §3.2: implementations must agree on the solution; in the port
    the two loops run the same step, so they agree bit for bit."""
    field, m0, _, _ = _fields(5, dt)
    a, _ = integrators.integrate_scan(field, m0, DT, 50)
    b = integrators.integrate_python_loop(field, m0, DT, 50)
    assert torch.equal(a, b)


def test_uncoupled_field_keeps_oscillators_identical():
    p = constants.default_params(torch.float64, device="cpu")
    m0 = constants.initial_magnetization(4, torch.float64, device="cpu")
    mT, _ = integrators.integrate_scan(lambda m, _: sto.llg_field(m, p, None), m0, DT, 100)
    np.testing.assert_allclose(mT.numpy(), np.broadcast_to(mT[0:1].numpy(), mT.shape), rtol=1e-12)


@pytest.mark.parametrize("name,lo,hi", [("rk4", 3.5, 5.0), ("heun", 1.5, 3.0)])
def test_convergence_order(name, lo, hi):
    field, m0, jfield, m0_np = _fields(6, "f64")
    t_end = 400 * float(DT)
    order = integrators.convergence_order(
        field, m0, t_end, tableau=integrators.TABLEAUX[name], base_steps=64
    )
    with jax.enable_x64(True):
        want = jint.convergence_order(
            jfield(), jnp.asarray(m0_np), t_end, tableau=jint.TABLEAUX[name], base_steps=64
        )
    assert lo < order < hi
    assert abs(order - want) < 1e-3


@pytest.mark.parametrize(
    "t_steps,rtol,atol", [(150, 1e-7, 1e-11), (200, 1e-4, 1e-8), (60, 1e-8, 1e-12)]
)
def test_adaptive_matches_reference_f64(t_steps, rtol, atol):
    """integrate_adaptive: the same accepted and rejected steps as the
    reference in f64, the same end state, and t_end reached."""
    field, m0, jfield, m0_np = _fields(6, "f64")
    t_end = t_steps * float(DT)
    y, stats = integrators.integrate_adaptive(field, m0, t_end, rtol=rtol, atol=atol)
    with jax.enable_x64(True):
        yj, sj = jint.integrate_adaptive(jfield(), jnp.asarray(m0_np), t_end, rtol=rtol, atol=atol)
        yj, sj = np.asarray(yj), {k: np.asarray(v) for k, v in sj.items()}
    assert set(stats) == set(sj)
    assert (stats["steps"], stats["rejected"]) == (int(sj["steps"]), int(sj["rejected"]))
    assert stats["rejected"] < stats["steps"]
    np.testing.assert_allclose(y.numpy(), yj, rtol=0, atol=F64_ATOL)
    np.testing.assert_allclose(float(stats["t"]), t_end, rtol=1e-9)
    np.testing.assert_allclose(float(stats["dt_final"]), float(sj["dt_final"]), rtol=1e-6)
    if t_steps == 150:
        ref, _ = integrators.integrate_scan(field, m0, DT, 150)
        assert float(torch.max(torch.abs(y - ref))) < 1e-3
        assert float(sto.norm_error(y)) < 1e-6


@pytest.mark.parametrize("seed,n,steps", [(0, 1, 40), (7, 5, 120), (123, 12, 300)])
def test_norm_conserved_from_any_unit_state(seed, n, steps):
    """The property-based case, at fixed draws: |m| = 1 is an invariant
    manifold of the LLG equation, from any unit-norm start."""
    rng = np.random.default_rng(seed)
    m0 = rng.standard_normal((n, 3))
    m0 /= np.linalg.norm(m0, axis=-1, keepdims=True)
    field, m0_t, jfield, _ = _fields(n, "f64", seed=seed % 1000, m0=m0)
    mT, _ = integrators.integrate_scan(field, m0_t, DT, steps)
    assert float(sto.norm_error(mT)) < 1e-6
    assert not bool(torch.isnan(mT).any())
    with jax.enable_x64(True):
        want, _ = jint.integrate_scan(jfield(), jnp.asarray(m0), DT, steps)
        want = np.asarray(want)
    np.testing.assert_allclose(mT.numpy(), want, rtol=0, atol=1e-9)
