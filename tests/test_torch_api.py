"""The port's execution API (repro_torch.api) against the JAX reference's
compile_plan, on the CPU.

The port's spec is carried across from the reference's leaves with
repro_torch.convert, so both packages integrate the same numbers. Every
port impl on the CPU runs the kernels' plain versions; the reference runs
impl="ref" (and "chunk", which is its plain chunk body off the TPU).

Tolerances: F32_ATOL = 5e-5 (tests/test_kernels_sto.py's f32 bound),
F64_ATOL = 1e-10 (port plain vs JAX ref in f64 over <= 40 RK4 steps)."""

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
from repro_torch import convert
from repro_torch.api import ExecPlan, compile_plan, make_spec, plan_cache_key
from repro_torch.kernels import ops

torch.set_num_threads(2)

F32_ATOL = 5e-5
F64_ATOL = 1e-10
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}


@pytest.fixture(scope="module")
def gloo_mesh(tmp_path_factory):
    """A world-size-1 gloo process group over a FileStore (no port) and its
    (1, 1) DeviceMesh ("data", "model"), destroyed at teardown."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _specs(n=12, n_in=2, hold=3, dt="f32"):
    jdt, _ = DTYPES[dt]
    sj = jmake_spec(n, n_in=n_in, seed=1, hold_steps=hold, dtype=jdt)
    st = convert.spec_from_numpy(
        type(sj.params)(*[np.asarray(x) for x in sj.params]),
        np.asarray(sj.w_cp), np.asarray(sj.w_in), np.asarray(sj.m0), sj.dt,
        sj.hold_steps, device="cpu",
    )
    return sj, st


def _block(k, e, n_in, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 0.5, (k, e, n_in))
    mask = rng.uniform(size=(k, e)) > 0.3
    mask[:, 0] = True
    mask[:, 1] = [t >= 2 for t in range(k)]  # admitted mid-chunk
    mask[:, 2] = [t < 2 for t in range(k)]  # retired mid-chunk
    return u, mask


# -- ExecPlan validation (the non-sharded cases of tests/test_api_plan.py) --


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(impl="bogus"),
        dict(ensemble=0),
        dict(chunk_ticks=0),
        dict(chunk_ticks=True),
        dict(chunk_ticks=2.0),
        dict(gather_dtype="not-a-dtype"),
        dict(precision="fp8"),
        dict(impl="scan", precision="bf16_coupling"),
        dict(learn="sgd"),
        dict(learn_lam=0.0),
        dict(learn_reg=-1.0),
        dict(learn_mu=2.0),
        dict(compilation_cache_dir=3),
        dict(block_n=100),
    ],
)
def test_exec_plan_rejects(kwargs):
    with pytest.raises(ValueError):
        ExecPlan(**kwargs)
    if "block_n" not in kwargs:  # the reference has no tile-multiple rule
        with pytest.raises(ValueError):
            JPlan(**kwargs)


@pytest.mark.parametrize(
    "kwargs",
    [dict(mesh=object()), dict(aot=True), dict(compilation_cache_dir="/x")],
)
def test_exec_plan_waiting_fields_raise_not_implemented(kwargs):
    """A mesh must be a DeviceMesh (anything else is a ValueError naming
    it); aot and compilation_cache_dir are accepted as the reference accepts
    them, and the plan cache's key leaves them out (they change when work
    happens, not what runs)."""
    if "mesh" in kwargs:
        with pytest.raises(ValueError, match="DeviceMesh.*object"):
            ExecPlan(**kwargs)
        return
    ((field, value),) = kwargs.items()
    plan = ExecPlan(**kwargs)
    assert getattr(plan, field) == value == getattr(JPlan(**kwargs), field)
    assert plan_cache_key(plan) == plan_cache_key(ExecPlan())


def test_exec_plan_accepts_a_device_mesh(gloo_mesh):
    """A world-size-1 gloo DeviceMesh is a sharded plan; its dim names must
    include the plan's axes."""
    plan = ExecPlan(ensemble=2, mesh=gloo_mesh)
    assert plan.sharded and plan.mesh is gloo_mesh
    assert ExecPlan(mesh=gloo_mesh, ensemble_axes=("data", "model"), model_axis=None).sharded
    with pytest.raises(ValueError, match="DeviceMesh"):
        ExecPlan(mesh=gloo_mesh, model_axis="x")
    with pytest.raises(ValueError, match="DeviceMesh"):
        ExecPlan(mesh=gloo_mesh, ensemble_axes=("model",))


def test_exec_plan_properties():
    p = ExecPlan(precision="highest", chunk_ticks=4, block_n=128)
    assert p.effective_precision is None and not p.reduced_precision and not p.sharded
    assert ExecPlan(precision="mixed").reduced_precision


def test_learn_state_init_defaults_to_the_card():
    """kernels.rls.rls_init / lms_init are entry points: without a card they
    raise unless asked for the CPU, as every other entry point does."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    from repro_torch.kernels import rls as krls

    with pytest.raises(RuntimeError, match="device='cpu'"):
        krls.rls_init(2, 5, 1, 1e-2, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        krls.lms_init(2, 5, 1, torch.float32)
    assert krls.rls_init(2, 5, 1, 1e-2, torch.float32, device="cpu")[0].device.type == "cpu"
    assert krls.lms_init(2, 5, 1, torch.float32, device="cpu").device.type == "cpu"


def test_no_silent_cpu_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    _, st = _specs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_plan(st, ExecPlan())
    with pytest.raises(RuntimeError):
        make_spec(8)
    with pytest.raises(RuntimeError):
        convert.readout_from_numpy(np.zeros((9, 1)), 0)


def test_unported_paths_raise_not_implemented(gloo_mesh):
    sj, st = _specs()
    # an unknown tableau is the reference's ValueError
    with pytest.raises(ValueError, match="unknown tableau"):
        compile_plan(st._replace(tableau="rk2"), device="cpu")
    with pytest.raises(ValueError, match="unknown tableau"):
        jcompile(sj._replace(tableau="rk2"))
    # the physics families are served, and refuse a mesh plan as the
    # reference's do (families are unsharded)
    assert make_spec(8, topology="time_multiplexed", device="cpu").topology == "time_multiplexed"
    with pytest.raises(ValueError, match="mesh plans shard the coupled array"):
        compile_plan(make_spec(8, topology="time_multiplexed", device="cpu"),
                     ExecPlan(mesh=gloo_mesh), device="cpu")
    sim = compile_plan(st, ExecPlan(impl="ref", ensemble=2), device="cpu")
    with pytest.raises(ValueError):
        sim.tick_chunk(
            torch.zeros(3, 12, 2), np.zeros((1, 2, 2)), targets=np.zeros((1, 2, 1))
        )


def test_make_spec_matches_reference_leaves():
    sj, _ = _specs()
    st = make_spec(12, n_in=2, seed=1, hold_steps=3, device="cpu")
    for a, b in ((st.w_cp, sj.w_cp), (st.w_in, sj.w_in), (st.m0, sj.m0)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert (st.n, st.n_in, st.dtype, st.device.type) == (12, 2, torch.float32, "cpu")


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("impl", ["ref", "chunk", "fused", "tiled"])
def test_tick_chunk_matches_reference(impl, dt):
    e, k = 4, 4
    jdt, tdt = DTYPES[dt]
    atol = F32_ATOL if dt == "f32" else F64_ATOL
    with jax.enable_x64(True):
        sj, st = _specs(dt=dt)
        u, mask = _block(k, e, sj.n_in)
        pj = jbroadcast(sj.params, e, current=np.linspace(2e-3, 3e-3, e))
        simj = jcompile(sj, JPlan(impl="ref" if impl != "chunk" else "chunk", ensemble=e, chunk_ticks=k))
        m0 = jnp.broadcast_to(jnp.transpose(sj.m0)[:, :, None], (3, sj.n, e)).astype(jdt)
        mj, statesj = simj.tick_chunk(m0, jnp.asarray(u, jdt), lane_mask=jnp.asarray(mask), params=pj)
        mj, statesj = np.asarray(mj), np.asarray(statesj)
    sim = compile_plan(st, ExecPlan(impl=impl, ensemble=e, chunk_ticks=k), device="cpu")
    pt = convert.params_from_numpy(
        type(pj)(*[np.asarray(x) for x in pj]), device="cpu", dtype=tdt
    )
    m0t = torch.tensor(np.asarray(m0))
    mt, statest = sim.tick_chunk(m0t, u, lane_mask=mask, params=pt)
    np.testing.assert_allclose(mt.numpy(), mj, atol=atol)
    np.testing.assert_allclose(statest.numpy(), statesj, atol=atol)
    # the lane retired after tick 1 holds still, bit-identically
    assert all(torch.equal(statest[t, :, 2], statest[1, :, 2]) for t in range(2, k))


@pytest.mark.parametrize("impl,dt", [("fused", "f32"), ("ref", "f64")])
def test_tick_drive_batch_integrate_match_reference(impl, dt):
    e, t_len = 3, 5
    jdt, tdt = DTYPES[dt]
    atol = F32_ATOL if dt == "f32" else F64_ATOL
    rng = np.random.default_rng(5)
    u = rng.uniform(0, 0.5, (t_len, 2))
    lane = np.array([True, False, True])
    with jax.enable_x64(True):
        sj, st = _specs(dt=dt)
        simj = jcompile(sj, JPlan(impl="ref", ensemble=e))
        drive_j = [np.asarray(x) for x in simj.drive_batch(jnp.asarray(u, jdt))]
        m_planes = jnp.broadcast_to(jnp.transpose(sj.m0)[:, :, None], (3, sj.n, e))
        tick_j = [np.asarray(x) for x in simj.tick(m_planes, jnp.asarray(u[:e], jdt), lane_mask=jnp.asarray(lane))]
        integ_j = [np.asarray(x) for x in simj.integrate(6, save_every=3)]
    sim = compile_plan(st, ExecPlan(impl=impl, ensemble=e), device="cpu")
    m_t = torch.tensor(np.asarray(m_planes))
    for got, want in (
        (sim.drive_batch(u), drive_j),
        (sim.tick(m_t, u[:e], lane_mask=lane), tick_j),
        (sim.integrate(6, save_every=3), integ_j),
    ):
        for a, b in zip(got, want):
            assert a.dtype == tdt
            np.testing.assert_allclose(a.numpy(), b, atol=atol)
    assert torch.equal(sim.tick(m_t, u[:e], lane_mask=lane)[0][:, :, 1], m_t[:, :, 1])


def test_solo_drive_matches_reference():
    sj, st = _specs()
    u = np.random.default_rng(6).uniform(0, 0.5, (4, sj.n_in)).astype(np.float32)
    mj, xj = jcompile(sj, JPlan(impl="ref")).drive(jnp.asarray(u))
    mt, xt = compile_plan(st, ExecPlan(impl="chunk"), device="cpu").drive(u)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=F32_ATOL)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=F32_ATOL)


def test_interpret_and_auto_resolution_on_cpu():
    _, st = _specs()
    assert compile_plan(st, device="cpu").impl == "ref"
    sim = compile_plan(st, ExecPlan(impl="auto", ensemble=2, measure=True), device="cpu")
    assert sim.impl == "ref"
    assert ops.latency_table()[("cpu", 64, 64, 4, "highest")] == "ref"
    u, mask = _block(2, 4, st.n_in)
    a = compile_plan(st, ExecPlan(impl="chunk", ensemble=4, chunk_ticks=2), device="cpu")
    b = compile_plan(st, dataclasses.replace(a.plan, interpret=True), device="cpu")
    m0 = st.m0.T[:, :, None].expand(3, st.n, 4).contiguous()
    ra, rb = a.tick_chunk(m0, u, lane_mask=mask), b.tick_chunk(m0, u, lane_mask=mask)
    for x, y in zip(ra, rb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6)
    b.warmup()
