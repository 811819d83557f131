"""Sharded plans (ExecPlan(mesh=DeviceMesh)) of the port on the CPU, over gloo.

In process, on a world-size-1 gloo group (a FileStore, no port) and its
(1, 1) DeviceMesh ("data", "model"):
  - the reference's passing 1-device cases (tests/test_api_plan.py
    TestShardedPlans, tests/test_rls_learning.py's sharded learn case,
    tests/test_plan_cache.py's sharded cases): the port's mesh plan within
    1e-6 of the reference's 1-device mesh plan (the reference tests'
    tolerance; the RLS chunk's P, W and predictions within 5e-5 of their
    largest magnitude, f32 updates across the packages, 8.7e-6 read), and
    bit for bit the port's unsharded impl="scan"
    (a shared drive series is contracted once a sample, 'ni,i->n', where
    scan contracts per lane: held to 1e-6 there);
  - the reference's test_sharded_serving_engine, which fails on the
    reference itself (ROADMAP queue 3, traps), held against the reference's
    solo drive at that test's ATOL (5e-5);
  - the plan's validation rules, reservoir_specs against the reference's
    PartitionSpecs key for key, mixed-spec tenancy refused.

Across 4 gloo ranks (one subprocess a rank, started once for the module):
meshes (2, 2) ("data", "model"), (4,) ("data",) with model_axis=None and
(1, 4), a (2, 2) whose ranks are laid out against their order, and a
(2, 2) ("pod", "data") with E over both, at N = 16, E = 8; each rank
writes its outputs, and the parent holds
them against the UNSHARDED reference, one case per check, with the
reference's bounds (tests/test_sharded_ensemble.py, test_distributed.py):
f64 integrate < 1e-10 (< 1e-12 without a model axis: the same products in
every lane), drive per member against the solo drive < 1e-9, a bf16 gather
< 5e-2 with norm_error < 1e-4; tick_chunk with masks in f32 < 1e-6 (masked
lanes bit-identical); the RLS chunk at learn_reg 1e-2 in f64 within 5e-6
of max |W| (and of max |P|, max |preds|); an engine on (2, 2) against the
solo drive at 5e-5; autoscale refused for a bucket width the 2-wide data
axis does not divide; compressed_psum on replicated input < 0.05 and on
distinct inputs bit-equal to a numpy emulation of its int8 arithmetic;
ring_allgather bit-equal to all_gather; every rank's outputs bit-identical.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro import api as japi
from repro.core import tasks as jtasks
from repro.core.ensemble import broadcast_params as jbroadcast
from repro.core.ensemble import drive_ensemble_sharded as jdrive_ensemble_sharded
from repro.distributed.sharding import reservoir_specs as jreservoir_specs
from repro.kernels import ops as jops
from repro_torch import api
from repro_torch.api import ExecPlan, PlanCache, cache, compile_plan, make_spec, plan_cache_key
from repro_torch.core import broadcast_params, default_params, norm_error
from repro_torch.core.ensemble import drive_ensemble_sharded
from repro_torch.distributed import axis_size, reservoir_specs
from repro_torch.kernels import ops
from repro_torch.serve import reservoir
from repro_torch.serve.reservoir import ReservoirEngine, StreamSession, _ensemble_axis_size
from repro_torch.tune import driver as tune_driver

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 5e-5  # tests/test_api_plan.py's engine tolerance
SHARD_ATOL = 1e-6  # tests/test_api_plan.py's sharded-vs-unsharded tolerance


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A world-size-1 gloo process group over a FileStore and its (1, 1)
    DeviceMesh ("data", "model"), destroyed at teardown."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.fixture
def plan_cache(monkeypatch):
    """A fresh PlanCache as the process-wide one: a cached sim holds its
    mesh, and this module's mesh lives only as long as its process group."""
    fresh = PlanCache()
    for mod in (cache, api, reservoir, tune_driver):
        monkeypatch.setattr(mod, "PLAN_CACHE", fresh)
    yield fresh


def _jmesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _specs(n=8, hold_steps=5):
    """The reference's tests/test_api_plan.py spec and the port's twin (the
    same seed: byte-identical W^cp, W^in)."""
    return (
        japi.make_spec(n=n, n_in=1, hold_steps=hold_steps, dtype=jnp.float32),
        make_spec(n, n_in=1, hold_steps=hold_steps, device="cpu"),
    )


def _u(t=6, n_in=1, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 0.5, (t, n_in)).astype(np.float32)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _close(a, b, atol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)


def _equal(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


# ---------------------------------------------------------------------------
# world size 1: the reference's 1-device cases and the port's scan, bit for bit
# ---------------------------------------------------------------------------


class TestOneRankMesh:
    def test_sharded_matches_unsharded_1device(self, mesh):
        """tests/test_api_plan.py:164: drive_batch (shared series) and
        integrate(20) on a (1, 1) mesh."""
        sj, st = _specs(hold_steps=4)
        e, u = 4, _u(5)
        jsh = japi.compile_plan(sj, japi.ExecPlan(ensemble=e, mesh=_jmesh()))
        sh = compile_plan(st, ExecPlan(ensemble=e, mesh=mesh), device="cpu")
        un = compile_plan(st, ExecPlan(impl="scan", ensemble=e), device="cpu")
        assert sh.impl == "scan" and sh.plan.sharded
        mT, s = sh.drive_batch(u)
        jmT, js = jsh.drive_batch(u)
        _close(s, js, SHARD_ATOL)
        _close(mT, jmT, SHARD_ATOL)
        umT, us = un.drive_batch(u)  # per-lane contraction: another op
        _close(s, us, SHARD_ATOL)
        _close(mT, umT, SHARD_ATOL)
        out = sh.integrate(20)
        assert out[1] is None
        _close(out[0], jsh.integrate(20)[0], SHARD_ATOL)
        _equal(out[0], un.integrate(20)[0])

    def test_drive_batch_per_lane_bit_equal_to_scan(self, mesh):
        sj, st = _specs(hold_steps=4)
        e = 4
        u = np.random.default_rng(1).uniform(0.0, 0.5, (5, e, 1)).astype(np.float32)
        sh = compile_plan(st, ExecPlan(ensemble=e, mesh=mesh), device="cpu")
        un = compile_plan(st, ExecPlan(impl="scan", ensemble=e), device="cpu")
        jsh = japi.compile_plan(sj, japi.ExecPlan(ensemble=e, mesh=_jmesh()))
        for a, b in zip(sh.drive_batch(u), un.drive_batch(u)):
            _equal(a, b)
        for a, b in zip(sh.drive_batch(u), jsh.drive_batch(u)):
            _close(a, b, SHARD_ATOL)

    def test_sharded_tick_masks_and_matches(self, mesh):
        """tests/test_api_plan.py:180: one tick, a frozen lane."""
        sj, st = _specs(hold_steps=4)
        e = 4
        jsh = japi.compile_plan(sj, japi.ExecPlan(ensemble=e, mesh=_jmesh()))
        sh = compile_plan(st, ExecPlan(ensemble=e, mesh=mesh), device="cpu")
        un = compile_plan(st, ExecPlan(impl="scan", ensemble=e), device="cpu")
        m = st.m0.T[:, :, None].expand(3, st.n, e).contiguous()
        u_t = _u(e).reshape(e, 1)
        mask = np.asarray([True, False, True, True])
        m_s, st_s = sh.tick(m, u_t, mask)
        m_u, st_u = un.tick(m, u_t, mask)
        jm, jst = jsh.tick(jnp.asarray(_np(m)), jnp.asarray(u_t), jnp.asarray(mask))
        _equal(m_s, m_u)
        _equal(st_s, st_u)
        _close(m_s, jm, SHARD_ATOL)
        _close(st_s, jst, SHARD_ATOL)
        _equal(m_s[:, :, 1], m[:, :, 1])  # the frozen lane, bit for bit

    def test_tick_chunk_bit_equal_to_scan(self, mesh):
        """A chunk with lanes frozen, retired and admitted mid-chunk."""
        _, st = _specs(n=8, hold_steps=4)
        e, k = 4, 4
        rng = np.random.default_rng(2)
        u = rng.uniform(0.0, 0.5, (k, e, 1)).astype(np.float32)
        mask = np.ones((k, e), bool)
        mask[:, 1] = False
        mask[:2, 2] = False  # admitted at tick 2
        mask[2:, 3] = False  # retired after tick 1
        m0 = ops.to_planes(st.m0.expand(e, st.n, 3)).contiguous()
        sh = compile_plan(st, ExecPlan(ensemble=e, chunk_ticks=k, mesh=mesh), device="cpu")
        un = compile_plan(st, ExecPlan(impl="scan", ensemble=e, chunk_ticks=k), device="cpu")
        a, b = sh.tick_chunk(m0, u, mask), un.tick_chunk(m0, u, mask)
        _equal(a[0], b[0])
        _equal(a[1], b[1])
        _equal(a[0][:, :, 1], m0[:, :, 1])
        assert a[0].is_contiguous() and a[1].shape == (k, st.n, e)

    def test_sharded_learn_bitexact_on_one_device_mesh(self, mesh):
        """tests/test_rls_learning.py:399: the RLS chunk on a (1, 1) mesh is
        the unsharded scan's bit for bit (m, states, P, W, preds)."""
        sj, st = _specs(n=8, hold_steps=4)
        e, k = 4, 3
        rng = np.random.default_rng(0)
        u = rng.uniform(0, 0.5, (k, e, 1)).astype(np.float32)
        y = rng.normal(size=(k, e, 1)).astype(np.float32)
        mask = np.ones((k, e), bool)
        mask[2, 1] = False
        kw = dict(ensemble=e, chunk_ticks=k, learn="rls", learn_reg=1e-2)
        unsh = compile_plan(st, ExecPlan(impl="scan", **kw), device="cpu")
        sh = compile_plan(st, ExecPlan(mesh=mesh, **kw), device="cpu")
        jsh = japi.compile_plan(sj, japi.ExecPlan(mesh=_jmesh(), **kw))
        m0 = ops.to_planes(st.m0.expand(e, 8, 3)).contiguous()
        p0, w0 = unsh.init_learn_state()
        a = unsh.tick_chunk(m0, u, mask, targets=y, learn_state=(p0, w0))
        b = sh.tick_chunk(m0, u, mask, targets=y, learn_state=(p0, w0))
        jp0, jw0 = jsh.init_learn_state()
        c = jsh.tick_chunk(jnp.asarray(_np(m0)), u, jnp.asarray(mask), targets=y,
                           learn_state=(jp0, jw0))
        pairs = [(a[0], b[0], c[0]), (a[1], b[1], c[1]), (a[2][0], b[2][0], c[2][0]),
                 (a[2][1], b[2][1], c[2][1]), (a[3], b[3], c[3])]
        for i, (x, z, j) in enumerate(pairs):
            _equal(x, z)
            if i < 2:  # m and states
                _close(z, j, SHARD_ATOL)
            else:  # P, W, preds: f32 RLS updates across packages, relative
                _close(z, j, ATOL * max(1.0, float(np.abs(_np(j)).max())))

    def test_drive_ensemble_sharded(self, mesh):
        """core.ensemble.drive_ensemble_sharded (shared series) against the
        reference's on a 1-device mesh, f32."""
        sj, st = _specs(n=8, hold_steps=3)
        e = 4
        cur = np.linspace(2e-3, 3e-3, e)
        pe = broadcast_params(st.params, e, current=torch.as_tensor(cur, dtype=torch.float32))
        jpe = jbroadcast(sj.params, e, current=jnp.asarray(cur, jnp.float32))
        u = _u(6)
        m0 = st.m0.expand(e, st.n, 3)
        mT, s = drive_ensemble_sharded(mesh, pe, st.w_cp, st.w_in, m0, torch.as_tensor(u),
                                       st.dt, st.hold_steps)
        jmT, js = jdrive_ensemble_sharded(_jmesh(), jpe, sj.w_cp, sj.w_in,
                                          jnp.broadcast_to(sj.m0, (e, st.n, 3)),
                                          jnp.asarray(u), sj.dt, sj.hold_steps)
        _close(s, js, SHARD_ATOL)
        _close(mT, jmT, SHARD_ATOL)

    def test_sharded_serving_engine(self, mesh, plan_cache):
        """tests/test_api_plan.py:194 (which fails on the reference itself):
        an engine on the (1, 1) mesh serves streams that match the
        reference's solo drive, and the port's scan engine bit for bit."""
        sj, st = _specs(n=8, hold_steps=5)
        eng = ReservoirEngine(compile_plan(st, ExecPlan(ensemble=3, mesh=mesh), device="cpu"))
        scan_eng = ReservoirEngine(compile_plan(st, ExecPlan(impl="scan", ensemble=3),
                                                device="cpu"))
        solo = japi.compile_plan(sj, impl="scan")
        rng = np.random.default_rng(3)
        sessions, refs = [], {}
        for sid in range(5):
            u = rng.uniform(0.0, 0.5, size=(4 + sid, 1)).astype(np.float32)
            refs[sid] = np.asarray(solo.drive(jnp.asarray(u))[1])
            sessions.append(u)
        results = eng.run([StreamSession(sid=i, u_seq=u) for i, u in enumerate(sessions)])
        again = scan_eng.run([StreamSession(sid=i, u_seq=u) for i, u in enumerate(sessions)])
        assert set(results) == set(refs)
        for sid, r in results.items():
            _close(r.states, refs[sid], ATOL)
            _equal(r.states, again[sid].states)
            _equal(r.final_m, again[sid].final_m)

    def test_sharded_learning_engine_bit_equal_to_scan(self, mesh, plan_cache):
        _, st = _specs(n=8, hold_steps=3)
        u_all, y_all = jtasks.narma_series(60, order=2, seed=0)
        out = []
        for plan in (ExecPlan(ensemble=4, chunk_ticks=3, learn="rls", learn_reg=1e-2, mesh=mesh),
                     ExecPlan(impl="scan", ensemble=4, chunk_ticks=3, learn="rls",
                              learn_reg=1e-2)):
            eng = ReservoirEngine(compile_plan(st, plan, device="cpu"))
            sessions = [StreamSession(sid=i, u_seq=u_all[10 * i: 10 * i + 10 + i, None],
                                      targets=y_all[10 * i: 10 * i + 10 + i, None])
                        for i in range(5)]
            out.append(eng.run(sessions))
        for sid in range(5):
            a, b = out[0][sid], out[1][sid]
            for name in ("states", "final_m", "predictions"):
                _equal(getattr(a, name), getattr(b, name))
            _equal(a.learned_readout.w_out, b.learned_readout.w_out)

    def test_integrate_save_every_and_drive_refused(self, mesh):
        _, st = _specs()
        sh = compile_plan(st, ExecPlan(ensemble=2, mesh=mesh), device="cpu")
        with pytest.raises(NotImplementedError, match="save_every"):
            sh.integrate(4, save_every=2)
        solo = compile_plan(st, ExecPlan(ensemble=1, mesh=mesh), device="cpu")
        with pytest.raises(ValueError, match="no mesh"):
            solo.drive(_u(3))
        with pytest.raises(NotImplementedError, match="sharded plans warm"):
            sh.aot_compile()
        # aot on a mesh plan warms by one masked chunk instead
        assert compile_plan(st, ExecPlan(ensemble=2, mesh=mesh, aot=True), device="cpu").plan.aot

    def test_bf16_gather_within_reference_bounds(self, mesh):
        """precision="bf16_coupling" on the mesh (bf16 wire and operands,
        f32 sums) against the f32 mesh plan: tests/test_sharded_ensemble.py's
        bounds (5e-2, norm_error 1e-4)."""
        _, st = _specs(n=8)
        f32 = compile_plan(st, ExecPlan(ensemble=2, mesh=mesh), device="cpu").integrate(50)[0]
        sim = compile_plan(st, ExecPlan(ensemble=2, mesh=mesh, precision="bf16_coupling"),
                           device="cpu")
        assert sim._gather_dtype == torch.bfloat16
        bf = sim.integrate(50)[0]
        assert float((bf - f32).abs().max()) < 5e-2
        assert float(norm_error(bf)) < 1e-4
        assert not torch.equal(bf, f32)  # the reduced path really ran


class TestPlanRules:
    @pytest.mark.parametrize("impl", ["ref", "fused", "tiled", "chunk"])
    def test_sharded_plan_rejects_kernel_impls(self, mesh, impl):
        with pytest.raises(ValueError, match="mesh"):
            ExecPlan(impl=impl, mesh=mesh)
        with pytest.raises(ValueError, match="mesh"):
            japi.ExecPlan(impl=impl, mesh=_jmesh())

    def test_lms_refused_on_a_mesh(self, mesh):
        with pytest.raises(ValueError, match="lms"):
            ExecPlan(learn="lms", mesh=mesh)
        with pytest.raises(ValueError, match="lms"):
            japi.ExecPlan(learn="lms", mesh=_jmesh())
        assert ExecPlan(learn="rls", mesh=mesh).sharded

    def test_reduced_precision_allowed_on_a_mesh(self, mesh):
        """impl="scan" refuses reduced precision unless the plan is sharded,
        as the reference's does; effective_gather_dtype resolves alike."""
        with pytest.raises(ValueError):
            ExecPlan(impl="scan", precision="mixed")
        for precision in ("bf16_coupling", "mixed"):
            p = ExecPlan(impl="scan", precision=precision, mesh=mesh)
            jp = japi.ExecPlan(impl="scan", precision=precision, mesh=_jmesh())
            assert p.effective_gather_dtype == torch.bfloat16
            assert jp.effective_gather_dtype == jnp.bfloat16
        assert ExecPlan(mesh=mesh).effective_gather_dtype is None
        p = ExecPlan(mesh=mesh, precision="mixed", gather_dtype=torch.float32)
        assert p.effective_gather_dtype == torch.float32  # explicit wins
        with pytest.raises(ValueError, match="gather_dtype"):
            ExecPlan(mesh=mesh, gather_dtype="not-a-dtype")

    def test_mesh_must_name_the_plan_axes(self, mesh):
        with pytest.raises(ValueError, match="DeviceMesh"):
            ExecPlan(mesh=mesh, ensemble_axes=("pod",))
        with pytest.raises(ValueError, match="DeviceMesh"):
            ExecPlan(mesh=object())
        assert ExecPlan(mesh=mesh, ensemble_axes=("data", "model"), model_axis=None).sharded

    def test_device_must_agree_with_the_mesh(self, mesh):
        from repro_torch.api.compiled import _check_sharded

        _, st = _specs()
        with pytest.raises(ValueError, match="device type 'cpu'"):
            _check_sharded(st, ExecPlan(mesh=mesh), torch.device("cuda"))
        if not torch.cuda.is_available():  # the card is the default device
            with pytest.raises(RuntimeError, match="device='cpu'"):
                compile_plan(st, ExecPlan(mesh=mesh))

    def test_families_refuse_a_mesh(self, mesh):
        from repro_torch.api import make_time_multiplexed_spec

        with pytest.raises(ValueError, match="mesh plans shard the coupled array"):
            compile_plan(make_time_multiplexed_spec(4, hold_steps=2, device="cpu"),
                         ExecPlan(mesh=mesh), device="cpu")

    @pytest.mark.parametrize(
        "axes", [(("data",), "model"), (("data",), None), (("pod", "data"), "model"), ((), None)]
    )
    def test_reservoir_specs_match_the_reference(self, axes):
        ens, model = axes
        mine, ref = reservoir_specs(ens, model), jreservoir_specs(ens, model)
        assert set(mine) == set(ref)
        for key, spec in ref.items():
            want = tuple(spec) + (None,) * (len(mine[key]) - len(tuple(spec)))
            assert mine[key] == want, key

    def test_mixed_spec_tenancy_refused_on_a_sharded_engine(self, mesh, plan_cache):
        from repro_torch.api import make_time_multiplexed_spec

        _, st = _specs()
        eng = ReservoirEngine(compile_plan(st, ExecPlan(ensemble=2, mesh=mesh), device="cpu"))
        tm = make_time_multiplexed_spec(4, hold_steps=2, device="cpu")
        with pytest.raises(ValueError, match="sharded engines"):
            eng.submit(StreamSession(sid=0, u_seq=_u(3), spec=tm))


class TestShardedPlanCache:
    def test_plan_key_distinct_and_stable(self, mesh):
        """tests/test_plan_cache.py:104: a mesh plan's key collides with no
        other variant, and is stable across compiles."""
        plans = [
            ExecPlan(impl="scan"),
            ExecPlan(impl="chunk", ensemble=8),
            ExecPlan(impl="scan", ensemble=8),
            ExecPlan(impl="scan", ensemble=8, mesh=mesh),
            ExecPlan(impl="scan", ensemble=8, mesh=mesh, model_axis=None),
        ]
        keys = [plan_cache_key(p) for p in plans]
        assert len(set(keys)) == len(keys)
        assert plan_cache_key(ExecPlan(impl="scan", ensemble=8, mesh=mesh)) == keys[3]
        assert keys[3][6] == ((("data", 1), ("model", 1)), "cpu", (0,), ("data",), "model")

    def test_sharded_autoscale_allowed_when_widths_divide(self, mesh, plan_cache):
        """tests/test_plan_cache.py:313."""
        _, st = _specs(n=12, hold_steps=4)
        sim = plan_cache.get_or_compile(
            st, ExecPlan(impl="scan", ensemble=4, chunk_ticks=2, mesh=mesh), device="cpu"
        )
        eng = ReservoirEngine(sim, autoscale=True, min_slots=2, max_slots=8)
        assert eng.autoscale is not None
        rng = np.random.default_rng(5)
        sessions = [StreamSession(sid=i, u_seq=rng.uniform(0, 0.5, (6, 1)).astype(np.float32))
                    for i in range(3)]
        assert len(eng.run(sessions)) == 3

    def test_sharded_autoscale_rejects_indivisible_widths(self, mesh, plan_cache, monkeypatch):
        """tests/test_plan_cache.py:329 (the multi-rank module case refuses
        a real 2-wide data axis)."""
        _, st = _specs(n=12, hold_steps=4)
        sim = plan_cache.get_or_compile(
            st, ExecPlan(impl="scan", ensemble=4, chunk_ticks=2, mesh=mesh), device="cpu"
        )
        monkeypatch.setattr(reservoir, "_ensemble_axis_size", lambda plan: 3)
        with pytest.raises(ValueError, match="incompatible widths"):
            ReservoirEngine(sim, autoscale=True, min_slots=2, max_slots=8, prewarm=False)

    def test_axis_size_helpers(self, mesh):
        """tests/test_plan_cache.py:348."""
        assert _ensemble_axis_size(ExecPlan(impl="chunk")) == 1
        assert _ensemble_axis_size(ExecPlan(impl="scan", mesh=mesh)) == 1
        assert axis_size(mesh, ("data", "model")) == 1 and axis_size(mesh, None) == 1


# ---------------------------------------------------------------------------
# 4 gloo ranks against the unsharded reference
# ---------------------------------------------------------------------------

N, E = 16, 8
MESHES = {  # tag -> (shape, dim names, ensemble axes, model_axis, rank layout or None)
    "2x2": ((2, 2), ("data", "model"), ("data",), "model", None),
    "4": ((4,), ("data",), ("data",), None, None),
    "1x4": ((1, 4), ("data", "model"), ("data",), "model", None),
    # ranks laid out against their order: each dim's process group lists
    # them sorted, so blocks arrive out of coordinate order and are put back
    "2x2_permuted": ((2, 2), ("data", "model"), ("data",), "model", [[3, 2], [1, 0]]),
    # E over two mesh dims, row-major in the order listed
    "2x2_two_ensemble_axes": ((2, 2), ("pod", "data"), ("pod", "data"), None, None),
}
TICK_K = 3


def _tick_inputs():
    rng = np.random.default_rng(7)
    u = rng.uniform(0.0, 0.5, (TICK_K, E, 1)).astype(np.float32)
    mask = np.ones((TICK_K, E), bool)
    mask[:, 1] = False
    mask[0, 2] = False
    mask[2, 5] = False
    y = rng.normal(size=(TICK_K, E, 1))
    return u, mask, y


_SCRIPT = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out_dir = sys.argv[1]
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                        rank=rank, world_size=world)

from repro_torch.api import ExecPlan, compile_plan, make_spec
from repro_torch.core import broadcast_params, default_params, make_input_matrix, tasks
from repro_torch.core.ensemble import drive_ensemble_sharded
from repro_torch.distributed import collectives
from repro_torch.kernels import ops
from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

N, E, K = {N}, {E}, {K}
MESHES = {MESHES}
TICK = {TICK}
out = {{}}


def put(key, x):
    out[key] = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


p64 = default_params(torch.float64, device="cpu")
pe = broadcast_params(p64, E, current=torch.as_tensor(np.linspace(1e-3, 4e-3, E)))
spec64 = make_spec(N, seed=0, dtype=torch.float64, device="cpu")._replace(params=pe)
spec32 = make_spec(N, seed=0, hold_steps=4, device="cpu")
u_t, mask_t, y_t = TICK
for tag, (shape, names, ensemble_axes, model_axis, layout) in MESHES.items():
    if layout is None:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    else:
        mesh = DeviceMesh("cpu", torch.tensor(layout), mesh_dim_names=names)
    kw = dict(mesh=mesh, ensemble_axes=ensemble_axes, model_axis=model_axis)
    put(tag + "/integrate", compile_plan(spec64, ExecPlan(ensemble=E, **kw),
                                         device="cpu").integrate(50)[0])
    put(tag + "/integrate_bf16", compile_plan(
        spec64, ExecPlan(ensemble=E, gather_dtype=torch.bfloat16, **kw), device="cpu"
    ).integrate(50)[0])
    sim = compile_plan(spec32, ExecPlan(ensemble=E, chunk_ticks=K, **kw), device="cpu")
    m0 = ops.to_planes(spec32.m0.expand(E, N, 3)).contiguous()
    m, states = sim.tick_chunk(m0, u_t, mask_t)
    put(tag + "/tick_m", m)
    put(tag + "/tick_states", states)
    spec64h = make_spec(N, seed=0, hold_steps=4, dtype=torch.float64, device="cpu")
    sim = compile_plan(spec64h, ExecPlan(ensemble=E, chunk_ticks=K, learn="rls",
                                         learn_reg=1e-2, **kw), device="cpu")
    m0 = ops.to_planes(spec64h.m0.expand(E, N, 3)).contiguous()
    m, states, (p, w), preds = sim.tick_chunk(
        m0, u_t.astype(np.float64), mask_t, targets=y_t, learn_state=sim.init_learn_state()
    )
    for name, x in (("m", m), ("states", states), ("P", p), ("W", w), ("preds", preds)):
        put(tag + "/rls_" + name, x)

# the shared-series drive, member by member (tests/test_sharded_ensemble.py)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
p300 = p64._replace(a_in=torch.tensor(300.0, dtype=torch.float64))
pe2 = broadcast_params(p300, 4, current=torch.as_tensor(np.linspace(2e-3, 3e-3, 4)))
win = torch.as_tensor(make_input_matrix(N, 1, seed=1))
u, _ = tasks.narma_series(30, order=2, seed=0)
mT, states = drive_ensemble_sharded(
    mesh, pe2, spec64.w_cp, win, spec64.m0.expand(4, N, 3),
    torch.as_tensor(u[:, None], dtype=torch.float64), spec64.dt, 10)
put("drive_states", states)
put("drive_m", mT)

# an engine on (2, 2): 5 streams (tests/test_api_plan.py:194's)
spec8 = make_spec(8, n_in=1, hold_steps=5, device="cpu")
eng = ReservoirEngine(compile_plan(spec8, ExecPlan(ensemble=4, mesh=mesh), device="cpu"))
rng = np.random.default_rng(3)
res = eng.run([StreamSession(sid=sid, u_seq=rng.uniform(0.0, 0.5, size=(4 + sid, 1))
                             .astype(np.float32)) for sid in range(5)])
for sid, r in res.items():
    put("engine/%d" % sid, r.states)

# autoscale: widths 3 / 6 / 12 on a 2-wide data axis are refused, 2 / 4 / 8 serve
sim6 = compile_plan(make_spec(N, hold_steps=2, device="cpu"),
                    ExecPlan(ensemble=6, chunk_ticks=2, mesh=mesh), device="cpu")
try:
    ReservoirEngine(sim6, num_slots=6, autoscale=True, min_slots=3, max_slots=12, prewarm=False)
    put("autoscale_refused", "")
except ValueError as exc:
    put("autoscale_refused", str(exc))
sim4 = compile_plan(make_spec(N, hold_steps=2, device="cpu"),
                    ExecPlan(ensemble=4, chunk_ticks=2, mesh=mesh), device="cpu")
eng = ReservoirEngine(sim4, autoscale=True, min_slots=2, max_slots=8)
rng = np.random.default_rng(5)
res = eng.run([StreamSession(sid=i, u_seq=rng.uniform(0, 0.5, (5 + i, 1)).astype(np.float32))
               for i in range(12)])
put("autoscale_sids", sorted(res))
put("autoscale_states_0", res[0].states)
put("autoscale_widths", sorted(eng._sims))
# an ensemble the data axis does not divide
try:
    compile_plan(spec8, ExecPlan(ensemble=5, mesh=mesh), device="cpu")
    put("indivisible", "")
except ValueError as exc:
    put("indivisible", str(exc))

# the collectives on the 4-wide data group
mesh4 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
grads = {{"a": torch.as_tensor(np.random.default_rng(0).standard_normal((8, 16)), dtype=torch.float32),
          "b": [torch.as_tensor(np.random.default_rng(1).standard_normal((4,)), dtype=torch.float32)]}}
red = collectives.dp_mean_grads_compressed(mesh4, grads, axis_name="data")
put("psum_err", max(float((red["a"] - grads["a"]).abs().max()),
                    float((red["b"][0] - grads["b"][0]).abs().max())))
x = torch.as_tensor(np.random.default_rng(10 + rank).standard_normal((8, 16)), dtype=torch.float32)
put("psum_distinct", collectives.compressed_psum(x, mesh4.get_group("data"), 4))
g = mesh4.get_group("data")
x = torch.as_tensor(np.random.default_rng(20 + rank).standard_normal((3, 5)), dtype=torch.float32)
blocks = [torch.empty_like(x) for _ in range(4)]
dist.all_gather(blocks, x, group=g)
put("ring", collectives.ring_allgather(x, g))
put("all_gather", torch.stack(blocks))

np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **out)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run _SCRIPT on 4 gloo ranks (one process each); the ranks' outputs."""
    out_dir = tmp_path_factory.mktemp("ranks")
    u, mask, y = _tick_inputs()
    script = textwrap.dedent(_SCRIPT).format(
        N=N, E=E, K=TICK_K, MESHES=repr(MESHES),
        TICK=f"(np.array({u.tolist()!r}, np.float32), np.array({mask.tolist()!r}), "
             f"np.array({y.tolist()!r}))",
    )
    path = out_dir / "ranks.py"
    path.write_text(script)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), WORLD_SIZE="4",
               OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, str(path), str(out_dir)], cwd=ROOT,
                         env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for r in range(4)
    ]
    errs = []
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=240)
            if proc.returncode:
                errs.append(f"rank {r} exited {proc.returncode}:\n{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not errs, "\n".join(errs)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def reference():
    """The unsharded reference's results on the ranks' inputs."""
    from repro.core import DT, make_input_matrix
    from repro.core.reservoir import Reservoir, drive

    out = {}
    u, mask, y = _tick_inputs()
    with jax.enable_x64(True):
        p64 = japi.make_spec(N, seed=0, dtype=jnp.float64).params
        pe = jbroadcast(p64, E, current=jnp.asarray(np.linspace(1e-3, 4e-3, E)))
        spec64 = japi.make_spec(N, seed=0, dtype=jnp.float64)._replace(params=pe)
        out["integrate"] = np.asarray(
            japi.compile_plan(spec64, impl="scan", ensemble=E).integrate(50)[0]
        )
        spec64h = japi.make_spec(N, seed=0, hold_steps=4, dtype=jnp.float64)
        sim = japi.compile_plan(spec64h, japi.ExecPlan(impl="scan", ensemble=E, chunk_ticks=TICK_K,
                                                       learn="rls", learn_reg=1e-2))
        m0 = jops.to_planes(jnp.broadcast_to(spec64h.m0, (E, N, 3)))
        m, states, (p, w), preds = sim.tick_chunk(
            m0, jnp.asarray(u, jnp.float64), jnp.asarray(mask), targets=jnp.asarray(y),
            learn_state=sim.init_learn_state(),
        )
        for name, x in (("m", m), ("states", states), ("P", p), ("W", w), ("preds", preds)):
            out["rls_" + name] = np.asarray(x)
        # the solo drive of each member (tests/test_sharded_ensemble.py)
        p300 = p64._replace(a_in=jnp.float64(300.0))
        cur = np.linspace(2e-3, 3e-3, 4)
        w_cp = spec64.w_cp
        win = jnp.asarray(make_input_matrix(N, 1, seed=1), jnp.float64)
        un, _ = jtasks.narma_series(30, order=2, seed=0)
        import warnings

        drives = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            for i in range(4):
                pi = p300._replace(current=jnp.float64(cur[i]))
                res = Reservoir(pi, w_cp, win, spec64.m0, float(DT), 10)
                drives.append(np.asarray(drive(res, jnp.asarray(un[:, None]))[1]))
        out["drive_states"] = np.stack(drives, axis=1)
    spec32 = japi.make_spec(N, seed=0, hold_steps=4, dtype=jnp.float32)
    sim = japi.compile_plan(spec32, japi.ExecPlan(impl="scan", ensemble=E, chunk_ticks=TICK_K))
    m, states = sim.tick_chunk(jops.to_planes(jnp.broadcast_to(spec32.m0, (E, N, 3))),
                               jnp.asarray(u), jnp.asarray(mask))
    out["tick_m"], out["tick_states"] = np.asarray(m), np.asarray(states)
    out["tick_m0"] = np.asarray(jops.to_planes(jnp.broadcast_to(spec32.m0, (E, N, 3))))
    solo = japi.compile_plan(japi.make_spec(n=8, n_in=1, hold_steps=5, dtype=jnp.float32),
                             impl="scan")
    rng = np.random.default_rng(3)
    for sid in range(5):
        u_s = rng.uniform(0.0, 0.5, size=(4 + sid, 1)).astype(np.float32)
        out[f"engine/{sid}"] = np.asarray(solo.drive(jnp.asarray(u_s))[1])
    return out


def _psum_emulated():
    """compressed_psum's arithmetic in numpy f32 over the ranks' inputs."""
    xs = [np.random.default_rng(10 + r).standard_normal((8, 16)).astype(np.float32)
          for r in range(4)]
    scale = max(np.float32(max(np.abs(x).max(), np.float32(1e-12))) / np.float32(127.0)
                for x in xs)
    q = sum(np.clip(np.round(x / scale), -127, 127).astype(np.int32) for x in xs)
    return (q.astype(np.float32) * scale) / np.float32(4)


class TestFourRanks:
    def test_every_rank_returns_the_same_bits(self, ranks):
        keys = set(ranks[0])
        for r in ranks[1:]:
            assert set(r) == keys
            for k in keys:
                np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)

    @pytest.mark.parametrize("tag", list(MESHES))
    def test_integrate_f64(self, ranks, reference, tag):
        err = np.abs(ranks[0][tag + "/integrate"] - reference["integrate"]).max()
        assert err < (1e-12 if MESHES[tag][3] is None else 1e-10), err

    @pytest.mark.parametrize("tag", list(MESHES))
    def test_bf16_gather(self, ranks, reference, tag):
        out = ranks[0][tag + "/integrate_bf16"]
        assert not np.array_equal(out, ranks[0][tag + "/integrate"])  # the bf16 path ran
        assert np.abs(out - reference["integrate"]).max() < 5e-2
        assert float(norm_error(torch.as_tensor(out))) < 1e-4

    def test_drive_per_member_against_solo(self, ranks, reference):
        err = np.abs(ranks[0]["drive_states"] - reference["drive_states"]).max()
        assert err < 1e-9, err

    @pytest.mark.parametrize("tag", list(MESHES))
    def test_tick_chunk_with_masks(self, ranks, reference, tag):
        r = ranks[0]
        _close(r[tag + "/tick_m"], reference["tick_m"], SHARD_ATOL)
        _close(r[tag + "/tick_states"], reference["tick_states"], SHARD_ATOL)
        # lane 1 is masked every tick: bit-identical to its input
        _equal(r[tag + "/tick_m"][:, :, 1], reference["tick_m0"][:, :, 1])

    @pytest.mark.parametrize("tag", list(MESHES))
    def test_rls_chunk(self, ranks, reference, tag):
        r = ranks[0]
        _close(r[tag + "/rls_states"], reference["rls_states"], 1e-10)
        _close(r[tag + "/rls_m"], reference["rls_m"], 1e-10)
        for name in ("W", "P", "preds"):
            want = reference["rls_" + name]
            _close(r[tag + "/rls_" + name], want, 5e-6 * np.abs(want).max())

    def test_engine_on_2x2(self, ranks, reference):
        for sid in range(5):
            _close(ranks[0][f"engine/{sid}"], reference[f"engine/{sid}"], ATOL)

    def test_autoscale_on_2x2(self, ranks):
        msg = str(ranks[0]["autoscale_refused"])
        assert "incompatible widths [3]" in msg and "ensemble-axis size 2" in msg, msg
        assert list(ranks[0]["autoscale_sids"]) == list(range(12))
        assert set(ranks[0]["autoscale_widths"]) >= {4}
        msg = str(ranks[0]["indivisible"])
        assert "ensemble=5" in msg and "size 2" in msg, msg

    def test_compressed_psum(self, ranks):
        assert float(ranks[0]["psum_err"]) < 0.05
        np.testing.assert_array_equal(ranks[0]["psum_distinct"], _psum_emulated())

    def test_ring_allgather(self, ranks):
        np.testing.assert_array_equal(ranks[0]["ring"], ranks[0]["all_gather"])
        for r in range(4):
            want = np.random.default_rng(20 + r).standard_normal((3, 5)).astype(np.float32)
            np.testing.assert_array_equal(ranks[0]["ring"][r], want)
