"""The port's process-wide plan cache (repro_torch.api.cache) on the CPU.

Restates tests/test_plan_cache.py's cases that are not sharded (the sharded
autoscale cases wait for ROADMAP queue 1 item 12), the tune case among them,
with the port's device argument, and adds:

- the cross-package hash: the port's spec_structural_hash returns the JAX
  reference's hex digest for seed-made specs (N = 8 and 64, f32 and f64,
  scalar and broadcast_params leaves), and for the reference's plans
  plan_cache_key returns the reference's tuple;
- the device in the key: a CPU entry never answers a card request;
- the ExecPlan field fence: every field is keyed, or enters through the
  mesh, or is a policy field (aot, compilation_cache_dir) left out;
- enable_persistent_cache's first-directory rule, aot_compile's launch
  configuration (the card's path with the library and its queries stubbed),
  a prewarm failure recorded in prewarm_errors, and serving beside the
  prewarm thread bit-equal to serving without it.

Every test runs against a fresh PlanCache swapped in for the process-wide
one, with empty dispatch tables, after every earlier prewarm thread has
ended; the fixture restores all of it. Bit-exactness is by construction (a
hit is the same CompiledSim), so cached results are compared with fresh
compiles exactly; no tolerance is involved.
"""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.api as api
from repro.api import ExecPlan as JPlan
from repro.api import make_spec as jmake_spec
from repro.api import plan_cache_key as jplan_cache_key
from repro.api import spec_structural_hash as jhash
from repro.core.ensemble import broadcast_params as jbroadcast
from repro.serve.reservoir import _bucket_ladder as j_bucket_ladder
from repro_torch import convert
from repro_torch.api import (
    ExecPlan,
    PlanCache,
    cache,
    compile_plan,
    enable_persistent_cache,
    make_spec,
    plan_cache_key,
    spec_structural_hash,
)
from repro_torch.core.ensemble import broadcast_params
from repro_torch.kernels import _build, dispatch_table, ops, sto_step
from repro_torch.serve import reservoir
from repro_torch.serve.reservoir import ReservoirEngine, StreamSession, _bucket_ladder
from repro_torch.tune import driver as tune_driver

torch.set_num_threads(2)


def _join_prewarm_threads():
    for t in threading.enumerate():
        if t.name == "plan-prewarm":
            t.join(timeout=120)
            assert not t.is_alive(), "a prewarm thread hung"


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


@pytest.fixture
def plan_cache(monkeypatch):
    """A fresh PlanCache as the process-wide one, empty dispatch tables."""
    _join_prewarm_threads()
    fresh = PlanCache()
    for mod in (cache, api, reservoir, tune_driver):
        monkeypatch.setattr(mod, "PLAN_CACHE", fresh)
    monkeypatch.setattr(ops, "_LATENCY_TABLE", {})
    monkeypatch.setattr(ops, "_DISPATCH_GEN", ops._DISPATCH_GEN)
    monkeypatch.setattr(dispatch_table, "_LOADED", set())
    yield fresh
    _join_prewarm_threads()


@pytest.fixture
def build_dir(monkeypatch, tmp_path):
    """enable_persistent_cache's process-wide state, restored afterwards."""
    monkeypatch.setattr(_build, "_PINNED_DIR", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "default")
    monkeypatch.setattr(_build, "_LIB", None)
    return tmp_path


def _spec(n=12, seed=0, hold=4):
    return make_spec(n, n_in=1, hold_steps=hold, seed=seed, device="cpu")


def _scaled_params(spec, factor):
    """Same structure, other scalar values (per-lane inputs at run time)."""
    return type(spec.params)(*(leaf * factor for leaf in spec.params))


def _sessions(rng, count, ticks=6, base_sid=0):
    return [
        StreamSession(
            sid=base_sid + i,
            u_seq=rng.uniform(0, 0.5, (ticks, 1)).astype(np.float32),
            collect_states=False,
        )
        for i in range(count)
    ]


# ---------------------------------------------------------------------------
# key anatomy
# ---------------------------------------------------------------------------


def test_structural_hash_ignores_param_values():
    spec = _spec(seed=900_001)
    revalued = spec._replace(params=_scaled_params(spec, 1.5))
    assert spec_structural_hash(spec) == spec_structural_hash(revalued)


def test_structural_hash_sees_structure():
    base = _spec(seed=900_002)
    variants = [
        base._replace(dt=base.dt * 2.0),
        base._replace(hold_steps=5),
        base._replace(tableau="heun"),
        _spec(seed=900_003),
        _spec(n=14, seed=900_002),
    ]
    h0 = spec_structural_hash(base)
    hashes = [spec_structural_hash(v) for v in variants]
    assert all(h != h0 for h in hashes), hashes
    assert len(set(hashes)) == len(hashes)


def test_structural_hash_sees_an_in_place_edit():
    """The hash is memoized per tensor identity and version: writing into
    W in place moves it, as a fresh hash of the new contents would."""
    spec = _spec(seed=900_004)
    h0 = spec_structural_hash(spec)
    assert spec_structural_hash(spec) == h0
    spec.w_cp[0, 1] += 1.0
    h1 = spec_structural_hash(spec)
    assert h1 != h0
    twin = spec._replace(w_cp=spec.w_cp.clone(), w_in=spec.w_in.clone(), m0=spec.m0.clone())
    assert spec_structural_hash(twin) == h1


@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("leaves", ["scalar", "ensemble"])
def test_structural_hash_equals_the_reference(n, dtype, leaves):
    """The same hex digest from both packages for a seed-made spec: the
    port's make_spec gives byte-identical W^cp / W^in / m0."""
    jd, td = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}[dtype]
    with jax.enable_x64(dtype == "f64"):
        sj = jmake_spec(n, n_in=2, seed=5, hold_steps=7, dtype=jd)
        st = make_spec(n, n_in=2, seed=5, hold_steps=7, dtype=td, device="cpu")
        if leaves == "ensemble":
            sj = sj._replace(params=jbroadcast(sj.params, 3))
            st = st._replace(params=broadcast_params(st.params, 3))
        want = jhash(sj)
    assert spec_structural_hash(st) == want
    # the spec carried across from the reference's leaves hashes alike
    carried = convert.spec_from_numpy(
        type(sj.params)(*[np.asarray(x) for x in sj.params]), np.asarray(sj.w_cp),
        np.asarray(sj.w_in), np.asarray(sj.m0), sj.dt, sj.hold_steps, device="cpu",
    )
    assert spec_structural_hash(carried) == want


def test_plan_key_separates_executable_axes():
    plans = [
        ExecPlan(impl="scan"),
        ExecPlan(impl="chunk"),
        ExecPlan(impl="chunk", ensemble=8),
        ExecPlan(impl="chunk", ensemble=8, chunk_ticks=4),
        ExecPlan(impl="chunk", ensemble=8, precision="mixed"),
        ExecPlan(impl="chunk", ensemble=8, learn="rls"),
        ExecPlan(impl="chunk", ensemble=8, learn="rls", learn_lam=0.99),
        ExecPlan(impl="chunk", ensemble=8, learn="lms"),
        ExecPlan(impl="chunk", ensemble=8, interpret=True),
    ]
    keys = [plan_cache_key(p) for p in plans]
    assert len(set(keys)) == len(keys), "plan-key collision across variants"


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(impl="scan"),
        dict(impl="chunk", ensemble=8, chunk_ticks=4, precision="mixed"),
        dict(impl="tiled", ensemble=16, block_n=128, block_e=128, n_inner=2),
        dict(impl="fused", ensemble=8, learn="rls", learn_lam=0.99, learn_reg=1e-2),
        dict(impl="ref", ensemble=4, learn="lms", learn_mu=0.3, interpret=True, measure=True),
        dict(impl="chunk", precision="highest", aot=True, compilation_cache_dir="/x"),
    ],
)
def test_plan_key_is_the_references(kwargs):
    """Field for field the reference's key (non-auto plans carry no
    dispatch generation; the device is the cache key's third part)."""
    assert plan_cache_key(ExecPlan(**kwargs)) == jplan_cache_key(JPlan(**kwargs))
    gd = plan_cache_key(ExecPlan(gather_dtype=torch.bfloat16, impl="scan"))
    assert gd == jplan_cache_key(JPlan(gather_dtype=jnp.bfloat16, impl="scan"))


def test_plan_key_fences_every_exec_plan_field(gloo_mesh):
    """An ExecPlan field the key omits would be a silent cache collision:
    every field is keyed, enters through the mesh, or is a policy field."""
    fields = [f.name for f in dataclasses.fields(ExecPlan)]
    groups = (cache._KEYED_FIELDS, cache._MESH_FIELDS, cache._POLICY_FIELDS)
    assert sorted(fields) == sorted(f for g in groups for f in g)
    # an explicit gather dtype, so that precision does not move it too
    base = ExecPlan(impl="chunk", ensemble=4, gather_dtype=torch.float32)
    moved = dict(
        impl="fused", ensemble=8, block_n=128, block_e=128, n_inner=2,
        gather_dtype=torch.bfloat16, precision="mixed", chunk_ticks=3, learn="rls",
        learn_lam=0.9, learn_reg=1e-3, learn_mu=0.3, interpret=True, measure=True,
    )
    assert sorted(moved) == sorted(cache._KEYED_FIELDS)
    # each keyed field moves one entry of the key, in _KEYED_FIELDS's order
    # (the key is written out by hand; the list must not drift from it)
    k0, where = plan_cache_key(base), []
    for name in cache._KEYED_FIELDS:
        k1 = plan_cache_key(dataclasses.replace(base, **{name: moved[name]}))
        changed = [j for j, (a, b) in enumerate(zip(k0, k1)) if a != b]
        assert len(k1) == len(k0) and len(changed) == 1, (name, changed)
        where.append(changed[0])
    assert where == sorted(set(where)), dict(zip(cache._KEYED_FIELDS, where))
    for name, value in dict(aot=True, compilation_cache_dir="/x").items():
        assert plan_cache_key(dataclasses.replace(base, **{name: value})) == plan_cache_key(base)
    # the mesh's axes enter only with a mesh: without one they move nothing,
    # with one each moves the key's mesh entry
    assert plan_cache_key(dataclasses.replace(base, ensemble_axes=("x",))) == plan_cache_key(base)
    sharded = dataclasses.replace(base, impl="scan", mesh=gloo_mesh)
    keys = {
        plan_cache_key(sharded),
        plan_cache_key(dataclasses.replace(sharded, model_axis=None)),
        plan_cache_key(dataclasses.replace(sharded, ensemble_axes=("model",), model_axis="data")),
    }
    assert len(keys) == 3 and plan_cache_key(sharded) != plan_cache_key(
        dataclasses.replace(base, impl="scan")
    )


def test_plan_key_excludes_pure_policy_fields():
    base = ExecPlan(impl="chunk", ensemble=4, chunk_ticks=4)
    assert plan_cache_key(base) == plan_cache_key(dataclasses.replace(base, aot=True))
    # compilation_cache_dir changes where the kernels are built, never what
    # they compute
    assert plan_cache_key(base) == plan_cache_key(
        dataclasses.replace(base, compilation_cache_dir="/tmp/nonexistent-pc")
    )


def test_auto_impl_key_tracks_dispatch_generation(plan_cache):
    k0 = plan_cache_key(ExecPlan(impl="auto", ensemble=2))
    ops.register_impl_choice(997, 3, "chunk")
    k1 = plan_cache_key(ExecPlan(impl="auto", ensemble=2))
    assert k0 != k1, "a new dispatch measurement must invalidate cached auto plans"


def test_cpu_and_card_keys_never_collide(plan_cache):
    spec = _spec(seed=900_005)
    plan = ExecPlan(impl="scan", ensemble=2)
    k_cpu, k_card = plan_cache.key(spec, plan, "cpu"), plan_cache.key(spec, plan, "cuda")
    assert k_cpu[:2] == k_card[:2] and k_cpu != k_card
    index = torch.cuda.current_device() if torch.cuda.is_available() else 0
    assert k_card == plan_cache.key(spec, plan, f"cuda:{index}")
    sim = plan_cache.get_or_compile(spec, plan, device="cpu")
    assert sim.device.type == "cpu"
    assert plan_cache.contains(spec, plan, device="cpu")
    assert not plan_cache.contains(spec, plan, device="cuda")
    plan_cache.warm(sim)
    assert plan_cache.is_warm(spec, plan, device="cpu")
    assert not plan_cache.is_warm(spec, plan, device="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            plan_cache.get_or_compile(spec, plan, device="cuda")
        assert len(plan_cache) == 1
        # the failed compile released its key: a retry raises again, no hang
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            plan_cache.get_or_compile(spec, plan, device="cuda")


# ---------------------------------------------------------------------------
# hit / rebind / evict semantics (local caches)
# ---------------------------------------------------------------------------


def test_hit_returns_same_object():
    pc = PlanCache()
    spec = _spec(seed=900_010)
    plan = ExecPlan(impl="scan", ensemble=2, chunk_ticks=2)
    a = pc.get_or_compile(spec, plan, device="cpu")
    b = pc.get_or_compile(spec, plan, device="cpu")
    assert a is b
    s = pc.stats
    assert (s.misses, s.hits, s.compiles, s.rebinds) == (1, 1, 1, 0)
    assert len(pc) == 1


def test_rebind_on_param_value_change_matches_fresh_compile():
    pc = PlanCache()
    spec = _spec(seed=900_011)
    plan = ExecPlan(impl="scan")
    pc.get_or_compile(spec, plan, device="cpu")
    revalued = spec._replace(params=_scaled_params(spec, 1.3))
    rebound = pc.get_or_compile(revalued, plan, device="cpu")
    assert pc.stats.rebinds == 1 and pc.stats.compiles == 1
    assert rebound.spec is revalued

    u = np.random.default_rng(0).uniform(0, 0.5, (5, 1)).astype(np.float32)
    _, states_cached = rebound.drive(u)
    _, states_fresh = compile_plan(revalued, plan, device="cpu").drive(u)
    assert torch.equal(states_cached, states_fresh), "the rebind is not a fresh compile's bits"


def test_eviction_roundtrip_bit_exact():
    pc = PlanCache(capacity=2)
    plan = ExecPlan(impl="scan")
    specs = [_spec(seed=900_020 + i) for i in range(3)]
    for s in specs:
        pc.get_or_compile(s, plan, device="cpu")
    assert pc.stats.evictions == 1 and len(pc) == 2
    assert not pc.contains(specs[0], plan, device="cpu")  # LRU victim

    u = np.random.default_rng(1).uniform(0, 0.5, (5, 1)).astype(np.float32)
    recompiled = pc.get_or_compile(specs[0], plan, device="cpu")
    assert pc.stats.compiles == 4  # paid the compile again
    _, states_re = recompiled.drive(u)
    _, states_fresh = compile_plan(specs[0], plan, device="cpu").drive(u)
    assert torch.equal(states_re, states_fresh)


def test_single_compile_under_concurrent_requests():
    pc = PlanCache()
    spec = _spec(seed=900_030)
    plan = ExecPlan(impl="scan", ensemble=2, chunk_ticks=2)
    sims, errs = [], []

    def work():
        try:
            sims.append(pc.get_or_compile(spec, plan, device="cpu"))
        except BaseException as e:  # noqa: BLE001 (surfaced in the main thread)
            errs.append(e)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert len(sims) == 4 and all(s is sims[0] for s in sims)
    assert pc.stats.compiles == 1, "the in-flight event failed to dedupe"


def test_plan_cache_under_many_threads(plan_cache):
    """16 threads over 4 keys with a short switch interval: one compile and
    one warm-up per key, every other lookup a hit, one CompiledSim per key."""
    specs = [_spec(seed=900_060 + i) for i in range(4)]
    plan = ExecPlan(impl="scan", ensemble=2)
    seen, errs = {}, []

    def work(i):
        try:
            for r in range(20):
                spec = specs[(i + r) % 4]
                sim = plan_cache.get_or_compile(spec, plan, device="cpu")
                plan_cache.warm(sim, aot=True)
                seen.setdefault(id(spec), set()).add(id(sim))
        except BaseException as e:  # noqa: BLE001 (surfaced in the main thread)
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errs
    st = plan_cache.stats
    assert st.misses == st.compiles == 4 and st.hits == 16 * 20 - 4 and st.warmups == 4
    assert len(seen) == 4 and all(len(ids) == 1 for ids in seen.values())


def test_launch_counts_from_two_threads(monkeypatch):
    """The prewarm thread and the serving thread both count launches: no
    count is lost."""
    monkeypatch.setattr(_build, "LAUNCHES", dict(_build.LAUNCHES))
    _build.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch("rk4_chunk")
                                                    for _ in range(2000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert _build.LAUNCHES["rk4_chunk"] == 16000


def test_measure_memo(plan_cache):
    pc = PlanCache()
    kw = dict(dt=1.0e-11, n_steps=2, reps=1, candidates=("ref",), device="cpu")
    first = pc.measure(8, 2, **kw)
    second = pc.measure(8, 2, **kw)
    assert second is first
    assert pc.stats.measure_misses == 1 and pc.stats.measure_hits == 1
    # a different shape is a fresh measurement
    pc.measure(8, 4, **kw)
    assert pc.stats.measure_misses == 2


def test_measure_memo_is_keyed_on_the_device(plan_cache, monkeypatch):
    seen = []

    def fake(n, e, **kw):
        seen.append(kw["device"])
        return {"ref": 1.0}

    monkeypatch.setattr(ops, "measure_impl_latency", fake)
    kw = dict(dt=1.0e-11, n_steps=2, reps=1)
    plan_cache.measure(8, 2, device="cpu", **kw)
    plan_cache.measure(8, 2, device="cuda", **kw)
    plan_cache.measure(8, 2, device="cuda:0", **kw)
    assert seen == ["cpu", "cuda"] and plan_cache.stats.measure_hits == 1


def test_measure_memo_hit_keeps_the_winner_registered(plan_cache):
    """A hit leaves the dispatch table as the unmemoized call would: the
    measured winner, registered again after the table was cleared or
    another impl was pinned, and nothing re-registered while it stands."""
    spec = make_spec(13, n_in=1, hold_steps=4, seed=900_047, device="cpu")
    kw = dict(dt=float(spec.dt), chunk_ticks=4, device="cpu")  # compile_plan's key
    timings = plan_cache.measure(13, 2, **kw)
    key = ops.dispatch_key(13, 2, "cpu")
    assert ops.latency_table()[key] == min(timings, key=timings.get) == "ref"
    ops.clear_latency_table()
    assert plan_cache.measure(13, 2, **kw) is timings
    assert ops.latency_table()[key] == "ref"
    gen = ops.dispatch_generation()
    plan_cache.measure(13, 2, **kw)
    assert ops.dispatch_generation() == gen
    # compile_plan(measure=True) resolves auto through the memo's winner
    ops.register_impl_choice(13, 2, "scan", platform="cpu")
    sim = compile_plan(spec, ExecPlan(ensemble=2, chunk_ticks=4, measure=True), device="cpu")
    assert sim.impl == "ref" and plan_cache.stats.measure_hits == 3
    assert plan_cache.stats.measure_misses == 1


# ---------------------------------------------------------------------------
# serving integration (the process-wide PLAN_CACHE, swapped for a fresh one)
# ---------------------------------------------------------------------------


def test_engine_template_route_shares_compiled_sim(plan_cache):
    spec = _spec(seed=900_040)
    kw = dict(num_slots=2, chunk_ticks=2, device="cpu")
    eng_a = ReservoirEngine(spec, **kw)
    hits0 = plan_cache.stats.hits
    eng_b = ReservoirEngine(spec, **kw)
    assert eng_b.sim is eng_a.sim
    assert plan_cache.stats.hits == hits0 + 1
    assert eng_a._spec_hash == spec_structural_hash(spec)


def test_engine_hashes_its_spec_once(plan_cache, monkeypatch):
    """The engine hashes its template once; its rescales' and prewarm's
    PLAN_CACHE lookups pass that digest (on the card each hash copies W
    off it)."""
    calls = []
    real = cache.spec_structural_hash

    def counted(spec):
        calls.append(spec.n)
        return real(spec)

    for mod in (cache, reservoir):
        monkeypatch.setattr(mod, "spec_structural_hash", counted)
    spec = _spec(seed=900_048)
    eng = ReservoirEngine(spec, num_slots=4, backend="scan", chunk_ticks=2, autoscale=True,
                          min_slots=2, max_slots=16, device="cpu")
    assert calls == [spec.n] and eng._spec_hash == real(spec)
    eng.prewarm(block=True)
    for width in (16, 8, 2, 4):
        eng._rescale(width)
        eng.prewarm_buckets(block=True)
    assert calls == [spec.n] and not eng.prewarm_errors
    st = eng.stats()
    assert (st.cold_rescales, st.warm_rescales) == (1, 3)  # 16 was not adjacent to 4


def test_prewarmed_rescale_compiles_nothing(plan_cache):
    spec = _spec(seed=900_041)
    eng = ReservoirEngine(
        plan_cache.get_or_compile(spec, ExecPlan(ensemble=4, chunk_ticks=2), device="cpu"),
        autoscale=True,
        min_slots=2,
        max_slots=8,
    )
    eng.prewarm(block=True)
    assert not eng.prewarm_errors
    compiles0 = plan_cache.stats.compiles
    eng._rescale(8)
    eng._rescale(2)
    assert plan_cache.stats.compiles == compiles0
    st = eng.stats()
    assert st.cold_rescales == 0 and st.warm_rescales == 2
    assert st.rescale_stall_s == 0.0

    # and the engine still serves correctly at the rescaled width
    rng = np.random.default_rng(3)
    results = eng.run(_sessions(rng, 5))
    assert len(results) == 5


def test_concurrent_rescale_during_prewarm(plan_cache):
    """A _rescale racing the background prewarm waits on the in-flight
    compile (one compile per key), never crashes, and leaves an engine that
    serves."""
    spec = _spec(seed=900_042)
    eng = ReservoirEngine(
        plan_cache.get_or_compile(spec, ExecPlan(ensemble=4, chunk_ticks=2), device="cpu"),
        autoscale=True,
        min_slots=2,
        max_slots=8,
        prewarm=False,
    )
    misses0 = plan_cache.stats.misses
    compiles0 = plan_cache.stats.compiles
    eng.prewarm_buckets(block=False)  # daemon thread compiles 2 and 8
    eng._rescale(8)  # races the thread on the ensemble=8 key
    if eng._prewarm_thread is not None:
        eng._prewarm_thread.join(timeout=60)
    d_miss = plan_cache.stats.misses - misses0
    d_comp = plan_cache.stats.compiles - compiles0
    assert d_comp == d_miss, (
        f"{d_comp} compiles for {d_miss} misses: the in-flight event duplicated a compile"
    )
    assert eng.num_slots == 8 and not eng.prewarm_errors
    rng = np.random.default_rng(4)
    results = eng.run(_sessions(rng, 6))
    assert len(results) == 6


def test_cold_rescale_pays_the_first_dispatch_in_its_stall(plan_cache, monkeypatch):
    """prewarm=False: a bucket's first rescale compiles and warms it at the
    boundary (cold, its stall counted), with aot (no masked chunk); the
    revisit is warm."""
    monkeypatch.setattr(reservoir.CompiledSim, "warmup",
                        lambda *a, **k: pytest.fail("a masked chunk at the boundary"))
    spec = _spec(seed=900_044)
    eng = ReservoirEngine(spec, num_slots=2, backend="scan", chunk_ticks=2, autoscale=True,
                          min_slots=2, max_slots=8, prewarm=False, device="cpu")
    assert eng._prewarm_thread is None
    eng._rescale(4)
    st = eng.stats()
    assert (st.cold_rescales, st.warm_rescales) == (1, 0) and st.rescale_stall_s > 0.0
    assert plan_cache.is_warm(spec, eng.sim.plan, device="cpu")
    assert plan_cache.stats.warmups == 1
    eng._rescale(2)
    eng._rescale(4)
    st = eng.stats()
    assert (st.cold_rescales, st.warm_rescales) == (1, 2)


def test_compile_plan_measure_memoized(plan_cache):
    spec = make_spec(13, n_in=1, hold_steps=4, seed=900_043, device="cpu")
    plan = ExecPlan(ensemble=2, chunk_ticks=2, measure=True)
    compile_plan(spec, plan, device="cpu")
    assert plan_cache.stats.measure_misses == 1
    compile_plan(spec, plan, device="cpu")
    assert plan_cache.stats.measure_hits == 1, "a repeat measure=True compile re-ran the timing"


def test_prewarm_failure_is_recorded_not_raised(plan_cache, monkeypatch):
    spec = _spec(seed=900_045)
    eng = ReservoirEngine(spec, num_slots=4, backend="scan", chunk_ticks=2, autoscale=True,
                          min_slots=2, max_slots=8, prewarm=False, device="cpu")

    def fail(*args, **kwargs):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(plan_cache, "ensure_warm", fail)
    assert eng.prewarm_buckets(block=True) == (2, 8)
    assert eng.prewarm_errors == [(2, "RuntimeError: out of memory"),
                                  (8, "RuntimeError: out of memory")]
    monkeypatch.undo()
    # the rescale compiles on demand
    eng._rescale(8)
    assert eng.stats().cold_rescales == 1 and eng.num_slots == 8


@pytest.mark.parametrize("backend", ["ref", "chunk"])
def test_serving_beside_the_prewarm_thread_is_bit_equal(plan_cache, backend):
    """An autoscaling engine whose prewarm thread warms buckets while it
    serves gives the bits of one without the thread (the same CompiledSim
    per width; on the CPU the thread's chunks share the BLAS pool)."""
    rng = np.random.default_rng(6)
    rows = [(sid, rng.uniform(0, 0.5, (int(rng.integers(4, 15)), 1)).astype(np.float32))
            for sid in range(24)]
    spec = _spec(n=24, seed=900_046)
    got = {}
    for prewarm in (True, False):
        eng = ReservoirEngine(spec, num_slots=2, backend=backend, chunk_ticks=2, autoscale=True,
                              min_slots=2, max_slots=16, prewarm=prewarm, device="cpu")
        got[prewarm] = eng.run([StreamSession(sid=s, u_seq=u.copy()) for s, u in rows])
        if eng._prewarm_thread is not None:
            eng._prewarm_thread.join(timeout=60)
            assert not eng._prewarm_thread.is_alive()
        assert not eng.prewarm_errors
        assert eng.stats().grows >= 1 and eng.stats().shrinks >= 1
    assert plan_cache.stats.warmups >= 2
    for sid, _ in rows:
        a, b = got[True][sid], got[False][sid]
        assert np.array_equal(a.states, b.states) and np.array_equal(a.final_m, b.final_m), sid


def test_bucket_ladder_helper():
    assert _bucket_ladder(2, 8) == [2, 4, 8]
    assert _bucket_ladder(2, 12) == [2, 4, 8, 12]  # non-power-of-two clamp
    assert _bucket_ladder(4, 4) == [4]
    for lo, hi in ((2, 8), (2, 12), (4, 4), (64, 256), (3, 20)):
        assert _bucket_ladder(lo, hi) == j_bucket_ladder(lo, hi)


# ---------------------------------------------------------------------------
# tune integration: one compile per structural combo, across calls
# ---------------------------------------------------------------------------


def test_tune_compiles_each_structural_combo_once(plan_cache):
    from repro_torch.tune import Choice, Float, SearchSpace, narma_task, tune_spec

    task = narma_task(32, order=10, seed=9, learn_washout=8)
    space = SearchSpace({
        "drive_current": Float(0.5e-3, 4.5e-3),
        "hold_steps": Choice((3, 5)),
    })
    plan = ExecPlan(impl="scan", ensemble=4, chunk_ticks=2, learn="rls")
    spec = make_spec(n=12, n_in=1, hold_steps=4, seed=900_060, dtype=torch.float32, device="cpu")

    def run_once():
        return tune_spec(
            spec, task, space, budget=8, plan=plan, strategy="cmaes", seed=2, device="cpu"
        )

    c0 = plan_cache.stats.compiles
    first = run_once()
    combos = {t.assignment["hold_steps"] for t in first.trials}
    assert plan_cache.stats.compiles - c0 == len(combos), (
        "a 2-generation CMA-ES run must compile each structural combo exactly once"
    )
    second = run_once()
    assert plan_cache.stats.compiles - c0 == len(combos), (
        "revisiting the same structural combos recompiled them"
    )
    assert [t.fitness for t in first.trials] == [
        t.fitness for t in second.trials
    ], "cached engines changed the search's numerics"


# ---------------------------------------------------------------------------
# aot and the persisted kernel builds
# ---------------------------------------------------------------------------


def test_aot_on_the_cpu_builds_and_launches_nothing(plan_cache, monkeypatch):
    monkeypatch.setattr(_build, "load", lambda: pytest.fail("aot built on the CPU"))
    before = dict(_build.LAUNCHES)
    spec = _spec(seed=900_050)
    for impl in ("scan", "ref", "fused", "tiled", "chunk"):
        sim = compile_plan(spec, ExecPlan(impl=impl, ensemble=4, chunk_ticks=2, aot=True),
                           device="cpu")
        assert sim.plan.aot and sim.aot_compile() is sim
        assert plan_cache.warm(sim, aot=True) >= 0.0 and plan_cache.warm(sim, aot=True) == 0.0
    assert _build.LAUNCHES == before
    assert plan_cache.stats.warmups == 5


@pytest.mark.parametrize(
    "impl,precision,config,w_dtype",
    [
        ("chunk", None, "coop", torch.float32),
        ("fused", "bf16_coupling", "coop", torch.bfloat16),
        ("tiled", None, "field", torch.float32),
        ("tiled", "mixed", "field", torch.bfloat16),
    ],
)
def test_aot_resolves_the_kernels_launch_configuration(monkeypatch, impl, precision, config,
                                                       w_dtype):
    """On the card aot_compile loads the library and resolves the padded
    shape's launch configuration (whose occupancy query sets the kernel's
    shared-memory attribute), and launches nothing. Here the library and its
    queries are stubbed, and the sim claims a card."""
    calls = []
    monkeypatch.setattr(_build, "load", lambda: calls.append("load"))
    for name in ("coop", "field"):
        monkeypatch.setattr(sto_step, f"{name}_launch_config",
                            lambda n, e, w, dev, name=name: calls.append((name, n, e, w)))
    sim = compile_plan(_spec(n=70, seed=900_051),
                       ExecPlan(impl=impl, ensemble=5, chunk_ticks=2, precision=precision),
                       device="cpu")
    before = dict(_build.LAUNCHES)
    sim.device = torch.device("cuda")
    assert sim.aot_compile() is sim
    assert calls == ["load", (config, 128, 64, w_dtype)]
    assert _build.LAUNCHES == before
    calls.clear()
    sim.plan = dataclasses.replace(sim.plan, interpret=True)
    sim.aot_compile()
    assert calls == []  # the plain versions build nothing


def test_persistent_cache_first_directory_wins(build_dir):
    a, b = str(build_dir / "a"), str(build_dir / "b")
    assert cache.persistent_cache_dir() is None
    assert enable_persistent_cache(a) and enable_persistent_cache(a)
    assert cache.persistent_cache_dir() == a and _build.BUILD_DIR == (build_dir / "a").resolve()
    assert (build_dir / "a").is_dir()
    with pytest.warns(RuntimeWarning, match="first directory wins"):
        assert not enable_persistent_cache(b)
    assert cache.persistent_cache_dir() == a and _build.BUILD_DIR == (build_dir / "a").resolve()


def test_persistent_cache_after_the_library_loaded_elsewhere(build_dir, monkeypatch):
    monkeypatch.setattr(_build, "_LIB", object())  # loaded from the default directory
    with pytest.warns(RuntimeWarning, match="already loaded"):
        assert not enable_persistent_cache(str(build_dir / "late"))
    assert cache.persistent_cache_dir() is None
    assert _build.BUILD_DIR == build_dir / "default"
    # naming the directory it was loaded from is fine
    assert enable_persistent_cache(str(build_dir / "default"))


def test_compile_plan_pins_the_plans_directory(build_dir, plan_cache):
    where = str(build_dir / "plan")
    spec = _spec(seed=900_052)
    sim = compile_plan(spec, ExecPlan(impl="scan", compilation_cache_dir=where), device="cpu")
    assert sim.plan.compilation_cache_dir == where and cache.persistent_cache_dir() == where
    # through the cache too; the key leaves the directory out
    hit = plan_cache.get_or_compile(spec, ExecPlan(impl="scan"), device="cpu")
    assert plan_cache.get_or_compile(
        spec, ExecPlan(impl="scan", compilation_cache_dir=where), device="cpu"
    ) is hit
