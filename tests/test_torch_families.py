"""The physics families in the port (SimSpec.topology time_multiplexed and
array_transient) against the JAX reference, on the CPU.

Mirrors tests/conformance/test_matrix.py at its small shapes
(time_multiplexed: 5 virtual nodes, hold 3; array_transient: N = 6, window
2, hold 4; the coupled array N = 6, hold 4), the same numpy inputs through
both packages. Tolerances:

  - the spec builders: w_in (the +-1 mask from numpy's generator), w_cp and
    m0 byte-identical, and the reference's structural hash;
  - port vs reference, per family and impl (scan, ref, chunk): states and
    final m within ATOL = 5e-5 (f32; the two frameworks order the GEMMs'
    sums and fuse elementwise ops differently, ~1 ulp a step over 10 ticks
    of hold windows);
  - port ref == port chunk, bit for bit (one plain body per family);
  - the kernel impls' plain versions (fused / tiled, interpret=True) vs the
    port's ref: the reference's rtol 1e-5 / atol 1e-6;
  - readout_window = 1 == coupled_array bit for bit through the engine;
  - reduced precision vs "highest": relative L2 below 5e-2 (the reference's);
  - learning: the scan backend's learned W bit-equal to fit_rls over the
    same states (block = K), the others within rtol 1e-5 / atol 1e-6;
  - the delay line: the plain version against the reference's node loop
    within ATOL; the CUDA kernel's arithmetic, written out op for op in
    numpy float32, bit-equal to the plain version (what lets the kernel
    match it on the card); the wrapper's frozen lanes bit-identical;
  - every guard cell of the matrix (refusals raise).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecPlan as JPlan
from repro.api import compile_plan as jcompile
from repro.api import make_array_transient_spec as jmake_array_transient_spec
from repro.api import make_spec as jmake_spec
from repro.api import make_time_multiplexed_spec as jmake_time_multiplexed_spec
from repro.api import spec_structural_hash as jhash
from repro.kernels import ref as jref
from repro_torch.api import (
    ExecPlan,
    check_plan_supports_topology,
    compile_plan,
    make_array_transient_spec,
    make_spec,
    make_time_multiplexed_spec,
    spec_structural_hash,
)
from repro_torch.api.compiled import family_auto_impl
from repro_torch.core import fit_lms, fit_rls
from repro_torch.kernels import dispatch_table, ops, sto_step
from repro_torch.kernels import ref as kref
from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

torch.set_num_threads(2)

ATOL = 5e-5
FAMILIES = ("time_multiplexed", "array_transient")
TOPOLOGIES = ("coupled_array",) + FAMILIES

_BUILDERS = {
    "coupled_array": (
        lambda: jmake_spec(6, hold_steps=4, seed=0),
        lambda: make_spec(6, hold_steps=4, seed=0, device="cpu"),
    ),
    "time_multiplexed": (
        lambda: jmake_time_multiplexed_spec(5, hold_steps=3, seed=0),
        lambda: make_time_multiplexed_spec(5, hold_steps=3, seed=0, device="cpu"),
    ),
    "array_transient": (
        lambda: jmake_array_transient_spec(6, readout_window=2, hold_steps=4, seed=0),
        lambda: make_array_transient_spec(6, readout_window=2, hold_steps=4, seed=0, device="cpu"),
    ),
}
_SPECS = {}


def specs(topology):
    """(reference spec, port spec) of one family, built once."""
    if topology not in _SPECS:
        jb, tb = _BUILDERS[topology]
        _SPECS[topology] = (jb(), tb())
    return _SPECS[topology]


@pytest.fixture(scope="module")
def stream():
    return np.random.default_rng(7).uniform(0.0, 1.0, 10).astype(np.float32)


def drive(spec, impl, u, precision=None, interpret=False):
    """The port's solo drive: (final m, states) as numpy."""
    plan = ExecPlan(impl=impl, ensemble=1, chunk_ticks=4, precision=precision, interpret=interpret)
    m, states = compile_plan(spec, plan, device="cpu").drive(u)
    return m.numpy(), states.numpy()


def jdrive(spec, impl, u):
    m, states = jcompile(spec, JPlan(impl=impl, ensemble=1, chunk_ticks=4)).drive(jnp.asarray(u))
    return np.asarray(m), np.asarray(states)


def rel_l2(a, b):
    return float(np.linalg.norm(a.astype(np.float64) - b)) / float(np.linalg.norm(b.astype(np.float64)))


# -- specs ------------------------------------------------------------------------


@pytest.mark.parametrize("topology", FAMILIES)
def test_spec_builders_match_the_reference(topology):
    sj, st = specs(topology)
    for name in ("w_in", "w_cp", "m0"):
        a, b = np.asarray(getattr(sj, name)), getattr(st, name).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert (st.topology, st.readout_window, st.hold_steps) == (
        sj.topology, sj.readout_window, sj.hold_steps
    )
    assert spec_structural_hash(st) == jhash(sj)


def test_time_multiplexed_mask_follows_the_seed():
    a = make_time_multiplexed_spec(64, n_in=2, seed=3, device="cpu")
    b = jmake_time_multiplexed_spec(64, n_in=2, seed=3)
    assert np.array_equal(a.w_in.numpy(), np.asarray(b.w_in))
    assert set(np.unique(a.w_in.numpy())) == {-1.0, 1.0}
    assert torch.equal(a.w_cp, torch.eye(64))


# -- inference cells ---------------------------------------------------------------


@pytest.mark.parametrize("impl", ("scan", "ref", "chunk"))
@pytest.mark.parametrize("topology", FAMILIES)
def test_port_matches_reference(topology, impl, stream):
    sj, st = specs(topology)
    mj, sjs = jdrive(sj, impl, stream)
    mt, sts = drive(st, impl, stream)
    assert sts.shape == (len(stream), st.n) and mt.shape == (st.n, 3)
    np.testing.assert_allclose(sts, sjs, rtol=0, atol=ATOL)
    np.testing.assert_allclose(mt, mj, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(mt, axis=-1), 1.0, atol=1e-4)


@pytest.mark.parametrize("topology", FAMILIES)
def test_ref_equals_chunk_bit_for_bit(topology, stream):
    _, st = specs(topology)
    m1, s1 = drive(st, "ref", stream)
    m2, s2 = drive(st, "chunk", stream)
    assert np.array_equal(s1, s2) and np.array_equal(m1, m2)


@pytest.mark.parametrize("impl", ("fused", "tiled"))
@pytest.mark.parametrize("topology", ("coupled_array", "array_transient"))
def test_kernel_impls_track_ref(topology, impl, stream):
    """The CUDA kernels' plain versions (interpret=True) through the family
    split of the hold window; time_multiplexed is absent by design (its
    refusal is a guard cell)."""
    _, st = specs(topology)
    _, s1 = drive(st, "ref", stream)
    _, s2 = drive(st, impl, stream, interpret=True)
    np.testing.assert_allclose(s2, s1, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("topology", FAMILIES)
def test_drive_batch_per_lane_matches_reference(topology):
    """Three lanes with their own input series: the entry point every
    family routes through its chunk worker."""
    sj, st = specs(topology)
    u = np.random.default_rng(5).uniform(0.0, 1.0, (6, 3, 1)).astype(np.float32)
    mj, sjs = jcompile(sj, JPlan(impl="ref", ensemble=3)).drive_batch(jnp.asarray(u))
    mt, sts = compile_plan(st, ExecPlan(impl="ref", ensemble=3), device="cpu").drive_batch(u)
    assert sts.shape == (6, 3, st.n) and mt.shape == (3, st.n, 3)
    np.testing.assert_allclose(sts.numpy(), np.asarray(sjs), rtol=0, atol=ATOL)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=ATOL)


@pytest.mark.parametrize("impl", ("scan", "ref"))
@pytest.mark.parametrize("topology", FAMILIES)
def test_ticks_equal_one_chunk(topology, impl):
    """K one-tick calls and one K-tick chunk, lanes frozen and admitted
    mid-chunk: bit for bit (a tick is a one-tick chunk of the same body)."""
    _, st = specs(topology)
    rng = np.random.default_rng(11)
    e, k = 3, 4
    sim = compile_plan(st, ExecPlan(impl=impl, ensemble=e, chunk_ticks=k), device="cpu")
    u = torch.tensor(rng.uniform(0.0, 1.0, (k, e, 1)), dtype=torch.float32)
    mask = torch.ones((k, e), dtype=torch.bool)
    mask[:2, 1] = False
    mask[3, 2] = False
    m0 = kref_planes(st, e)
    m_chunk, s_chunk = sim.tick_chunk(m0, u, lane_mask=mask)
    m, rows = m0, []
    for t in range(k):
        m, row = sim.tick(m, u[t], lane_mask=mask[t])
        rows.append(row)
    assert torch.equal(m, m_chunk) and torch.equal(torch.stack(rows), s_chunk)
    # lane 1, frozen for ticks 0-1, integrates as if admitted at tick 2
    assert torch.equal(sim.tick_chunk(m0, u[:2], lane_mask=mask[:2])[0][:, :, 1], m0[:, :, 1])
    assert torch.equal(sim.tick_chunk(m0, u[2:], lane_mask=mask[2:])[0][:, :, 1], m_chunk[:, :, 1])


def kref_planes(spec, e):
    return spec.m0.T[:, :, None].expand(3, spec.n, e).contiguous()


class TestEndpoint:
    @pytest.mark.parametrize("impl", ("scan", "chunk"))
    def test_transient_window1_is_coupled_array(self, impl, stream):
        ca = make_spec(6, hold_steps=4, seed=0, device="cpu")
        at = make_array_transient_spec(6, readout_window=1, hold_steps=4, seed=0, device="cpu")
        results = {}
        for name, spec in (("ca", ca), ("at", at)):
            eng = ReservoirEngine(spec, num_slots=2, backend=impl, chunk_ticks=4, device="cpu")
            eng.submit(StreamSession(sid=1, u_seq=stream))
            results[name] = eng.run()[1]
        assert np.array_equal(results["at"].states, results["ca"].states)
        assert np.array_equal(results["at"].final_m, results["ca"].final_m)


@pytest.mark.parametrize("precision", ("bf16_coupling", "mixed"))
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_reduced_precision_tracks_highest(topology, precision, stream):
    _, st = specs(topology)
    _, s_hi = drive(st, "ref", stream)
    _, s_lo = drive(st, "ref", stream, precision=precision)
    assert np.isfinite(s_lo).all()
    assert rel_l2(s_lo, s_hi) < 5e-2


class TestLearn:
    """The learn tails are topology-blind: the streamed W reproduces the
    offline fit over the same harvested states."""

    def served(self, topology, impl, learn, t=12, k=4):
        _, st = specs(topology)
        rng = np.random.default_rng(11)
        u = rng.uniform(0.0, 1.0, t).astype(np.float32)
        y = rng.uniform(0.0, 1.0, t).astype(np.float32)
        eng = ReservoirEngine(
            st, num_slots=2, backend=impl, chunk_ticks=k, learn=learn, learn_reg=1e-6,
            learn_mu=0.4, device="cpu",
        )
        eng.submit(StreamSession(sid=1, u_seq=u, targets=y))
        res = eng.run()[1]
        states = torch.from_numpy(res.states)
        if learn == "rls":
            w_ref = fit_rls(states, torch.from_numpy(y), reg=1e-6, block=k).w_out
        else:
            w_ref = fit_lms(states, torch.from_numpy(y), mu=0.4).w_out
        return res.learned_readout.w_out.numpy(), w_ref.numpy()

    @pytest.mark.parametrize("topology", TOPOLOGIES)
    def test_rls_scan_bit_matches_offline(self, topology):
        w, w_ref = self.served(topology, "scan", "rls")
        assert np.array_equal(w, w_ref)

    @pytest.mark.parametrize("impl,learn", [("chunk", "rls"), ("scan", "lms"), ("ref", "lms")])
    @pytest.mark.parametrize("topology", FAMILIES)
    def test_learn_grid_tracks_offline(self, topology, impl, learn):
        w, w_ref = self.served(topology, impl, learn)
        np.testing.assert_allclose(w, w_ref, rtol=1e-5, atol=1e-6)


# -- the delay line ---------------------------------------------------------------


def _delay_line_inputs(n, e, seed=0):
    """Operands of one tick: snapshots on the unit sphere, node drives,
    per-lane params (px varied per lane)."""
    rng = np.random.default_rng(seed)
    spec = make_time_multiplexed_spec(n, hold_steps=3, device="cpu")
    pv = kref.pack_params(spec.params, e).clone()
    pv[kref.PARAM_LAYOUT.index("px")] = torch.tensor(rng.uniform(0.1, 0.9, e), dtype=torch.float32)
    m = torch.tensor(rng.normal(size=(3, n, e)), dtype=torch.float32)
    m = (m / m.norm(dim=0, keepdim=True)).contiguous()
    h = torch.tensor(rng.uniform(-1.0, 1.0, (n, e)), dtype=torch.float32)
    return spec, m, h, pv


def test_delay_line_plain_matches_reference_node_loop():
    """One tick of the reference's tm_chunk_planes (its feedback, then its
    node scan) against the port's tm_feedback + tm_delay_line_plain."""
    n, e, hold = 5, 3, 3
    spec, m, h_ext, pv = _delay_line_inputs(n, e)
    w = torch.tensor(np.random.default_rng(1).normal(0.0, 0.3, (n, n)), dtype=torch.float32)
    mask = np.ones((1, e), bool)
    mj, sj = jref.tm_chunk_planes(
        jnp.asarray(m.numpy()), jnp.asarray(w.numpy()), jnp.asarray(pv.numpy()), spec.dt, hold,
        jnp.asarray(h_ext.numpy()[None]), jnp.asarray(mask),
    )
    h_t = kref.tm_feedback(h_ext, w, m[0], pv)
    snaps = kref.tm_delay_line_plain(m[:, n - 1], h_t, pv, spec.dt, hold)
    np.testing.assert_allclose(snaps.numpy(), np.asarray(mj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(snaps[0].numpy(), np.asarray(sj)[0], rtol=0, atol=ATOL)
    mt, st = kref.tm_chunk_planes(m, w, pv, spec.dt, hold, h_ext[None], torch.ones((1, e), dtype=torch.bool))
    assert torch.equal(mt, snaps) and torch.equal(st[0], snaps[0])


def _f32_field(p, h, mx, my, mz):
    """tm_delay_line_kernel's llg_field (csrc/sto_delay_line.cu), op for op,
    in numpy float32 scalars (each op rounded once, no FMA)."""
    hz = p["happl"] + p["demag"] * mz
    mdotp = (p["px"] * mx + p["py"] * my) + p["pz"] * mz
    hs = p["hs_coef"] / (np.float32(1.0) + p["lam"] * mdotp)
    bx = h + hs * (p["py"] * mz - p["pz"] * my)
    by = hs * (p["pz"] * mx - p["px"] * mz)
    bz = hz + hs * (p["px"] * my - p["py"] * mx)
    cx, cy, cz = my * bz - mz * by, mz * bx - mx * bz, mx * by - my * bx
    dx, dy, dz = my * cz - mz * cy, mz * cx - mx * cz, mx * cy - my * cx
    return tuple(p["npref"] * c - p["alpref"] * d for c, d in ((cx, dx), (cy, dy), (cz, dz)))


def _f32_rk4(p, h, s, dt, half, sixth):
    """The kernel's rk4_step in numpy float32."""
    k1 = _f32_field(p, h, *s)
    k2 = _f32_field(p, h, *(a + half * b for a, b in zip(s, k1)))
    k3 = _f32_field(p, h, *(a + half * b for a, b in zip(s, k2)))
    k4 = _f32_field(p, h, *(a + dt * b for a, b in zip(s, k3)))
    two = np.float32(2.0)
    return tuple(
        a + sixth * (((b1 + two * b2) + two * b3) + b4)
        for a, b1, b2, b3, b4 in zip(s, k1, k2, k3, k4)
    )


def test_kernel_arithmetic_gives_the_plain_bits():
    """The delay-line kernel's arithmetic, each op rounded once as the
    __f*_rn intrinsics round it, with its host coefficients
    (sto_step.tm_coefficients): bit-equal to tm_delay_line_plain, which is
    what lets the kernel match its plain version on the card."""
    n, e, hold = 7, 4, 3
    spec, m, h, pv = _delay_line_inputs(n, e, seed=2)
    plain = kref.tm_delay_line_plain(m[:, n - 1], h, pv, spec.dt, hold).numpy()
    dt, half, sixth = (np.float32(c) for c in sto_step.tm_coefficients(spec.dt))
    P, H, M = pv.numpy(), h.numpy(), m.numpy()
    ix = {name: i for i, name in enumerate(kref.PARAM_LAYOUT)}
    out = np.zeros_like(plain)
    for lane in range(e):
        p = {k: P[ix[k], lane] for k in ("hs_coef", "lam", "happl", "demag", "px", "py", "pz")}
        p["npref"] = -P[ix["pref"], lane]
        p["alpref"] = P[ix["alpha"], lane] * P[ix["pref"], lane]
        s = tuple(M[:, n - 1, lane])
        for j in range(n):
            for _ in range(hold):
                s = _f32_rk4(p, H[j, lane], s, dt, half, sixth)
            out[:, j, lane] = s
    assert out.dtype == np.float32 and np.array_equal(out, plain)


def test_delay_line_wrapper_on_cpu_freezes_masked_lanes():
    n, e = 6, 4
    spec, m, h, pv = _delay_line_inputs(n, e, seed=3)
    mask = torch.tensor([1.0, 0.0, 1.0, 0.0])
    out = sto_step.tm_delay_line(m, h, pv, spec.dt, 2, mask)
    plain = kref.tm_delay_line_plain(m[:, n - 1], h, pv, spec.dt, 2)
    assert torch.equal(out[:, :, [1, 3]], m[:, :, [1, 3]])
    assert torch.equal(out[:, :, [0, 2]], plain[:, :, [0, 2]])
    assert torch.equal(sto_step.tm_delay_line(m, h, pv, spec.dt, 2), plain)


def test_tm_chunk_on_cpu_is_the_plain_body():
    n, e, k = 5, 3, 2
    spec, m, h, pv = _delay_line_inputs(n, e, seed=4)
    hb = torch.stack([h, 0.5 * h])
    mask = torch.tensor([[True, False, True], [True, True, False]])
    got = sto_step.tm_chunk(m, spec.w_cp, pv, spec.dt, 3, hb, mask)
    want = kref.tm_chunk_planes(m, spec.w_cp, pv, spec.dt, 3, hb, mask)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# -- guard cells ------------------------------------------------------------------


class TestGuards:
    @pytest.mark.parametrize("impl", ("fused", "tiled"))
    def test_time_multiplexed_refuses_coupled_kernels(self, impl):
        _, st = specs("time_multiplexed")
        with pytest.raises(ValueError, match="cannot execute topology"):
            compile_plan(st, ExecPlan(impl=impl, ensemble=1), device="cpu")

    def test_time_multiplexed_auto_resolves(self, stream):
        """On the CPU "auto" resolves to the plain body, as the reference's
        does; on the card to "chunk" (the delay-line kernel)."""
        _, st = specs("time_multiplexed")
        sim = compile_plan(st, ExecPlan(impl="auto", ensemble=1), device="cpu")
        assert sim.impl == "ref"
        _, states = sim.drive(stream)
        assert torch.isfinite(states).all()

    def test_auto_maps_a_table_chunk_to_a_family_kernel(self, monkeypatch):
        """The dispatch table ranks the coupled array's impls. A "chunk"
        winner registered for the card becomes "fused" for array_transient
        (its "chunk" is the eager plain body) and "chunk" (the delay-line
        kernel) for time_multiplexed; the coupled array keeps it, and off
        the card array_transient keeps it too."""
        monkeypatch.setattr(ops, "_LATENCY_TABLE", {})
        monkeypatch.setattr(dispatch_table, "_LOADED", {"cuda"})
        ops.register_impl_choice(2500, 256, "chunk", platform="cuda")
        choice = ops.choose_impl(2500, 256, 4, platform="cuda")
        assert choice == "chunk"
        assert family_auto_impl("array_transient", choice, "cuda") == "fused"
        assert family_auto_impl("time_multiplexed", choice, "cuda") == "chunk"
        assert family_auto_impl("coupled_array", choice, "cuda") == "chunk"
        assert family_auto_impl("array_transient", "tiled", "cuda") == "tiled"
        assert family_auto_impl("array_transient", "chunk", "cpu") == "chunk"
        assert family_auto_impl("time_multiplexed", "tiled", "cpu") == "ref"

    @pytest.mark.parametrize("topology", FAMILIES)
    def test_families_refuse_mesh(self, topology):
        """ExecPlan(mesh=...) waits for sharded plans in the port; the family
        check refuses a mesh plan as the reference's does."""
        with pytest.raises(NotImplementedError, match="item 12"):
            ExecPlan(ensemble=1, mesh=object())
        plan = types.SimpleNamespace(mesh=object(), impl="auto")
        with pytest.raises(ValueError, match="mesh"):
            check_plan_supports_topology(plan, topology)

    def test_scan_refuses_reduced_precision(self):
        with pytest.raises(ValueError):
            ExecPlan(impl="scan", ensemble=1, precision="mixed")

    def test_time_multiplexed_refuses_integrate(self):
        _, st = specs("time_multiplexed")
        sim = compile_plan(st, ExecPlan(impl="ref", ensemble=1), device="cpu")
        with pytest.raises(ValueError, match="time_multiplexed"):
            sim.integrate(n_steps=2)

    def test_transient_integrate_is_the_coupled_free_run(self):
        ca = make_spec(6, hold_steps=4, seed=0, device="cpu")
        at = make_array_transient_spec(6, readout_window=2, hold_steps=4, seed=0, device="cpu")
        got = compile_plan(at, ExecPlan(impl="ref", ensemble=2), device="cpu").integrate(6)[0]
        want = compile_plan(ca, ExecPlan(impl="ref", ensemble=2), device="cpu").integrate(6)[0]
        assert torch.equal(got, want)

    def test_coupled_refuses_readout_window(self):
        with pytest.raises(ValueError, match="readout_window"):
            make_spec(6, hold_steps=4, readout_window=2, device="cpu")

    @pytest.mark.parametrize("window", (0, 5, -1))
    def test_transient_window_bounds(self, window):
        with pytest.raises(ValueError, match="readout_window"):
            make_array_transient_spec(6, readout_window=window, hold_steps=4, device="cpu")

    def test_unknown_topology_refused(self):
        with pytest.raises(ValueError, match="topology"):
            make_spec(6, hold_steps=4, topology="ring", device="cpu")

    @pytest.mark.parametrize("topology", FAMILIES)
    def test_aot_warms_a_family_plan_by_one_chunk(self, topology):
        _, st = specs(topology)
        sim = compile_plan(st, ExecPlan(impl="chunk", ensemble=2, chunk_ticks=2, aot=True),
                           device="cpu")
        with pytest.raises(NotImplementedError, match="family plans"):
            sim.aot_compile()
