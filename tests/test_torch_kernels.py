"""The port's kernel layer against the JAX reference, on the CPU.

Each CUDA kernel's wrapper takes its plain PyTorch version for CPU tensors;
here those are held against the reference's Pallas kernels run in interpret
mode (as tests/test_kernels_sto.py runs them), and repro_torch.kernels.ref
against repro.kernels.ref. The CUDA kernels themselves are checked against
their plain versions by tests/test_torch_cuda.py (skipped without a card)
and by chip_smoke.py.

Tolerances, stated once:
  F32_ATOL = 5e-5   f32 state, the bound of tests/test_kernels_sto.py
  F64_ATOL = 1e-10  f64 state, port plain vs JAX ref over <= 40 RK4 steps
  BF16_ATOL = 5e-3  bf16-W state, the `run.py --smoke` guardrail scale
  frozen lanes      exact (torch.equal)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constants as jconst
from repro.core import coupling as jcoupling
from repro.core.ensemble import broadcast_params as jbroadcast
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sto_step as jstep
from repro_torch.core import constants
from repro_torch.core.ensemble import broadcast_params
from repro_torch.kernels import ops, sto_step
from repro_torch.kernels import ref as kref

torch.set_num_threads(2)

F32_ATOL = 5e-5
F64_ATOL = 1e-10
BF16_ATOL = 5e-3
DT = 1e-11


def _inputs(n, e, k=3, seed=0):
    """State (3, N, E), W, per-lane currents, input block (K, N, E), mask
    (K, E) with a lane frozen all chunk, one retired and one admitted mid-chunk."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(e, n, 3))
    m[..., 2] += 3.0
    m /= np.linalg.norm(m, axis=-1, keepdims=True)
    m = np.ascontiguousarray(np.transpose(m, (2, 1, 0)))
    w = jcoupling.make_coupling_matrix(n, seed=seed).astype(np.float64)
    current = rng.uniform(2e-3, 3e-3, e)
    h = rng.uniform(0.0, 0.5, (k, n, e))
    mask = np.ones((k, e), bool)
    mask[:, 0] = False
    if e > 2:
        mask[k // 2 :, 1] = False
        mask[: k // 2, 2] = False
    return m, w, current, h, mask


def _params(e, current, dt):
    pj = jbroadcast(jconst.default_params(dt), e, current=current)
    return jref.pack_params(pj, e, dt)


def _tparams(e, current, dtype):
    pt = broadcast_params(constants.default_params(dtype, device="cpu"), e, current=current)
    return kref.pack_params(pt, e, dtype)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_pack_params_parity(dt):
    e = 5
    current = np.linspace(2e-3, 3e-3, e)
    jd, td = (jnp.float32, torch.float32) if dt == "f32" else (jnp.float64, torch.float64)
    with jax.enable_x64(True):
        pj = np.asarray(_params(e, current, jd))
    pt = _tparams(e, current, td).numpy()
    np.testing.assert_allclose(pt, pj, rtol=1e-6 if dt == "f32" else 1e-15)
    assert kref.PARAM_LAYOUT == jref.PARAM_LAYOUT and kref.NP == jref.NP


def test_ref_field_and_steps_f64():
    """llg_field_planes / rk4_step_planes / rk4_multi_step_planes /
    rk4_chunk_planes against the reference's ref.py in f64 (20 steps)."""
    n, e, k, hold = 10, 4, 4, 5
    m, w, current, h, mask = _inputs(n, e, k)
    def reference(mj, wj, pj, hj, maskj):
        return (
            jref.llg_field_planes(mj, wj, pj, hj[0]),
            jref.rk4_step_planes(mj, wj, pj, DT, hj[0]),
            jref.rk4_multi_step_planes(mj, wj, pj, DT, 5, hj[0]),
            jref.rk4_chunk_planes(mj, wj, pj, DT, hold, hj, maskj),
        )

    with jax.enable_x64(True):
        pj = _params(e, current, jnp.float64)
        out = jax.jit(reference)(
            jnp.asarray(m), jnp.asarray(w), pj, jnp.asarray(h), jnp.asarray(mask)
        )
        kj, sj, msj = (np.asarray(x) for x in out[:3])
        cj = [np.asarray(x) for x in out[3]]
    pt = _tparams(e, current, torch.float64)
    mt, wt, ht = _t(m, torch.float64), _t(w, torch.float64), _t(h, torch.float64)
    kt = kref.llg_field_planes(mt, wt, pt, ht[0]).numpy()
    np.testing.assert_allclose(kt, kj, rtol=0, atol=1e-12 * np.abs(kj).max())
    np.testing.assert_allclose(kref.rk4_step_planes(mt, wt, pt, DT, ht[0]).numpy(), sj, atol=F64_ATOL)
    np.testing.assert_allclose(
        kref.rk4_multi_step_planes(mt, wt, pt, DT, 5, ht[0]).numpy(), msj, atol=F64_ATOL
    )
    ct = kref.rk4_chunk_planes(mt, wt, pt, DT, hold, ht, torch.as_tensor(mask))
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(a.numpy(), b, atol=F64_ATOL)
    assert torch.equal(ct[0][:, :, 0], mt[:, :, 0])  # frozen lane: exact


def test_rk4_chunk_wrapper_matches_pallas_interpret():
    n, e, k, hold = 32, 8, 4, 3
    m, w, current, h, mask = _inputs(n, e, k)
    pj = _params(e, current, jnp.float32)
    mj, sj = jstep.rk4_chunk(
        jnp.asarray(m, jnp.float32), jnp.asarray(w, jnp.float32), pj, DT, hold,
        jnp.asarray(h, jnp.float32), jnp.asarray(mask, jnp.float32), block_e=e, interpret=True,
    )
    mt_in = _t(m)
    mt, st = sto_step.rk4_chunk(
        mt_in, _t(w), _tparams(e, current, torch.float32), DT, hold, _t(h), _t(mask)
    )
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=F32_ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=F32_ATOL)
    # frozen lanes: bit-identical to their inputs; retired lane holds still
    assert torch.equal(mt[:, :, 0], mt_in[:, :, 0])
    assert all(torch.equal(st[t, :, 1], st[k // 2 - 1, :, 1]) for t in range(k // 2, k))
    assert all(torch.equal(st[t, :, 2], mt_in[0, :, 2]) for t in range(k // 2))


@pytest.mark.parametrize("n_inner", [1, 5])
def test_rk4_fused_wrapper_matches_pallas_interpret(n_inner):
    n, e = 24, 8
    m, w, current, h, _ = _inputs(n, e)
    pj = _params(e, current, jnp.float32)
    mj = jstep.rk4_fused(
        jnp.asarray(m, jnp.float32), jnp.asarray(w, jnp.float32), pj, DT, n_inner=n_inner,
        block_e=e, h_in=jnp.asarray(h[0], jnp.float32), interpret=True,
    )
    mt = sto_step.rk4_fused(
        _t(m), _t(w), _tparams(e, current, torch.float32), DT, n_inner=n_inner, h_in=_t(h[0])
    )
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=F32_ATOL)


def test_rk4_tiled_step_matches_pallas_interpret():
    """One RK4 step through field_tiled at c = 0, dt/2 (twice) and dt."""
    n, e = 32, 8
    m, w, current, h, _ = _inputs(n, e)
    pj = _params(e, current, jnp.float32)
    mj_, wj, hj = (jnp.asarray(x, jnp.float32) for x in (m, w, h[0]))
    pt, mt, wt, ht = _tparams(e, current, torch.float32), _t(m), _t(w), _t(h[0])
    step = jax.jit(
        lambda *a: jstep.rk4_tiled_step(*a[:3], DT, block_n=n, block_e=e, h_in=a[3], interpret=True)
    )
    sj = step(mj_, wj, pj, hj)
    st = sto_step.rk4_tiled_step(mt, wt, pt, DT, h_in=ht)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=F32_ATOL)


@pytest.mark.parametrize(
    "n,e,impl,interpret",
    [
        (1, 3, "fused", False),  # N=1: W is a 1x1 zero matrix
        (7, 5, "tiled", False),  # ragged N and E, both padded to 64
        (70, 17, "chunk", True),  # padded chunk path (plain version), N to 128
    ],
)
def test_padded_integrate_matches_reference(n, e, impl, interpret):
    m, w, current, _, _ = _inputs(n, e)
    m_user = np.ascontiguousarray(np.transpose(m, (2, 1, 0)))  # (E, N, 3)
    jref_out = jops.sto_rk4_integrate(
        jnp.asarray(m_user, jnp.float32), jnp.asarray(w, jnp.float32),
        _params(e, current, jnp.float32), DT, 6, impl="ref",
    )
    out = ops.sto_rk4_integrate(
        _t(m_user), _t(w), _tparams(e, current, torch.float32), DT, 6,
        impl=impl, n_inner=3, interpret=interpret,
    )
    assert out.shape == (e, n, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref_out), atol=F32_ATOL)


@pytest.mark.parametrize("impl", ["ref", "fused", "tiled", "chunk"])
def test_tick_chunk_planes_masks_and_matches_reference(impl):
    n, e, k, hold = 20, 6, 4, 2
    m, w, current, h, mask = _inputs(n, e, k)
    mj, sj = jops.sto_rk4_tick_chunk_planes(
        jnp.asarray(m, jnp.float32), jnp.asarray(w, jnp.float32),
        _params(e, current, jnp.float32), DT, hold, jnp.asarray(h, jnp.float32),
        jnp.asarray(mask), impl="ref",
    )
    mt_in = _t(m)
    mt, st = ops.sto_rk4_tick_chunk_planes(
        mt_in, _t(w), _tparams(e, current, torch.float32), DT, hold, _t(h),
        torch.as_tensor(mask), impl=impl,
    )
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=F32_ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=F32_ATOL)
    assert torch.equal(mt[:, :, 0], mt_in[:, :, 0])


def test_lane_mask_freezes_lanes_exactly():
    n, e = 9, 4
    m, w, current, h, _ = _inputs(n, e)
    mt = _t(m)
    lane = torch.tensor([True, False, True, False])
    out = ops.sto_rk4_integrate_planes(
        mt, _t(w), _tparams(e, current, torch.float32), DT, 4, h_in=_t(h[0]),
        lane_mask=lane, impl="fused", n_inner=2,
    )
    assert torch.equal(out[:, :, ~lane], mt[:, :, ~lane])
    assert not torch.equal(out[:, :, lane], mt[:, :, lane])


@pytest.mark.parametrize("precision", ["bf16_coupling", "mixed"])
def test_bf16_coupling_matches_reference(precision):
    n, e, k, hold = 16, 4, 3, 3
    m, w, current, h, mask = _inputs(n, e, k)
    args_j = (
        jnp.asarray(m, jnp.float32), jnp.asarray(w, jnp.float32),
        _params(e, current, jnp.float32), DT, hold, jnp.asarray(h, jnp.float32), jnp.asarray(mask),
    )
    mj, sj = jops.sto_rk4_tick_chunk_planes(*args_j, impl="ref", precision=precision)
    mt, st = ops.sto_rk4_tick_chunk_planes(
        _t(m), _t(w), _tparams(e, current, torch.float32), DT, hold, _t(h),
        torch.as_tensor(mask), impl="chunk", precision=precision, interpret=True,
    )
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=BF16_ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=BF16_ATOL)
    if precision == "bf16_coupling":
        # the bf16 rounding really happened: the port agrees with the bf16
        # reference more closely than with the f32 one
        m32, _ = jops.sto_rk4_tick_chunk_planes(*args_j, impl="ref")
        assert np.abs(mt.numpy() - np.asarray(mj)).max() < np.abs(mt.numpy() - np.asarray(m32)).max()


def test_coupling_dot_rounds_operand_and_accumulates_f32():
    rng = np.random.default_rng(3)
    w = torch.as_tensor(rng.normal(size=(8, 8)), dtype=torch.float32)
    x = torch.as_tensor(rng.normal(size=(8, 3)), dtype=torch.float32)
    got = kref.coupling_dot(w.to(torch.bfloat16), x, torch.float32)
    want = w.to(torch.bfloat16).double() @ x.to(torch.bfloat16).double()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


def test_choose_impl_platform_gate_and_table():
    assert ops.choose_impl(64, 16, platform="cpu") == "ref"
    for n in (1, 64, 1000, 2500, 4096, 10000):
        for e in (1, 64, 256, 1024):
            assert ops.choose_impl(n, e, platform="cuda") in ("fused", "tiled")
    assert ops.choose_impl(512, 128, platform="cuda") == "fused"
    assert ops.choose_impl(4096, 256, platform="cuda") == "tiled"
    assert ops.fused_fits_l2(2048, 128) and not ops.fused_fits_l2(4096, 128)
    gen = ops.dispatch_generation()
    ops.register_impl_choice(3000, 100, "chunk", platform="cuda")
    assert ops.dispatch_generation() == gen + 1
    assert ops.choose_impl(3000, 100, platform="cuda") == "chunk"
    # an unmeasured reduced-precision key falls back to the f32 winner
    assert ops.choose_impl(3000, 100, platform="cuda", precision="mixed") == "chunk"
    assert ops.normalize_precision(None) == ops.normalize_precision("highest") == "highest"


def test_measure_impl_latency_registers_cpu_winner():
    t = ops.measure_impl_latency(16, 4, n_steps=2, reps=1, chunk_ticks=2, device="cpu")
    assert set(t) == {"ref"} and t["ref"] > 0
    assert ops.latency_table()[("cpu", 64, 64, 4, "highest")] == "ref"


def test_layout_roundtrip_and_wrapper_checks():
    m = torch.randn(5, 9, 3)
    assert torch.equal(ops.from_planes(ops.to_planes(m), (5,)), m)
    with pytest.raises(ValueError):
        sto_step.rk4_chunk(
            torch.zeros(3, 4, 4, device="meta"), None, None, DT, 1, torch.zeros(1, 4, 4), None
        )
