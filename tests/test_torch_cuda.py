"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test is marked `cuda` and skips without one. The file imports only
torch and repro_torch, so it runs where the reference (and jax) is not
installed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Tolerances: f32 state STATE_ATOL = 5e-5 over one short chunk (FP32 sums in
another order than cuBLAS); slopes (~1e10 Oe/s) SLOPE_RTOL = 1e-5 relative
to their largest magnitude; frozen lanes exact.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import constants, coupling
from repro_torch.core.ensemble import broadcast_params
from repro_torch.kernels import ops, sto_step
from repro_torch.kernels import ref as kref

STATE_ATOL = 5e-5
SLOPE_RTOL = 1e-5
DT = 1e-11


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, n=128, e=64, k=3, seed=0):
    """Operands at kernel tiles; lane 0 frozen all chunk, lane 1 retired and
    lane 2 admitted mid-chunk."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(3, n, e))
    m[2] += 3.0
    m /= np.linalg.norm(m, axis=0, keepdims=True)
    w = coupling.make_coupling_matrix(n, seed=seed)
    params = broadcast_params(
        constants.default_params(torch.float64, device="cpu"), e,
        current=rng.uniform(2e-3, 3e-3, e),
    )
    pv = kref.pack_params(params, e, torch.float32)
    h = rng.uniform(0.0, 0.5, (k, n, e))
    mask = np.ones((k, e))
    mask[:, 0] = 0
    mask[k // 2 :, 1] = 0
    mask[: k // 2, 2] = 0
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
    return [t.to(dev).contiguous() for t in (as_t(m), as_t(w), pv, as_t(h), as_t(mask))]


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_rk4_chunk_matches_plain(cuda, w_dtype):
    m, w, pv, h, mask = _inputs(cuda)
    w = w.to(w_dtype)
    sto_step.reset_launches()
    mk, sk = sto_step.rk4_chunk(m, w, pv, DT, 3, h, mask)
    mp, sp = kref.rk4_chunk_planes(m, w, pv, DT, 3, h, mask > 0.5)
    assert sto_step.LAUNCHES["rk4_chunk"] == 1
    assert (mk - mp).abs().max().item() <= STATE_ATOL
    assert (sk - sp).abs().max().item() <= STATE_ATOL
    assert torch.equal(mk[:, :, 0], m[:, :, 0])
    assert torch.equal(sk[2, :, 1], sk[0, :, 1])
    assert torch.equal(sk[0, :, 2], m[0, :, 2])


@pytest.mark.cuda
def test_rk4_fused_matches_plain(cuda):
    m, w, pv, h, _ = _inputs(cuda)
    out = sto_step.rk4_fused(m, w, pv, DT, n_inner=5, h_in=h[0].contiguous())
    ref = kref.rk4_multi_step_planes(m, w, pv, DT, 5, h[0])
    assert (out - ref).abs().max().item() <= STATE_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("c", [0.0, 0.5 * DT, DT])
def test_field_tiled_matches_plain(cuda, c):
    m, w, pv, h, _ = _inputs(cuda)
    kprev = kref.llg_field_planes(m, w, pv, h[0])
    yx = (m[0] + c * kprev[0]).contiguous()
    out = sto_step.field_tiled(m, yx, kprev, w, pv, c, h_in=h[0].contiguous())
    ref = sto_step.field_tiled_plain(m, yx, kprev, w, pv, c, h[0])
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= SLOPE_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["chunk", "fused", "tiled"])
def test_ragged_tick_chunk_matches_plain(cuda, impl):
    """N=70, E=5: ops pads to the kernel tiles and slices back."""
    n, e, k = 70, 5, 2
    m, w, pv, h, mask = _inputs(cuda, n=n, e=e, k=k)
    args = (m, w, pv, DT, 2, h, mask > 0.5)
    mk, sk = ops.sto_rk4_tick_chunk_planes(*args, impl=impl)
    mp, sp = ops.sto_rk4_tick_chunk_planes(*args, impl=impl, interpret=True)
    assert mk.shape == (3, n, e) and sk.shape == (k, n, e)
    assert (mk - mp).abs().max().item() <= STATE_ATOL
    assert torch.equal(mk[:, :, 0], m[:, :, 0])


@pytest.mark.cuda
def test_f64_state_on_cuda_is_refused(cuda):
    m, w, pv, h, mask = _inputs(cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sto_step.rk4_chunk(m.double(), w, pv, DT, 1, h, mask)
