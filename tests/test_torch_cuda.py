"""The port's CUDA kernels (coupled-STO RK4 and flash attention) against
their plain PyTorch versions, on a card.

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


# ---------------------------------------------------------------------------
# flash attention (kernels/csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

# kernel vs plain version: bf16 3e-2 (the reference's own bf16 flash test;
# bf16 probabilities in the P.V product), f32 5e-6 (its f32 tests); and per
# row, max|err| / max|plain| (as chip_smoke.py holds it; bf16 admits one
# ulp of the row's largest element, 2^-7 of it)
FLASH_ATOL = {torch.bfloat16: 3e-2, torch.float32: 5e-6}
FLASH_RTOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}


def _row_rel_err(out, ref):
    o, r = out.float(), ref.float()
    return ((o - r).abs().amax(-1) / r.abs().amax(-1).clamp_min(1e-30)).max().item()


def _qkv(dev, b, h, kvh, sq, sk, d, dtype, seed=0):
    """q (B, Sq, H, D), k/v (B, Sk, KVH, D), the model's layout."""
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g).to(dtype).to(dev)  # noqa: E731
    return mk(b, sq, h, d), mk(b, sk, kvh, d), mk(b, sk, kvh, d)


def _plain_bshd(q, k, v, causal, window):
    from repro_torch.kernels.flash_attention import flash_attention_plain

    t = lambda x: x.transpose(1, 2)  # noqa: E731
    return t(flash_attention_plain(t(q), t(k), t(v), causal, window))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "shape,causal,window",
    [
        ((1, 32, 8, 200, 200, 80), True, 64),  # h2o-danube heads, ragged S, window bites
        ((2, 8, 2, 129, 129, 64), True, 0),  # ragged causal
        ((1, 4, 4, 96, 300, 128), True, 0),  # Sq < Sk, MHA
        ((1, 12, 4, 70, 70, 32), False, 0),  # G = 3, bidirectional
        ((1, 8, 1, 64, 64, 96), True, 16),  # MQA, narrow window
    ],
)
def test_flash_matches_plain(cuda, dtype, shape, causal, window):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(cuda, *shape, dtype)
    fa.LAUNCHES["flash_attention"] = 0
    out = fa.flash_attention_bshd(q, k, v, causal=causal, window=window)
    ref = _plain_bshd(q, k, v, causal, window)
    assert fa.LAUNCHES["flash_attention"] == 1
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= FLASH_ATOL[dtype]
    assert _row_rel_err(out, ref) <= FLASH_RTOL[dtype]


@pytest.mark.cuda
def test_flash_user_layout_and_masked_rows(cuda):
    """The (B, H, S, D) entry reads the same kernel through other strides;
    with Sq > Sk and causal, the first rows see no key and come back 0."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(cuda, 1, 4, 2, 48, 40, 64, torch.float32)
    t = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    out = fa.flash_attention(t(q), t(k), t(v), causal=True)
    ref = fa.flash_attention_plain(t(q), t(k), t(v), causal=True)
    assert (out - ref).abs().max().item() <= FLASH_ATOL[torch.float32]
    assert torch.equal(out[:, :, :8], torch.zeros_like(out[:, :, :8]))


@pytest.mark.cuda
def test_grouped_attend_on_cuda_launches_flash(cuda):
    """Prefill-style calls (q_offset 0, no kv_len) go to the kernel; decode
    calls (per-row offsets) take the einsum path and launch nothing."""
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.models import attention

    q, k, v = _qkv(cuda, 2, 8, 2, 40, 40, 80, torch.bfloat16)
    LAUNCHES["flash_attention"] = 0
    out = attention.grouped_attend(q, k, v, causal=True, window=16, q_offset=0)
    assert LAUNCHES["flash_attention"] == 1
    ref = attention._grouped_attend_dense(q, k, v, causal=True, window=16, q_offset=0)
    assert (out.float() - ref.float()).abs().max().item() <= FLASH_ATOL[torch.bfloat16]
    pos = torch.tensor([39, 20], device=cuda)
    attention.grouped_attend(q[:, -1:], k, v, causal=True, q_offset=pos, kv_len=pos + 1)
    assert LAUNCHES["flash_attention"] == 1
