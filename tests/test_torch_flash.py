"""The port's flash-attention plain version against the reference.

`flash_attention_plain` (and the wrappers, which take it for CPU tensors)
is held against the reference's Pallas kernel run in interpret mode
(`repro.kernels.flash_attention.flash_attention(..., interpret=True)`) and
its oracle `mha_reference`, over the reference test's shapes (D = 80, GQA,
MQA, Sq < Sk) and gemma-7b's D = 256, causal and not, and sliding windows; and, at ragged lengths
the Pallas kernel does not take, against the reference model's einsum path
`_grouped_attend_dense`. Inputs are numpy draws handed to both packages.

Tolerances: f32 atol 5e-6 (the reference's own f32 flash tests: the same
sums in another order); bf16 atol 3e-2 (its bf16 test). The CUDA kernel
itself is held against this plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import mha_reference
from repro.models.attention import _grouped_attend_dense as jax_dense
from repro_torch.kernels import flash_attention as fa

F32_ATOL = 5e-6
BF16_ATOL = 3e-2

SHAPES = [
    # b, h, kvh, sq, sk, d  (tests/test_kernels_attention.py)
    (2, 4, 2, 256, 256, 64),
    (1, 8, 8, 128, 128, 32),  # MHA
    (1, 4, 1, 128, 128, 128),  # MQA
    (2, 4, 4, 128, 384, 64),  # q shorter than k
    (1, 16, 4, 256, 256, 80),  # non-pow2 head dim (h2o-danube style)
    (1, 2, 2, 128, 128, 256),  # gemma-7b's head dim
]
# non-causal only where Sq == Sk (offset alignment is a causal notion)
CASES = [(s, c) for s in SHAPES for c in (True, False) if c or s[3] == s[4]]


def _qkv(b, h, kvh, sq, sk, d, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(dtype)
    k = rng.standard_normal((b, kvh, sk, d)).astype(dtype)
    v = rng.standard_normal((b, kvh, sk, d)).astype(dtype)
    return q, k, v


def _repeat_ref(q, k, v, causal, window):
    g = q.shape[1] // k.shape[1]
    kr, vr = (jnp.repeat(jnp.asarray(x), g, axis=1) for x in (k, v))
    return np.asarray(mha_reference(jnp.asarray(q), kr, vr, causal=causal, window=window))


def _plain(q, k, v, causal, window):
    t = torch.from_numpy
    return fa.flash_attention_plain(t(q), t(k), t(v), causal=causal, window=window).numpy()


@pytest.mark.parametrize("shape,causal", CASES, ids=lambda x: str(x))
def test_plain_matches_pallas_interpret_and_oracle(shape, causal):
    q, k, v = _qkv(*shape)
    out = _plain(q, k, v, causal, 0)
    pallas = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal, interpret=True))
    np.testing.assert_allclose(out, pallas, atol=F32_ATOL)
    np.testing.assert_allclose(out, _repeat_ref(q, k, v, causal, 0), atol=F32_ATOL)


@pytest.mark.parametrize("window", [64, 128, 256])
def test_plain_sliding_window(window):
    q, k, v = _qkv(1, 4, 2, 256, 256, 64, seed=1)
    out = _plain(q, k, v, True, window)
    pallas = jax_flash(*map(jnp.asarray, (q, k, v)), causal=True, window=window, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=F32_ATOL)
    np.testing.assert_allclose(out, _repeat_ref(q, k, v, True, window), atol=F32_ATOL)


def test_plain_bf16_inputs():
    q, k, v = _qkv(1, 4, 2, 128, 128, 64, seed=2)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = fa.flash_attention(qb, kb, vb, causal=True)
    assert out.dtype == torch.bfloat16
    # the reference's kernel on the same bf16 values, and the f32 oracle
    jb = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (qb, kb, vb)]
    pallas = np.asarray(jax_flash(*jb, causal=True, interpret=True), np.float32)
    np.testing.assert_allclose(out.float().numpy(), pallas, atol=BF16_ATOL)
    ref = _repeat_ref(*(x.float().numpy() for x in (qb, kb, vb)), True, 0)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=BF16_ATOL)


@pytest.mark.parametrize("window", [0, 16, 64])
@pytest.mark.parametrize("g", [1, 4])
def test_bshd_ragged_matches_model_einsum_path(window, g):
    """Sq = Sk = 200 (no tile multiple) in the model's (B, S, H, D) layout
    against the reference's _grouped_attend_dense at q_offset 0."""
    rng = np.random.default_rng(3)
    b, s, kvh, d = 2, 200, 2, 80
    q = rng.standard_normal((b, s, kvh * g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    t = torch.from_numpy
    out = fa.flash_attention_bshd(t(q), t(k), t(v), causal=True, window=window)
    ref = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                    window=window, q_offset=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_ATOL)


def test_fully_masked_rows_are_zero():
    """Sq > Sk, causal: the first Sq - Sk rows see no key; the plain version
    gives zeros there, as the Pallas kernel does."""
    q, k, v = _qkv(1, 4, 2, 48, 40, 32, seed=4)
    out = _plain(q, k, v, True, 0)
    assert np.array_equal(out[:, :, :8], np.zeros_like(out[:, :, :8]))
    assert np.isfinite(out).all()
    pallas = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal=True, block_q=8,
                                  block_k=8, interpret=True))
    np.testing.assert_allclose(out, pallas, atol=F32_ATOL)


def test_layouts_agree():
    q, k, v = _qkv(2, 8, 2, 33, 33, 64, seed=5)
    t = lambda x: torch.from_numpy(x).transpose(1, 2)  # noqa: E731
    bshd = fa.flash_attention_bshd(t(q), t(k), t(v), causal=True, window=8)
    bhsd = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True, window=8)
    torch.testing.assert_close(bshd.transpose(1, 2), bhsd, rtol=0, atol=0)


@pytest.mark.parametrize(
    "q_shape,k_shape",
    [((1, 8, 4, 64), (1, 8, 3, 64)), ((1, 8, 4, 64), (2, 8, 2, 64)), ((8, 4, 64), (1, 8, 2, 64))],
)
def test_wrapper_rejects_bad_shapes(q_shape, k_shape):
    q, k = torch.zeros(q_shape), torch.zeros(k_shape)
    with pytest.raises(ValueError):
        fa.flash_attention_bshd(q, k, k)


def test_wrapper_rejects_negative_window():
    q = torch.zeros((1, 8, 4, 64))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_bshd(q, q, q, window=-1)
