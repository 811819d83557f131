"""The port's CUDA kernels (coupled-STO RK4, the time-multiplexed delay line
and flash attention) against their plain PyTorch versions on a card, and the
online learners, the scan oracle and the physics families' engines there,
and a sharded plan on a world-size-1 NCCL mesh, and training: the routing
of a step's attention around the flash kernel, one train step against the
CPU's, and a crash and resume; and MLA: the flash kernel at D = 192 with a
zero-padded v, a reduced deepseek-v2-lite at the full MLA dims served as on
the CPU through the kernel, and its gradients against the CPU's; and the
recurrent mixers: reduced jamba (its attention through the kernel at a GQA
group of 8) and xlstm-125m served as on the CPU, each Mamba / mLSTM / sLSTM
block and the gradients against the CPU's; and whisper's bidirectional and
cross-attention shapes of the kernel, their routing, reduced whisper and
llava (inputs_embeds) served as on the CPU and their gradients.

Every test is marked `cuda` and skips without one. The file imports only
torch and repro_torch, so it runs where the reference (and jax) is not
installed:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Tolerances: state STATE_ATOL = 5e-5 over one short chunk (and over a short
engine run), for an f32 and a bf16 W (FP32 sums in another order than cuBLAS); the coupling's share of the
state or of field_tiled's slopes, f(W) - f(0), COUPLING_RTOL = 2e-3 relative
to its largest magnitude; slopes (~1e10 Oe/s) SLOPE_RTOL = 1e-5 relative to
their largest magnitude; frozen lanes exact. The delay-line kernel rounds
every op as its plain version does: bit-equal to it, on the card and on the
CPU.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.core import constants, coupling
from repro_torch.core.ensemble import broadcast_params
from repro_torch.kernels import ops, sto_step
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rls as krls

STATE_ATOL = 5e-5
SLOPE_RTOL = 1e-5
DT = 1e-11


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _coupling(n, seed):
    return coupling.make_coupling_matrix(n, seed=seed)


def _inputs(dev, n=128, e=64, k=3, seed=0):
    """Operands at kernel tiles; lane 0 frozen all chunk, lane 1 retired and
    lane 2 admitted mid-chunk."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(3, n, e))
    m[2] += 3.0
    m /= np.linalg.norm(m, axis=0, keepdims=True)
    w = _coupling(n, seed)
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


# The cooperative kernel's work split (sto_step.coop_split) changes with N.
# On an H100 SXM, f32 / bf16 W: one block (N = 64); clusters of 5 with one
# 64-row unit each (320); 8 in three rounds of tiles / 5 (2560); 2 / 3
# (4096). N = 320 ends in a ragged 128-row bf16 tile; E = 320 adds a second,
# 64-lane tile.
SPLIT_N = (64, 320, 2560, 4096)
SPLIT_E = (64, 320)
W_DTYPES = (torch.float32, torch.bfloat16)
# The coupling moves these states by ~1.3e-3 over a chunk, and f32 rounding
# moves that share by ~2e-4 of itself (a float64 run of the plain version
# on the CPU), while a contraction slice dropped or summed twice moves it
# by 0.4 of itself or more. field_tiled's slopes and one rk4_tiled_step's
# state carry shares of ~2.3e7 Oe/s and ~2.3e-4, which f32 rounding moves by
# ~1.4e-4 and ~3.1e-4 of themselves (the same float64 proxy, either W);
# a slice dropped moves them by ~1/C.
COUPLING_RTOL = 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("w_dtype", W_DTYPES)
@pytest.mark.parametrize("e", SPLIT_E)
@pytest.mark.parametrize("n", SPLIT_N)
def test_rk4_chunk_split_matches_plain(cuda, n, e, w_dtype, k):
    m, w, pv, h, mask = _inputs(cuda, n=n, e=e, k=k)
    w = w.to(w_dtype)
    mk, sk = sto_step.rk4_chunk(m, w, pv, DT, 2, h, mask)
    mp, sp = kref.rk4_chunk_planes(m, w, pv, DT, 2, h, mask > 0.5)
    assert (mk - mp).abs().max().item() <= STATE_ATOL
    assert (sk - sp).abs().max().item() <= STATE_ATOL
    assert torch.equal(mk[:, :, 0], m[:, :, 0])  # frozen all chunk
    if k == 1:
        assert torch.equal(mk[:, :, 1], m[:, :, 1])  # retired from tick 0
    else:
        assert torch.equal(sk[2, :, 1], sk[0, :, 1])  # retired after tick 0
        assert torch.equal(sk[0, :, 2], m[0, :, 2])  # admitted at tick 1
        assert not torch.equal(sk[2, :, 2], m[0, :, 2])


@pytest.mark.cuda
@pytest.mark.parametrize("n_inner", [1, 3])
@pytest.mark.parametrize("w_dtype", W_DTYPES)
@pytest.mark.parametrize("e", SPLIT_E)
@pytest.mark.parametrize("n", SPLIT_N)
def test_rk4_fused_split_matches_plain(cuda, n, e, w_dtype, n_inner):
    m, w, pv, h, _ = _inputs(cuda, n=n, e=e, k=1)
    w = w.to(w_dtype)
    out = sto_step.rk4_fused(m, w, pv, DT, n_inner=n_inner, h_in=h[0])
    ref = kref.rk4_multi_step_planes(m, w, pv, DT, n_inner, h[0])
    assert (out - ref).abs().max().item() <= STATE_ATOL


def _flat(*ts):
    return torch.cat([t.flatten() for t in ts])


def _field_operands(m, w, pv, h0):
    """A previous slope and the stage x-plane at c = dt/2, as field_tiled's
    callers give them."""
    kprev = kref.llg_field_planes(m, w, pv, h0)
    return kprev, (m[0] + 0.5 * DT * kprev[0]).contiguous()


COOP_KERNELS = ("rk4_chunk", "rk4_fused")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [*COOP_KERNELS, "field_tiled", "rk4_tiled_step"])
@pytest.mark.parametrize("w_dtype", W_DTYPES)
@pytest.mark.parametrize("n", SPLIT_N)
def test_coupling_term_matches_plain(cuda, n, w_dtype, kernel):
    """f(W) - f(0), kernel against plain version: the coupling product's
    share of the state (or of the slopes) alone, so a fault of the split (a
    slice dropped or summed twice, a partial on the wrong rows or lanes)
    cannot hide under the LLG's own motion. The plain version with the last
    rank's slice dropped fails the same measure."""
    m, w, pv, h, mask = _inputs(cuda, n=n, e=320, k=3)
    w = w.to(w_dtype)
    h0 = h[0]
    if kernel == "rk4_chunk":
        kern = lambda w_: _flat(*sto_step.rk4_chunk(m, w_, pv, DT, 2, h, mask))  # noqa: E731
        plain = lambda w_: _flat(*kref.rk4_chunk_planes(m, w_, pv, DT, 2, h, mask > 0.5))  # noqa: E731
    elif kernel == "rk4_fused":
        kern = lambda w_: sto_step.rk4_fused(m, w_, pv, DT, n_inner=3, h_in=h0)  # noqa: E731
        plain = lambda w_: kref.rk4_multi_step_planes(m, w_, pv, DT, 3, h0)  # noqa: E731
    elif kernel == "field_tiled":
        kprev, yx = _field_operands(m, w, pv, h0)
        kern = lambda w_: sto_step.field_tiled(m, yx, kprev, w_, pv, 0.5 * DT, h_in=h0)  # noqa: E731
        plain = lambda w_: sto_step.field_tiled_plain(m, yx, kprev, w_, pv, 0.5 * DT, h0)  # noqa: E731
    else:
        kern = lambda w_: sto_step.rk4_tiled_step(m, w_, pv, DT, h_in=h0)  # noqa: E731
        plain = lambda w_: sto_step.rk4_tiled_step_plain(m, w_, pv, DT, h0)  # noqa: E731
    zero = torch.zeros_like(w)
    d_plain = plain(w) - plain(zero)
    scale = d_plain.abs().max()
    rel = lambda d: ((d - d_plain).abs().max() / scale).item()  # noqa: E731
    assert rel(kern(w) - kern(zero)) <= COUPLING_RTOL
    config = sto_step.coop_launch_config if kernel in COOP_KERNELS else sto_step.field_launch_config
    split = config(n, 320, w_dtype, cuda)
    k0, k1 = next(sto_step.coop_block_work(split, n, 320, split.cluster - 1)).k
    dropped = w.clone()
    dropped[:, k0:k1] = 0
    assert rel(plain(dropped) - plain(zero)) > 100 * COUPLING_RTOL


def _lanes(t, e):
    return t[..., :e].contiguous()


PATHS = ("cooperative", "tiled")


@pytest.mark.cuda
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("w_dtype", W_DTYPES)
@pytest.mark.parametrize("n", [320, 2560])
def test_lanes_independent_of_launch_width(cuda, n, w_dtype, path):
    """Lanes 0-63 of an E = 256 launch equal the same lanes run alone in an
    E = 64 launch, bit for bit: the contraction split follows N, not E."""
    m, w, pv, h, mask = _inputs(cuda, n=n, e=256, k=3)
    w = w.to(w_dtype)
    n64 = lambda t: _lanes(t, 64)  # noqa: E731
    if path == "cooperative":
        wide = sto_step.rk4_chunk(m, w, pv, DT, 2, h, mask)
        narrow = sto_step.rk4_chunk(n64(m), w, n64(pv), DT, 2, n64(h), n64(mask))
        assert torch.equal(n64(wide[0]), narrow[0])
        assert torch.equal(n64(wide[1]), narrow[1])
        fw = sto_step.rk4_fused(m, w, pv, DT, n_inner=2, h_in=h[0])
        fn = sto_step.rk4_fused(n64(m), w, n64(pv), DT, n_inner=2, h_in=n64(h[0]))
        assert torch.equal(n64(fw), fn)
    else:
        kprev, yx = _field_operands(m, w, pv, h[0])
        fw = sto_step.field_tiled(m, yx, kprev, w, pv, 0.5 * DT, h_in=h[0])
        fn = sto_step.field_tiled(
            n64(m), n64(yx), n64(kprev), w, n64(pv), 0.5 * DT, h_in=n64(h[0])
        )
        assert torch.equal(n64(fw), fn)
        sw = sto_step.rk4_tiled_step(m, w, pv, DT, h_in=h[0])
        sn = sto_step.rk4_tiled_step(n64(m), w, n64(pv), DT, h_in=n64(h[0]))
        assert torch.equal(n64(sw), sn)


@pytest.mark.cuda
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("w_dtype", W_DTYPES)
def test_reruns_are_bit_identical(cuda, w_dtype, path):
    m, w, pv, h, mask = _inputs(cuda, n=2560, e=320, k=3)
    w = w.to(w_dtype)
    if path == "cooperative":
        first = sto_step.rk4_chunk(m, w, pv, DT, 2, h, mask)
        second = sto_step.rk4_chunk(m, w, pv, DT, 2, h, mask)
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
        assert torch.equal(
            sto_step.rk4_fused(m, w, pv, DT, n_inner=3, h_in=h[0]),
            sto_step.rk4_fused(m, w, pv, DT, n_inner=3, h_in=h[0]),
        )
    else:
        kprev, yx = _field_operands(m, w, pv, h[0])
        assert torch.equal(
            sto_step.field_tiled(m, yx, kprev, w, pv, 0.5 * DT, h_in=h[0]),
            sto_step.field_tiled(m, yx, kprev, w, pv, 0.5 * DT, h_in=h[0]),
        )
        assert torch.equal(
            sto_step.rk4_tiled_step(m, w, pv, DT, h_in=h[0]),
            sto_step.rk4_tiled_step(m, w, pv, DT, h_in=h[0]),
        )


@pytest.mark.cuda
@pytest.mark.parametrize("c", [0.0, 0.5 * DT, DT])
@pytest.mark.parametrize("w_dtype", W_DTYPES)
@pytest.mark.parametrize("e", SPLIT_E)
@pytest.mark.parametrize("n", SPLIT_N)
def test_field_tiled_matches_plain(cuda, n, e, w_dtype, c):
    m, w, pv, h, _ = _inputs(cuda, n=n, e=e, k=1)
    w = w.to(w_dtype)
    kprev = kref.llg_field_planes(m, w, pv, h[0])
    yx = (m[0] + c * kprev[0]).contiguous()
    sto_step.reset_launches()
    out = sto_step.field_tiled(m, yx, kprev, w, pv, c, h_in=h[0])
    ref = sto_step.field_tiled_plain(m, yx, kprev, w, pv, c, h[0])
    assert sto_step.LAUNCHES["field_tiled"] == 1
    assert sto_step.LAUNCHES["round_bf16"] == (w_dtype == torch.bfloat16)
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= SLOPE_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", W_DTYPES)
@pytest.mark.parametrize("e", SPLIT_E)
@pytest.mark.parametrize("n", SPLIT_N)
def test_rk4_tiled_step_matches_plain(cuda, n, e, w_dtype):
    """Four launches with the stage algebra in the epilogue against the
    plain stages."""
    m, w, pv, h, _ = _inputs(cuda, n=n, e=e, k=1)
    w = w.to(w_dtype)
    sto_step.reset_launches()
    out = sto_step.rk4_tiled_step(m, w, pv, DT, h_in=h[0])
    ref = sto_step.rk4_tiled_step_plain(m, w, pv, DT, h[0])
    assert sto_step.LAUNCHES["field_tiled"] == 4
    assert sto_step.LAUNCHES["round_bf16"] == (w_dtype == torch.bfloat16)
    assert (out - ref).abs().max().item() <= STATE_ATOL


@pytest.mark.cuda
def test_round_bf16_matches_torch(cuda):
    """The bf16 operand kernel rounds to nearest even, as torch's cast."""
    x = torch.randn((320, 320), device=cuda) * 3.0
    x[0, :4] = torch.tensor([1.00390625, 1.01171875, -1.00390625, 0.0])  # ties to even
    sto_step.reset_launches()
    assert torch.equal(sto_step._round_bf16(x), x.to(torch.bfloat16))
    assert sto_step.LAUNCHES["round_bf16"] == 1


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
        ((1, 16, 16, 300, 300, 256), True, 0),  # gemma-7b heads (D = 256), ragged
        ((1, 12, 4, 333, 333, 80), True, 100),  # G = 3: 42 positions a tile, 2 rows past P x G
        ((1, 6, 2, 77, 700, 80), True, 5),  # G = 3, Sq < Sk, window narrower than a tile
        ((2, 8, 1, 150, 150, 128), True, 0),  # MQA (G = 8), batch 2
        ((1, 4, 4, 1, 129, 80), True, 0),  # one query row
        ((1, 258, 2, 40, 40, 32), True, 0),  # G = 129: two chunks of 65 heads, one past the group
        ((1, 8, 8, 7, 1500, 64), False, 0),  # whisper's cross prefill: 7 tokens, 1500 frames
        ((4, 8, 8, 1, 1500, 64), False, 0),  # whisper's cross decode, 4 rows
        ((2, 8, 8, 300, 100, 64), False, 0),  # bidirectional, Sq > Sk
        ((1, 8, 8, 1500, 1500, 64), False, 0),  # whisper's encoder
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


# Sk of many KV tiles with the last one ragged, every residue of the tile
# count modulo the ring depth (3 at D = 80, 2 at D = 128 and 256), so the
# mbarrier parities wrap at every point of the ring
RING_CASES = [(80, 16), (80, 17), (80, 18), (128, 16), (128, 17), (192, 16), (192, 17),
              (256, 16), (256, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,tiles", RING_CASES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_ring_parities(cuda, d, tiles, causal):
    """Bidirectional, every q tile reads all `tiles` KV tiles; causal with
    Sq = Sk, the tiles read 1 ... `tiles` KV tiles."""
    from repro_torch.kernels import flash_attention as fa

    sk = tiles * fa.kv_tile(d) - 3
    sq = 96 if not causal else sk
    q, k, v = _qkv(cuda, 1, 8, 2, sq, sk, d, torch.bfloat16, seed=tiles)
    plan = fa.tile_plan(4, sq, d)
    counts = {w.kv1 - w.kv0 for w in fa.tile_work(plan, 1, 2, sq, sk, causal, 0)}
    assert max(counts) == tiles and (causal or counts == {tiles})
    out = fa.flash_attention_bshd(q, k, v, causal=causal)
    ref = _plain_bshd(q, k, v, causal, 0)
    assert (out.float() - ref.float()).abs().max().item() <= FLASH_ATOL[torch.bfloat16]
    assert _row_rel_err(out, ref) <= FLASH_RTOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("d,window", [(80, 300), (256, 0)])
def test_flash_reruns_are_bit_identical(cuda, d, window):
    """Two launches on the same inputs agree bit for bit (no race between
    the ring's stages, the two consumers or the output staging), many KV
    tiles per block."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(cuda, 1, 8, 2, 1100, 1100, d, torch.bfloat16, seed=7)
    first = fa.flash_attention_bshd(q, k, v, causal=True, window=window)
    for _ in range(3):
        assert torch.equal(fa.flash_attention_bshd(q, k, v, causal=True, window=window), first)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 256])
def test_flash_bf16_user_layout_and_masked_rows(cuda, d):
    """The bf16 kernel through the (B, H, S, D) entry (its tensor maps over
    other strides); with Sq > Sk and causal, the first rows see no key and
    come back 0."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(cuda, 1, 6, 2, 200, 150, d, torch.bfloat16)
    t = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    out = fa.flash_attention(t(q), t(k), t(v), causal=True)
    ref = fa.flash_attention_plain(t(q), t(k), t(v), causal=True)
    assert (out.float() - ref.float()).abs().max().item() <= FLASH_ATOL[torch.bfloat16]
    assert torch.equal(out[:, :, :50], torch.zeros_like(out[:, :, :50]))


@pytest.mark.cuda
def test_flash_bf16_config_matches_mirror(cuda):
    """The library's tile (rows, keys per KV tile, ring, shared memory) is
    the one the Python tile plan mirrors."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    for d in fa.HEAD_DIMS:
        out = (ctypes.c_int * 4)()
        assert _build.load().flash_bf16_config(d, out) == 0
        assert list(out) == [fa.ROWS, fa.kv_tile(d), fa.ring_depth(d), fa.smem_bytes(d)], d


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,sk", [(129, 129), (1000, 1000), (129, 1000)])
def test_flash_at_mla_head_dim_matches_plain(cuda, dtype, sq, sk):
    """flash_bf16<192> and flash_f32<192> at MLA's prefill call shape (H =
    KVH, D = dn + dr = 192, v zero-padded from dv = 128) against the plain
    version, at ragged lengths; the pad columns come back exactly 0."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(cuda, 1, 4, 4, sq, sk, 192, dtype, seed=sq + sk)
    v[..., 128:] = 0
    sto_step.reset_launches()
    out = fa.flash_attention_bshd(q, k, v, causal=True)
    assert sto_step.LAUNCHES["flash_attention"] == 1
    ref = _plain_bshd(q, k, v, True, 0)
    assert (out.float() - ref.float()).abs().max().item() <= FLASH_ATOL[dtype]
    assert _row_rel_err(out[..., :128], ref[..., :128]) <= FLASH_RTOL[dtype]
    assert torch.equal(out[..., 128:], torch.zeros_like(out[..., 128:]))


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


# -- online learning and the scan oracle on the card --------------------------


def _learn_block(dev, e, s, k, seed=0):
    """(P, W, features, targets, mask) for E lanes that all repeat lane 0's
    numbers: P = I / 1e-2 plus a small symmetric part, W, x and y drawn once;
    tick 3 masked."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((1, s, s), generator=g)
    p = torch.eye(s)[None] * 100.0 + 1e-3 * (a + a.transpose(1, 2))
    w = 0.1 * torch.randn((1, s, 1), generator=g)
    x = 0.3 * torch.randn((k, 1, s), generator=g)
    y = torch.randn((k, 1, 1), generator=g)
    mask = torch.ones((k, 1), dtype=torch.bool)
    mask[min(3, k - 1)] = False
    wide = lambda t, dim: t.repeat_interleave(e, dim=dim).to(dev).contiguous()  # noqa: E731
    return wide(p, 0), wide(w, 0), wide(x, 1), wide(y, 1), wide(mask, 1)


# Lane 0 of rls_chunk / lms_chunk at E = 256 against E = 1 on the card, at
# the smoke's S = 2501, relative to the largest magnitude. Not bit-equal: on
# an H100 80GB HBM3 (700 W) tools/rls_tail_probe.py read, at K = 8, P
# 7.6e-8, W 1.7e-7 (rls_chunk) and W 4.3e-8 (lms_chunk) apart; of the
# pieces, cuBLAS's bmm (B = P X) 2.8e-6 and a trailing-axis sum 3.5e-7,
# while baddbmm (the P' update) and the axis-1 sum were bit-equal. So the
# engine's lanes are held bit-equal to a replay at the engine's width, and
# to the E = 1 oracle within LANE_RTOL (60x the largest reading).
LANE_RTOL = 1e-5
# a served learner's W against fit_rls at E = 1 over its own harvested
# states, relative to max |W| (chip_smoke.py's ORACLE_RTOL["rls"]: an H100
# read 1.45e-4 over 512 sessions at N = 2500)
ORACLE_RTOL = 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8])
def test_rls_chunk_lane0_at_e256_against_e1(cuda, k):
    one = _learn_block(cuda, 1, 2501, k)
    wide = _learn_block(cuda, 256, 2501, k)
    rel = lambda a, b: ((a - b).abs().max() / a.abs().max()).item()  # noqa: E731
    a, b = krls.rls_chunk(*one, 1.0), krls.rls_chunk(*wide, 1.0)
    c, d = krls.lms_chunk(*one[1:], 0.5), krls.lms_chunk(*wide[1:], 0.5)
    diffs = [rel(a[0][0], b[0][0]), rel(a[1][0], b[1][0]), rel(c[0][0], d[0][0])]
    print(f"rls_chunk P, W and lms_chunk W, lane 0 at E=256 vs E=1, K={k}: {diffs}")
    assert max(diffs) <= LANE_RTOL


def _learn_sessions(n, count=7, seed=0):
    rng = np.random.default_rng(seed)
    sessions = []
    for sid in range(count):
        t = int(rng.integers(5, 14))
        sessions.append(dict(
            sid=sid, u_seq=rng.uniform(0, 0.5, (t, 1)).astype(np.float32),
            targets=rng.normal(size=(t, 1)).astype(np.float32), learn_washout=2,
        ))
    return sessions


@pytest.mark.cuda
@pytest.mark.parametrize("backend,learn", [("scan", "rls"), ("chunk", "rls"), ("tiled", "lms")])
def test_served_lane_equals_its_engine_width_replay(cuda, backend, learn):
    """Each session's learned W == its harvested states replayed through
    rls_chunk / lms_chunk at the engine's width (its own lane, blocks from
    its admission, the other lanes masked), bit for bit."""
    from repro_torch.api import make_spec
    from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

    n, e, k = 64, 4, 4
    spec = make_spec(n, n_in=1, seed=0, hold_steps=3, device=cuda)
    eng = ReservoirEngine(
        spec, num_slots=e, backend=backend, chunk_ticks=k, learn=learn,
        learn_reg=1e-2, learn_mu=0.7, device=cuda,
    )
    rows = _learn_sessions(n)
    results = eng.run([StreamSession(**r) for r in rows])
    for r in rows:
        res, t = results[r["sid"]], len(r["u_seq"])
        blocks = -(-t // k) * k
        xb = torch.zeros((blocks, e, n + 1))
        xb[:t, res.slot, :n] = torch.from_numpy(res.states)
        xb[:t, res.slot, n] = 1.0
        y = torch.zeros((blocks, e, 1))
        y[:t, res.slot] = torch.from_numpy(r["targets"])
        lmask = torch.zeros((blocks, e), dtype=torch.bool)
        lmask[2:t, res.slot] = True
        xb, y, lmask = xb.to(cuda), y.to(cuda), lmask.to(cuda)
        if learn == "rls":
            p, w = krls.rls_init(e, n + 1, 1, 1e-2, torch.float32, device=cuda)
        else:
            w = krls.lms_init(e, n + 1, 1, torch.float32, device=cuda)
        for c in range(0, blocks, k):
            if learn == "rls":
                p, w, _ = krls.rls_chunk(p, w, xb[c : c + k], y[c : c + k], lmask[c : c + k], 1.0)
            else:
                w, _ = krls.lms_chunk(w, xb[c : c + k], y[c : c + k], lmask[c : c + k], 0.7)
        assert torch.equal(res.learned_readout.w_out, w[res.slot].cpu()), r["sid"]
        assert np.isfinite(res.learn_nmse)


@pytest.mark.cuda
@pytest.mark.parametrize("tableau", ["euler", "heun", "rk4", "bs32"])
def test_scan_on_the_card_matches_the_cpu(cuda, tableau):
    """impl="scan" runs eagerly on the card (full-f32 products) and agrees
    with the same plan on the CPU within STATE_ATOL."""
    from repro_torch.api import ExecPlan, compile_plan, make_spec

    spec = make_spec(96, n_in=2, seed=1, hold_steps=3, tableau=tableau, device="cpu")
    rng = np.random.default_rng(2)
    u = rng.uniform(0, 0.5, (4, 3, 2)).astype(np.float32)
    mask = np.ones((4, 3), bool)
    mask[2:, 1] = False
    m0 = ops.to_planes(spec.m0.expand(3, 96, 3)).contiguous()
    outs = []
    for dev in ("cpu", cuda):
        sim = compile_plan(spec, ExecPlan(impl="scan", ensemble=3, chunk_ticks=4), device=dev)
        outs.append([t.cpu() for t in (*sim.drive_batch(u), *sim.tick_chunk(m0.to(dev), u, lane_mask=mask))])
        assert sim.impl == "scan"
    for a, b in zip(*outs):
        assert (a - b).abs().max().item() <= STATE_ATOL
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.cuda
def test_learning_resume_on_the_card(cuda):
    """learn_w0 / learn_P0 (RLS) and learn_w0 (NLMS) start a lane mid-stream
    on the card: serving the second half of a stream from the first half's
    learner (replayed at E = 1) lands where the whole stream lands, within
    f32 roundoff; fit_rls / fit_lms run on card tensors."""
    from repro_torch.api import make_spec
    from repro_torch.core import fit_lms, fit_rls
    from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

    spec = make_spec(32, n_in=1, seed=0, hold_steps=3, device=cuda)
    rng = np.random.default_rng(9)
    u = rng.uniform(0, 0.5, (12, 1)).astype(np.float32)
    y = rng.normal(size=(12, 1)).astype(np.float32)
    for learn in ("rls", "lms"):
        eng = ReservoirEngine(
            spec, num_slots=2, backend="chunk", chunk_ticks=4, learn=learn,
            learn_reg=1e-2, learn_mu=0.5, device=cuda,
        )
        whole = eng.run([StreamSession(sid=0, u_seq=u, targets=y)])[0]
        half = eng.run([StreamSession(sid=1, u_seq=u[:8], targets=y[:8])])[1]
        states = torch.from_numpy(half.states).to(cuda)
        if learn == "rls":
            xb = torch.cat([states, torch.ones((8, 1), device=cuda)], 1)
            p, w = krls.rls_init(1, 33, 1, 1e-2, torch.float32, device=cuda)
            for s0 in (0, 4):
                p, w, _ = krls.rls_chunk(
                    p, w, xb[s0 : s0 + 4, None], torch.from_numpy(y[s0 : s0 + 4, None]).to(cuda),
                    torch.ones((4, 1), dtype=torch.bool, device=cuda), 1.0,
                )
            oracle = fit_rls(states, y[:8], reg=1e-2, block=4).w_out.cpu()
            resume = dict(learn_w0=w[0].cpu().numpy(), learn_P0=p[0].cpu().numpy())
        else:
            oracle = fit_lms(states, y[:8], mu=0.5).w_out.cpu()
            resume = dict(learn_w0=oracle.numpy())
        assert (half.learned_readout.w_out - oracle).abs().max().item() <= 1e-5 * oracle.abs().max().item()
        rest = eng.run([StreamSession(sid=2, u_seq=u[8:], targets=y[8:], m0=half.final_m, **resume)])[2]
        np.testing.assert_allclose(
            rest.learned_readout.w_out.numpy(), whole.learned_readout.w_out.numpy(), atol=1e-4
        )


# -- the engine's lifecycle on the card ------------------------------------------------


@functools.lru_cache(maxsize=None)
def _spec_cpu(n):
    from repro_torch.api import make_spec

    return make_spec(n, n_in=1, seed=0, hold_steps=3, device="cpu")


def _infer_rows(n, count=6, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (sid, rng.uniform(0, 0.5, (int(rng.integers(3, 9)), 1)).astype(np.float32),
         rng.normal(0, 1.0 / np.sqrt(n), (n + 1, 1)).astype(np.float32))
        for sid in range(count)
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 2560])
@pytest.mark.parametrize("backend,kernel", [("chunk", "rk4_chunk"), ("fused", "rk4_fused"),
                                            ("tiled", "field_tiled")])
def test_step_matches_run_chunk_ticks_one(cuda, n, backend, kernel):
    """A step() loop against run(chunk_ticks=1) on the card: within
    STATE_ATOL (bit-equal where one kernel at one width serves both, which
    the test prints), and step() launches the backend's kernel."""
    from repro_torch.core.reservoir import Readout
    from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

    spec = _spec_cpu(n).to(cuda)
    rows = _infer_rows(n)
    make = lambda: [  # noqa: E731
        StreamSession(sid=sid, u_seq=u.copy(), readout=Readout(torch.from_numpy(w), 0)) for sid, u, w in rows
    ]
    ran = ReservoirEngine(spec, num_slots=4, backend=backend, chunk_ticks=1, device=cuda).run(make())
    eng = ReservoirEngine(spec, num_slots=4, backend=backend, device=cuda)
    for s in make():
        eng.submit(s)
    sto_step.reset_launches()
    while eng.scheduler.has_work():
        eng.step()
    assert sto_step.LAUNCHES[kernel] > 0, dict(sto_step.LAUNCHES)
    worst, exact = 0.0, True
    for sid, _, w in rows:
        a, b = eng.results[sid], ran[sid]
        for x, y in ((a.states, b.states), (a.final_m, b.final_m)):
            worst = max(worst, float(np.abs(x - y).max()))
            exact = exact and np.array_equal(x, y)
        out_tol = STATE_ATOL * np.abs(w).sum()
        assert np.abs(a.outputs - b.outputs).max() <= out_tol
    print(f"step() vs run(chunk_ticks=1), {backend}, N={n}: max diff {worst:.3e}, "
          f"{'bit-equal' if exact else 'within STATE_ATOL'}")
    assert worst <= STATE_ATOL


@pytest.mark.cuda
def test_rls_checkpoint_restore_on_the_card(cuda):
    """An RLS learner checkpointed after two chunks and restored, in another
    lane, into an engine of the same width finishes like the uninterrupted
    run: bit-equal where the kernel and the learn tail compute a lane alike
    at any position (printed), else within STATE_ATOL on states and
    LANE_RTOL of max |W|."""
    from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

    spec = _spec_cpu(64).to(cuda)
    rows = _learn_sessions(64, count=3, seed=4)
    rows[2]["u_seq"] = np.tile(rows[2]["u_seq"], (3, 1))
    rows[2]["targets"] = np.tile(rows[2]["targets"], (3, 1))
    kw = dict(num_slots=4, backend="chunk", chunk_ticks=4, learn="rls", learn_reg=1e-2, device=cuda)
    control = ReservoirEngine(spec, **kw).run([StreamSession(**r) for r in rows])
    src = ReservoirEngine(spec, **kw)
    for r in rows:
        src.submit(StreamSession(**r))
    src.step_chunk()
    src.step_chunk()
    ck = src.checkpoint_session(2)
    assert ck.t == 8 and ck.P.shape == (65, 65)
    dst = ReservoirEngine(spec, **kw)
    dst.restore_session(ck)
    got = dst.run()[2]
    want = control[2]
    assert got.slot != want.slot
    w_a, w_b = got.learned_readout.w_out, want.learned_readout.w_out
    exact = np.array_equal(got.states, want.states) and torch.equal(w_a, w_b)
    rel = ((w_a - w_b).abs().max() / w_b.abs().max()).item()
    print(f"RLS checkpoint/restore on the card: states {np.abs(got.states - want.states).max():.3e}, "
          f"W {rel:.3e} of max|W|, {'bit-equal' if exact else 'within tolerance'}")
    assert np.abs(got.states - want.states).max() <= STATE_ATOL and rel <= LANE_RTOL
    assert sorted(src.run()) == [0, 1]


@pytest.mark.cuda
def test_grow_and_shrink_with_learn_columns_on_the_card(cuda):
    """At N = 320, an RLS engine grows under a burst and shrinks in the lull:
    every moved column bit-equal across a grow and a shrink, every session's
    states within STATE_ATOL of a fixed-width run, and its learned W within
    ORACLE_RTOL of fit_rls over its own harvested states at E = 1."""
    from repro_torch.core import fit_rls
    from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

    n = 320
    spec = _spec_cpu(n).to(cuda)
    rows = _learn_sessions(n, count=10, seed=5)
    kw = dict(backend="chunk", chunk_ticks=4, learn="rls", learn_reg=1e-2, device=cuda)
    fixed = ReservoirEngine(spec, num_slots=16, **kw).run([StreamSession(**r) for r in rows])

    probe = ReservoirEngine(spec, num_slots=4, autoscale=True, min_slots=2, max_slots=16, **kw)
    for r in rows[:3]:
        probe.submit(StreamSession(**r))
    probe.step_chunk()
    probe.quiesce()
    cols = lambda: {s.sid: [probe.store.m[:, :, k].clone(), probe.store.P[k].clone(),  # noqa: E731
                            probe.store.Wl[k].clone()] for k, s in probe.scheduler.running.items()}
    before = cols()
    for width in (16, 2 if len(before) <= 2 else 4):
        probe._rescale(width)
        after = cols()
        assert all(all(torch.equal(a, b) for a, b in zip(before[s], after[s])) for s in before)

    eng = ReservoirEngine(spec, num_slots=2, autoscale=True, min_slots=2, max_slots=16, **kw)
    results = eng.run([StreamSession(**r) for r in rows])
    stats = eng.stats()
    assert stats.grows >= 1 and stats.shrinks >= 1
    for r in rows:
        res = results[r["sid"]]
        assert np.abs(res.states - fixed[r["sid"]].states).max() <= STATE_ATOL
        oracle = fit_rls(torch.from_numpy(res.states).to(cuda), r["targets"], washout=2, reg=1e-2,
                         block=4).w_out.cpu()
        w = res.learned_readout.w_out
        assert ((w - oracle).abs().max() / oracle.abs().max()).item() <= ORACLE_RTOL
    print(f"autoscale N={n}: grows {stats.grows}, shrinks {stats.shrinks}, cold rescales "
          f"{stats.cold_rescales}, stall {stats.rescale_stall_s:.4f} s")


# -- the plan cache on the card -------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("impl,precision", [("chunk", None), ("fused", None), ("tiled", None),
                                            ("tiled", "bf16_coupling")])
def test_aot_launches_nothing_and_loads_the_library(cuda, impl, precision):
    """compile_plan(aot=True) builds or loads the kernel library and resolves
    the launch configuration without a launch; the first warmup then runs."""
    from repro_torch.api import ExecPlan, compile_plan
    from repro_torch.kernels import _build

    spec = _spec_cpu(320).to(cuda)
    sto_step.reset_launches()
    sim = compile_plan(spec, ExecPlan(impl=impl, ensemble=64, chunk_ticks=2, precision=precision,
                                      aot=True), device=cuda)
    assert _build._LIB is not None
    assert not any(sto_step.LAUNCHES.values()), dict(sto_step.LAUNCHES)
    sim.warmup()
    assert sum(sto_step.LAUNCHES.values()) > 0


@pytest.mark.cuda
def test_plan_cache_hit_and_rebind_on_the_card(cuda):
    """A hit on the card is the same CompiledSim; a rebind with another a_cp
    (spec given on the CPU: it moves to the sim's card) is bit-equal to a
    fresh compile of that spec; the card spec hashes as its CPU twin."""
    from repro_torch.api import ExecPlan, PlanCache, compile_plan, spec_structural_hash

    pc = PlanCache()
    spec_cpu = _spec_cpu(320)
    spec = spec_cpu.to(cuda)
    assert spec_structural_hash(spec) == spec_structural_hash(spec_cpu)
    plan = ExecPlan(impl="chunk", ensemble=64, chunk_ticks=2)
    a = pc.get_or_compile(spec, plan, device=cuda)
    assert pc.get_or_compile(spec, plan, device="cuda") is a
    assert not pc.contains(spec_cpu, plan, device="cpu")
    other = spec_cpu._replace(params=spec_cpu.params._replace(a_cp=torch.tensor(1.7)))
    rebound = pc.get_or_compile(other, plan, device=cuda)
    assert pc.stats.rebinds == 1 and pc.stats.compiles == 1
    assert rebound.device.type == "cuda" and rebound.spec.params.a_cp.device.type == "cuda"
    u = np.random.default_rng(0).uniform(0, 0.5, (6, 64, 1)).astype(np.float32)
    _, got = rebound.drive_batch(u)
    _, want = compile_plan(other, plan, device=cuda).drive_batch(u)
    _, base = a.drive_batch(u)
    assert torch.equal(got, want) and not torch.equal(got, base)


@pytest.mark.cuda
def test_prewarmed_rescale_compiles_nothing_on_the_card(cuda):
    """The reference's prewarmed-rescale case on the card: after prewarm,
    two rescales compile nothing and stall for nothing."""
    from repro_torch.api import PLAN_CACHE, ExecPlan
    from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

    spec = _spec_cpu(128).to(cuda)
    eng = ReservoirEngine(PLAN_CACHE.get_or_compile(spec, ExecPlan(ensemble=64, chunk_ticks=2),
                                                    device=cuda),
                          autoscale=True, min_slots=32, max_slots=128)
    eng.prewarm(block=True)
    assert not eng.prewarm_errors
    compiles0 = PLAN_CACHE.stats.compiles
    eng._rescale(128)
    eng._rescale(32)
    assert PLAN_CACHE.stats.compiles == compiles0
    st = eng.stats()
    assert st.cold_rescales == 0 and st.warm_rescales == 2 and st.rescale_stall_s == 0.0
    rows = _infer_rows(128, count=5)
    results = eng.run([StreamSession(sid=sid, u_seq=u.copy()) for sid, u, _ in rows])
    assert len(results) == 5 and all(np.isfinite(r.final_m).all() for r in results.values())


@pytest.mark.cuda
@pytest.mark.parametrize("learn", [None, "rls"])
def test_cold_rescale_launches_nothing_on_the_card(cuda, learn):
    """prewarm=False: a cold rescale compiles its bucket and warms it with
    aot at the boundary (the launch configuration and shared-memory
    attribute, no masked chunk: no launch); the engine then serves at the
    new width."""
    from repro_torch.api import PLAN_CACHE
    from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

    spec = _spec_cpu(128).to(cuda)
    eng = ReservoirEngine(spec, num_slots=32, backend="chunk", chunk_ticks=2, autoscale=True,
                          min_slots=32, max_slots=128, prewarm=False, learn=learn, device=cuda)
    torch.cuda.synchronize()
    sto_step.reset_launches()
    eng._rescale(128)
    torch.cuda.synchronize()
    assert not any(sto_step.LAUNCHES.values()), dict(sto_step.LAUNCHES)
    st = eng.stats()
    assert (st.cold_rescales, st.warm_rescales) == (1, 0) and st.rescale_stall_s > 0.0
    assert PLAN_CACHE.is_warm(spec, eng.sim.plan, n_out=eng.store.n_out, device=cuda)
    rows = _infer_rows(128, count=3)
    results = eng.run([StreamSession(sid=sid, u_seq=u.copy(),
                                     targets=None if learn is None else u[:, :1].copy())
                       for sid, u, _ in rows])
    assert sto_step.LAUNCHES["rk4_chunk"] > 0 and len(results) == 3
    assert all(np.isfinite(r.final_m).all() for r in results.values())


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["auto", "chunk"])
def test_serving_beside_the_prewarm_thread_on_the_card(cuda, backend):
    """An autoscaling engine whose prewarm thread launches masked chunks on
    the serving stream while it serves: bit-equal to one without the
    thread, and the thread ends."""
    from repro_torch.core.reservoir import Readout
    from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

    n = 320
    spec = _spec_cpu(n).to(cuda)
    rows = _infer_rows(n, count=160, seed=3)  # a burst past 64 slots: grows, then shrinks
    got = {}
    for prewarm in (True, False):
        eng = ReservoirEngine(spec, num_slots=64, backend=backend, chunk_ticks=4, autoscale=True,
                              min_slots=64, max_slots=256, prewarm=prewarm, device=cuda)
        got[prewarm] = eng.run([StreamSession(sid=sid, u_seq=np.repeat(u, 4, axis=0),
                                              readout=Readout(torch.from_numpy(w), 0))
                                for sid, u, w in rows])
        if eng._prewarm_thread is not None:
            eng._prewarm_thread.join(timeout=120)
            assert not eng._prewarm_thread.is_alive(), "the prewarm thread hung"
        assert not eng.prewarm_errors
        st = eng.stats()
        assert st.grows >= 1 and st.shrinks >= 1
        print(f"prewarm={prewarm}: grows {st.grows}, shrinks {st.shrinks}, cold {st.cold_rescales}, "
              f"warm {st.warm_rescales}, stall {st.rescale_stall_s:.4f} s")
    for sid, _, _ in rows:
        a, b = got[True][sid], got[False][sid]
        for x, y in ((a.states, b.states), (a.final_m, b.final_m), (a.outputs, b.outputs)):
            assert np.array_equal(x, y), sid


# ---------------------------------------------------------------------------
# the time-multiplexed delay line (kernels/csrc/sto_delay_line.cu)
# ---------------------------------------------------------------------------


def _delay_line_inputs(dev, n, e, seed=0):
    """One tick's operands: snapshots on the unit sphere, node drives,
    per-lane params, lanes 0 and 5 frozen."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(3, n, e))
    m /= np.linalg.norm(m, axis=0, keepdims=True)
    params = broadcast_params(
        constants.default_params(torch.float64, device="cpu"), e,
        current=rng.uniform(2e-3, 3e-3, e),
    )
    pv = kref.pack_params(params, e, torch.float32)
    h = rng.uniform(-0.5, 0.5, (n, e))
    mask = np.ones(e)
    mask[[0, 5]] = 0
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    return [t.to(dev).contiguous() for t in (as_t(m), as_t(h), pv, as_t(mask))]


@pytest.mark.cuda
@pytest.mark.parametrize("n,e", [(7, 37), (96, 64)])
def test_tm_delay_line_is_bit_equal_to_plain(cuda, n, e):
    """The kernel against tm_delay_line_plain on the card and on the CPU:
    bit-equal; frozen lanes keep their bits; one launch."""
    m, h, pv, mask = _delay_line_inputs(cuda, n, e)
    sto_step.reset_launches()
    out = sto_step.tm_delay_line(m, h, pv, DT, 3, mask)
    assert sto_step.LAUNCHES["tm_delay_line"] == 1
    plain = kref.tm_delay_line_plain(m[:, n - 1], h, pv, DT, 3)
    live = mask > 0.5
    assert torch.equal(out[:, :, ~live], m[:, :, ~live])
    assert torch.equal(out[:, :, live], plain[:, :, live])
    cpu = kref.tm_delay_line_plain(m[:, n - 1].cpu(), h.cpu(), pv.cpu(), DT, 3)
    assert torch.equal(out[:, :, live].cpu(), cpu[:, :, live.cpu()])
    assert torch.equal(sto_step.tm_delay_line(m, h, pv, DT, 3), plain)


@pytest.mark.cuda
def test_tm_chunk_is_bit_equal_to_plain(cuda):
    """K ticks: the feedback product (torch.matmul) and one launch each,
    against the plain chunk body, f32 and bf16 feedback W."""
    n, e, k = 48, 40, 3
    m, h, pv, _ = _delay_line_inputs(cuda, n, e, seed=1)
    rng = np.random.default_rng(2)
    hb = torch.as_tensor(rng.uniform(0, 0.5, (k, n, e)), dtype=torch.float32).to(cuda)
    mask = torch.as_tensor(rng.uniform(size=(k, e)) > 0.3).to(cuda)
    w = torch.eye(n, device=cuda) + 0.1 * torch.as_tensor(rng.normal(size=(n, n)),
                                                           dtype=torch.float32).to(cuda)
    for w_k in (w, w.to(torch.bfloat16)):
        sto_step.reset_launches()
        mk, sk = sto_step.tm_chunk(m, w_k, pv, DT, 2, hb, mask)
        assert sto_step.LAUNCHES["tm_delay_line"] == k
        mp, sp = kref.tm_chunk_planes(m, w_k, pv, DT, 2, hb, mask)
        assert torch.equal(mk, mp) and torch.equal(sk, sp)


@pytest.mark.cuda
def test_tm_delay_line_refuses_f64(cuda):
    m, h, pv, _ = _delay_line_inputs(cuda, 8, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sto_step.tm_delay_line(m.double(), h, pv, DT, 1)


def _family_sessions(n, count=10, seed=0):
    from repro_torch.core.reservoir import Readout
    from repro_torch.serve.reservoir import StreamSession

    rows = _infer_rows(n, count, seed)
    return lambda: [StreamSession(sid=sid, u_seq=u.copy(), readout=Readout(torch.from_numpy(w), 0))
                    for sid, u, w in rows]


@pytest.mark.cuda
def test_time_multiplexed_engine_launches_the_delay_line(cuda):
    """A time_multiplexed engine on "chunk" (and "auto", which resolves to
    it on the card) launches tm_delay_line and equals its interpret=True
    run (the plain body) bit for bit."""
    from repro_torch.api import make_time_multiplexed_spec
    from repro_torch.serve.reservoir import ReservoirEngine

    spec = make_time_multiplexed_spec(24, hold_steps=2, device=cuda)
    make = _family_sessions(24)
    got = {}
    for backend, interpret in (("chunk", False), ("auto", False), ("chunk", True)):
        eng = ReservoirEngine(spec, num_slots=4, backend=backend, chunk_ticks=3,
                              interpret=interpret, device=cuda)
        assert eng.backend == "chunk"
        sto_step.reset_launches()
        got[backend, interpret] = eng.run(make())
        launched = sto_step.LAUNCHES["tm_delay_line"]
        assert (launched == 0) if interpret else (launched > 0), dict(sto_step.LAUNCHES)
    for sid in got["chunk", True]:
        for a in (got["chunk", False][sid], got["auto", False][sid]):
            b = got["chunk", True][sid]
            for x, y in ((a.states, b.states), (a.final_m, b.final_m), (a.outputs, b.outputs)):
                assert np.array_equal(x, y), sid


@pytest.mark.cuda
@pytest.mark.parametrize("backend,kernel", [("fused", "rk4_fused"), ("tiled", "field_tiled")])
def test_array_transient_engine_through_the_kernels(cuda, backend, kernel):
    """array_transient on fused / tiled splits each hold window through the
    coupled kernels: launches them, within STATE_ATOL of interpret=True."""
    from repro_torch.api import make_array_transient_spec
    from repro_torch.serve.reservoir import ReservoirEngine

    spec = make_array_transient_spec(96, readout_window=2, hold_steps=3, device=cuda)
    make = _family_sessions(96, seed=1)
    got = {}
    for interpret in (False, True):
        eng = ReservoirEngine(spec, num_slots=4, backend=backend, chunk_ticks=3,
                              interpret=interpret, device=cuda)
        sto_step.reset_launches()
        got[interpret] = eng.run(make())
        assert (sto_step.LAUNCHES[kernel] == 0) == interpret, dict(sto_step.LAUNCHES)
    for sid in got[True]:
        a, b = got[False][sid], got[True][sid]
        assert np.abs(a.states - b.states).max() <= STATE_ATOL
        assert np.abs(a.final_m - b.final_m).max() <= STATE_ATOL


# -- tune on the card ---------------------------------------------------------------------

TUNE_IMPLS = [("chunk", "rk4_chunk"), ("tiled", "field_tiled")]


def _tune_setup(cuda, impl):
    from repro_torch.api import ExecPlan
    from repro_torch.tune import Float, SearchSpace, narma_task

    space = SearchSpace({"drive_current": Float(1e-3, 3e-3), "spectral_radius": Float(0.3, 0.9)})
    plan = ExecPlan(impl=impl, ensemble=8, chunk_ticks=4, learn="rls", learn_reg=1e-2)
    return _spec_cpu(64).to(cuda), narma_task(t=24, seed=0, learn_washout=6), space, plan


def _history(result):
    return [(t.trial_id, tuple(sorted(t.assignment.items())), t.engine_key, t.fitness)
            for t in result.trials]


@pytest.mark.cuda
@pytest.mark.parametrize("impl,kernel", TUNE_IMPLS)
def test_tune_rerun_is_bit_identical_on_the_card(cuda, impl, kernel):
    """A random search of 20 candidates over 8 lanes, twice with one seed:
    the trial histories (ids, assignments, engine keys, fitness) are
    identical bit for bit, and the impl's kernel launched."""
    from repro_torch.tune import tune_spec

    spec, task, space, plan = _tune_setup(cuda, impl)
    sto_step.reset_launches()
    runs = [_history(tune_spec(spec, task, space, budget=20, plan=plan, seed=5, device=cuda))
            for _ in range(2)]
    assert sto_step.LAUNCHES[kernel] > 0, dict(sto_step.LAUNCHES)
    assert len(runs[0]) == 20 and runs[0] == runs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("impl,kernel", TUNE_IMPLS)
def test_tune_trial_replays_bit_equal_on_the_card(cuda, impl, kernel, monkeypatch):
    """Each trial of a search served again alone, on a fresh engine of the
    same plan and width, in the lane it was evaluated in: the same
    learn_nmse bit for bit (a lane's arithmetic does not depend on what the
    other lanes hold)."""
    from repro_torch.api import PLAN_CACHE
    from repro_torch.serve.reservoir import ReservoirEngine, StreamSession
    from repro_torch.tune import tune_spec

    spec, task, space, plan = _tune_setup(cuda, impl)
    slots = {}
    pop = ReservoirEngine.pop_results

    def recording_pop(self):
        out = pop(self)
        slots.update({sid: r.slot for sid, r in out.items()})
        return out

    monkeypatch.setattr(ReservoirEngine, "pop_results", recording_pop)
    result = tune_spec(spec, task, space, budget=12, plan=plan, seed=2, device=cuda)
    for trial in result.trials:
        eng = ReservoirEngine(PLAN_CACHE.get_or_compile(spec, plan, device=cuda))
        slot = slots[trial.trial_id]
        eng.store.free_slots = lambda slot=slot: [slot]  # the trial's lane
        params = spec.params._replace(current=float(trial.assignment["current"]),
                                      a_cp=float(trial.assignment["a_cp"]))
        eng.submit(StreamSession(sid=0, u_seq=task.u_seq.copy(), targets=task.targets.copy(),
                                 params=params, learn_washout=task.learn_washout,
                                 collect_states=False))
        got = eng.run()[0]
        assert got.slot == slot
        assert got.learn_nmse == trial.fitness, (trial.trial_id, got.learn_nmse, trial.fitness)


@pytest.mark.cuda
@pytest.mark.parametrize("impl,kernel", TUNE_IMPLS)
def test_washout_autotune_cotenants_bit_equal_on_the_card(cuda, impl, kernel):
    """Six learning tenants beside a washout autotune whose probes fill the
    two spare lanes, against the same six served alone: every co-tenant's
    states, final_m, learned W and learn_nmse bit-equal; no probe sid in the
    results; max_retained restored."""
    from repro_torch.serve.reservoir import ReservoirEngine, StreamSession
    from repro_torch.api import PLAN_CACHE
    from repro_torch.core.tasks import narma_series

    spec, _, space, plan = _tune_setup(cuda, impl)

    def tenants():
        out = []
        for sid in range(1, 7):
            u, y = narma_series(20 + 2 * sid, order=10, seed=sid)
            out.append(StreamSession(sid=sid, u_seq=u, targets=y, learn_washout=4))
        return out

    alone = ReservoirEngine(PLAN_CACHE.get_or_compile(spec, plan, device=cuda)).run(tenants())
    eng = ReservoirEngine(PLAN_CACHE.get_or_compile(spec, plan, device=cuda), max_retained=50)
    for s in tenants():
        eng.submit(s)
    u, y = narma_series(30, order=10, seed=9)
    tuned = StreamSession(sid=0, u_seq=u, targets=y, learn_washout=12)
    sto_step.reset_launches()
    probe = eng.submit_autotuned(tuned, space, budget=4, seed=1)
    assert len(probe.trials) == 4 and eng.max_retained == 50
    got = eng.run()
    assert sto_step.LAUNCHES[kernel] > 0, dict(sto_step.LAUNCHES)
    assert sorted(got) == list(range(7))
    assert float(tuned.params.current) == probe.best.assignment["current"]
    for sid, want in alone.items():
        a = got[sid]
        assert np.array_equal(a.states, want.states) and np.array_equal(a.final_m, want.final_m)
        assert torch.equal(a.learned_readout.w_out, want.learned_readout.w_out)
        assert a.learn_nmse == want.learn_nmse


# ---------------------------------------------------------------------------
# LM attention routing by head dim, and auto on a state the kernels cannot take
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_reduced_lm_serves_on_cuda(cuda, capsys):
    """A reduced h2o-danube (head dim 16, outside the flash kernel's
    HEAD_DIMS) prefills through the einsum path on the card and generates,
    in the engine's geometry, the same tokens as the same weights on the
    CPU; the launcher serves it with its default device."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build_model, transformer
    from repro_torch.serve.engine import Engine, Request

    cfg = reduce_config(get_config("h2o-danube-1.8b"))
    assert cfg.head_dim == 16
    params = build_model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 19, 24, 17)]
    out = {}
    for dev in ("cpu", cuda):
        p = transformer.tree_map(lambda t: t.to(dev), params)
        reqs = [Request(i, torch.from_numpy(x), 6) for i, x in enumerate(prompts)]
        sto_step.reset_launches()
        out[str(dev)] = Engine(cfg, p, num_slots=2, capacity=32, device=dev).run(reqs)
        assert sto_step.LAUNCHES["flash_attention"] == 0
    assert out["cpu"] == out["cuda"]
    launch_serve.main(["--arch", "h2o-danube-1.8b", "--reduced", "--requests", "3",
                       "--slots", "2", "--gen", "4", "--prompt-len", "20"])
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_reduced_moe_serves_on_cuda(cuda, capacity_factor, capsys):
    """A reduced qwen2-moe (f32; dropless, and at its published capacity
    factor, where decode rows compete for slots): apply_moe's routing on the
    card bit-equal to the CPU's and y within 1e-5 (f32 sums in another
    order), and the engine generates the CPU's tokens; the launcher serves
    it with its default device."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build_model, moe, transformer
    from repro_torch.serve.engine import Engine, Request

    cfg = reduce_config(get_config("qwen2-moe-a2.7b"))
    if capacity_factor:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               capacity_factor=capacity_factor))
    params = build_model(cfg, device="cpu").init(0)
    lp = transformer.tree_map(lambda t: t[0], params["stack"][0]["mlp"])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 37, cfg.d_model))
                         .astype(np.float32))
    y, aux = moe.apply_moe(lp, cfg, x)
    lp_gpu = transformer.tree_map(lambda t: t.to(cuda), lp)
    y_gpu, aux_gpu = moe.apply_moe(lp_gpu, cfg, x.to(cuda))
    assert (y_gpu.cpu() - y).abs().max() <= 1e-5
    assert abs(float(aux_gpu) - float(aux)) <= 1e-6 * abs(float(aux))
    for lo in range(0, 74, cfg.moe.router_chunk):
        xc = x.reshape(-1, cfg.d_model)[lo:lo + cfg.moe.router_chunk]
        r, r_gpu = moe.route(lp, cfg.moe, xc), moe.route(lp_gpu, cfg.moe, xc.to(cuda))
        for a, b in ((r.top_e, r_gpu.top_e), (r.pos, r_gpu.pos), (r.keep, r_gpu.keep)):
            assert torch.equal(a, b.cpu())
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 19, 24, 17)]
    out = {}
    for dev in ("cpu", cuda):
        p = transformer.tree_map(lambda t: t.to(dev), params)
        reqs = [Request(i, torch.from_numpy(x), 6) for i, x in enumerate(prompts)]
        out[str(dev)] = Engine(cfg, p, num_slots=2, capacity=32, device=dev).run(reqs)
    assert out["cpu"] == out["cuda"]
    launch_serve.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--requests", "3",
                       "--slots", "2", "--gen", "4", "--prompt-len", "20"])
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out


def _mla_cfg(dtype="float32"):
    """Reduced deepseek-v2-lite (f32, 2 layers: the dense prefix and one MoE
    period) with its MLA dims set back to the full ones, so that a prefill's
    concat head dim is 192, one the flash kernel takes."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_config

    full = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(reduce_config(full), mla=full.mla, dtype=dtype)
    assert cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim == 192
    return cfg


@pytest.mark.cuda
def test_reduced_mla_serves_on_cuda(cuda, capsys):
    """The reduced deepseek at the full MLA dims: every prefill runs the flash
    kernel (one launch a layer), decode the absorbed einsums, and the engine
    generates the CPU's tokens; the launcher serves the reduced config with
    its default device."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build_model, transformer
    from repro_torch.serve.engine import Engine, Request

    cfg = _mla_cfg()
    params = build_model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 19, 24, 17)]
    out = {}
    for dev in ("cpu", cuda):
        p = transformer.tree_map(lambda t: t.to(dev), params)
        reqs = [Request(i, torch.from_numpy(x), 6) for i, x in enumerate(prompts)]
        sto_step.reset_launches()
        out[str(dev)] = Engine(cfg, p, num_slots=2, capacity=32, device=dev).run(reqs)
        want = cfg.num_layers * len(prompts) if dev != "cpu" else 0
        assert sto_step.LAUNCHES["flash_attention"] == want, (dev, dict(sto_step.LAUNCHES))
    assert out["cpu"] == out["cuda"]
    launch_serve.main(["--arch", "deepseek-v2-lite-16b", "--reduced", "--requests", "3",
                       "--slots", "2", "--gen", "4", "--prompt-len", "20"])
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out


@pytest.mark.cuda
def test_reduced_mla_grads_on_the_card_match_the_cpu(cuda):
    """The reduced deepseek at the full MLA dims: the loss and every gradient
    leaf on the card against the CPU's within TRAIN_RTOL, with no flash launch
    under grad; under no_grad the loss launches it once a layer and agrees
    within 5e-3."""
    from repro_torch import tree
    from repro_torch.data import DataConfig, SyntheticTokens, to_device
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    cfg = _mla_cfg()
    model, model_gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    params = model.init(0)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 4))
    b_cpu, b_gpu = to_device(data.batch(0), "cpu"), to_device(data.batch(0), "cuda")
    rel = lambda a, b: float((a.detach().cpu().double() - b.detach().double()).abs().max()  # noqa: E731
                             / b.detach().double().abs().max().clamp(min=1e-30))
    p_gpu = _tree_to(params, cuda)
    sto_step.reset_launches()
    loss_gpu, g_gpu = steps.loss_and_grads(model_gpu, p_gpu, b_gpu)
    assert sto_step.LAUNCHES["flash_attention"] == 0
    loss_cpu, g_cpu = steps.loss_and_grads(model, params, b_cpu)
    assert rel(loss_gpu, loss_cpu) <= TRAIN_RTOL
    for a, b in zip(tree.leaves(g_gpu), tree.leaves(g_cpu)):
        assert rel(a, b) <= TRAIN_RTOL
    with torch.no_grad():
        flash_loss, _ = model_gpu.loss_fn(p_gpu, b_gpu)
    assert sto_step.LAUNCHES["flash_attention"] == cfg.num_layers
    assert abs(float(flash_loss) - float(loss_gpu)) <= 5e-3 * abs(float(loss_gpu))


def _recurrent_cfg(arch):
    """Reduced jamba or xlstm-125m (f32). jamba's attention layer at H 8,
    KVH 1, D 128: a GQA group of 8, as the full config's 64 / 8, at a head
    dim the flash kernel takes."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_config

    cfg = reduce_config(get_config(arch))
    if cfg.mamba is not None:
        cfg = dataclasses.replace(cfg, num_heads=8, num_kv_heads=1, head_dim=128)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_reduced_recurrent_serves_on_cuda(cuda, arch, capsys):
    """Reduced jamba (Mamba layers, its attention layer through the flash
    kernel at G = 8, one launch a prefill; MoE) and xlstm-125m (mLSTM and
    sLSTM, no kernel): the engine generates the CPU's tokens; the launcher
    serves the reduced config with its default device."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build_model, transformer
    from repro_torch.serve.engine import Engine, Request

    cfg = _recurrent_cfg(arch)
    params = build_model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 19, 24, 17)]
    out = {}
    for dev in ("cpu", cuda):
        p = transformer.tree_map(lambda t: t.to(dev), params)
        reqs = [Request(i, torch.from_numpy(x), 6) for i, x in enumerate(prompts)]
        sto_step.reset_launches()
        out[str(dev)] = Engine(cfg, p, num_slots=2, capacity=32, device=dev).run(reqs)
        attn = sum(spec.mixer == "attn" for spec in cfg.layer_kinds())
        want = attn * len(prompts) if dev != "cpu" else 0
        assert sto_step.LAUNCHES["flash_attention"] == want, (dev, dict(sto_step.LAUNCHES))
    assert out["cpu"] == out["cuda"]
    launch_serve.main(["--arch", arch, "--reduced", "--requests", "3",
                       "--slots", "2", "--gen", "4", "--prompt-len", "20"])
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("block", ["mamba", "mlstm", "slstm"])
def test_recurrent_blocks_on_the_card_match_the_cpu(cuda, block):
    """One reduced Mamba / mLSTM / sLSTM block (f32): a 37-token forward with
    its cache (Mamba: chunks of 8 and a padded remainder), then a decode
    step writing the cache in place, the card against the CPU within 2e-5
    (f32 sums in another order: the bound the CPU tests hold the port to
    against the reference)."""
    from repro_torch.models import build_model, mamba, transformer, xlstm

    arch = "jamba-1.5-large-398b" if block == "mamba" else "xlstm-125m"
    cfg = _recurrent_cfg(arch)
    layer = [spec.mixer for spec in cfg.period].index(block)
    params = build_model(cfg, device="cpu").init(0)
    p = transformer.tree_map(lambda t: t[0], params["stack"][layer]["mixer"])
    mod = mamba if block == "mamba" else xlstm
    fwd, dec = getattr(mod, f"{block}_forward"), getattr(mod, f"{block}_decode")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 38, cfg.d_model))
                         .astype(np.float32))
    res = []
    for dev in ("cpu", cuda):
        pd = transformer.tree_map(lambda t: t.to(dev), p)
        y, cache = fwd(pd, cfg, x[:, :37].to(dev), return_cache=True)
        leaves = dict(cache)
        yd, out = dec(pd, cfg, x[:, 37:].to(dev), cache)
        assert out is cache and all(cache[k] is leaves[k] for k in leaves)
        res.append([y, yd] + [cache[k] for k in sorted(cache)])
    for a, b in zip(res[1], res[0]):
        assert a.shape == b.shape and (a.cpu() - b).abs().max() <= 2e-5


# the recurrent archs' gradient leaves, card against CPU, relative to each
# leaf's largest magnitude (TRAIN_RTOL holds the dense family's).
# Basis (tools/recurrent_grad_margin.py --device cuda, NVIDIA H100 80GB
# HBM3, 700.00 W): these gradients are that sensitive. One f32 rounding of
# every parameter moves the host CPU's own leaves by up to 6.3e-5, and the
# card against the host CPU reads up to 1.0e-4 (xlstm; jamba 1.6e-5) over
# seeds 0-4 and two steps. The subtlest planted fault (sLSTM's normaliser
# clamp dropped) reads 0.22. The limit sits 5x above the one, 440x below
# the other.
RECURRENT_GRAD_RTOL = 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_reduced_recurrent_grads_on_the_card_match_the_cpu(cuda, arch):
    """Reduced jamba and xlstm-125m (f32): the loss on the card against the
    CPU's within TRAIN_RTOL and every gradient leaf within
    RECURRENT_GRAD_RTOL, through autograd on the plain ops (neither mixer
    has a kernel; the flash kernel is not launched under grad)."""
    from repro_torch import tree
    from repro_torch.data import DataConfig, SyntheticTokens, to_device
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    cfg = _recurrent_cfg(arch)
    model, model_gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    params = model.init(0)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 4))
    b_cpu, b_gpu = to_device(data.batch(0), "cpu"), to_device(data.batch(0), "cuda")
    rel = lambda a, b: float((a.detach().cpu().double() - b.detach().double()).abs().max()  # noqa: E731
                             / b.detach().double().abs().max().clamp(min=1e-30))
    sto_step.reset_launches()
    loss_gpu, g_gpu = steps.loss_and_grads(model_gpu, _tree_to(params, cuda), b_gpu)
    assert sto_step.LAUNCHES["flash_attention"] == 0
    loss_cpu, g_cpu = steps.loss_and_grads(model, params, b_cpu)
    assert rel(loss_gpu, loss_cpu) <= TRAIN_RTOL
    for a, b in zip(tree.leaves(g_gpu), tree.leaves(g_cpu)):
        assert rel(a, b) <= RECURRENT_GRAD_RTOL


def _encdec_cfg(arch, dtype="float32"):
    """Reduced whisper (2 encoder layers, one decoder layer) or llava, with
    head dim 64, one the flash kernel takes, so that the kernel is on the
    path (the reduced configs' 16 is not)."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_config

    return dataclasses.replace(reduce_config(get_config(arch)), head_dim=64, dtype=dtype)


@pytest.mark.cuda
def test_cross_attention_routes_to_the_kernel(cuda):
    """A cross-attention prefill (q_offset 0, 7 queries against 1500 keys,
    no mask) launches the kernel, as does a cross decode step; whisper's
    prefill launches it once a layer (encoder, decoder self, cross), a
    decode step once a decoder layer (cross; self attention decodes through
    the einsum path)."""
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.models import attention, build_model, transformer

    q, k, v = _qkv(cuda, 1, 8, 8, 7, 1500, 64, torch.bfloat16)
    LAUNCHES["flash_attention"] = 0
    out = attention.grouped_attend(q, k, v, causal=False, q_offset=0)
    assert LAUNCHES["flash_attention"] == 1
    ref = attention._grouped_attend_dense(q, k, v, causal=False, q_offset=0)
    assert (out.float() - ref.float()).abs().max().item() <= FLASH_ATOL[torch.bfloat16]
    cfg = _encdec_cfg("whisper-base", "bfloat16")
    m = build_model(cfg, device=cuda)
    p = m.init(0)
    frames = 0.02 * torch.randn(2, 50, cfg.d_model, device=cuda, dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), device=cuda)
    sto_step.reset_launches()
    _, caches = m.prefill(p, {"encoder_frames": frames, "tokens": tokens})
    assert sto_step.LAUNCHES["flash_attention"] == cfg.encoder_layers + 2 * cfg.num_layers
    caches = transformer.pad_caches(cfg, caches, 16)
    sto_step.reset_launches()
    m.decode_step(p, tokens[:, :1], caches, torch.tensor([9, 9], device=cuda))
    assert sto_step.LAUNCHES["flash_attention"] == cfg.num_layers


def _greedy(m, params, batch, steps, capacity, cfg):
    """Prefill `batch`, then `steps` greedy decode steps; the tokens and the
    prefill's last logits."""
    from repro_torch.models import transformer

    last, caches = m.prefill(params, batch)
    caches = transformer.pad_caches(cfg, caches, capacity)
    tok = last[:, -1, : cfg.vocab_size].argmax(-1)[:, None]
    n = (batch["tokens"] if "tokens" in batch else batch["inputs_embeds"]).shape[1]
    out = [tok]
    for i in range(steps):
        pos = torch.full((tok.shape[0],), n + i, device=tok.device)
        lg, caches = m.decode_step(params, tok, caches, pos)
        tok = lg[:, -1, : cfg.vocab_size].argmax(-1)[:, None]
        out.append(tok)
    return torch.cat(out, 1).cpu(), last.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-mistral-7b"])
def test_reduced_encdec_and_embedding_input_serve_on_cuda(cuda, arch):
    """Reduced whisper (frames and a token prompt) and llava (inputs_embeds)
    at head dim 64, f32: prefill through the flash kernel (one launch a
    layer and, for whisper, an encoder layer and a cross block each) and 8
    greedy decode steps generate the CPU's tokens, the prefill's logits
    within 1e-4; llava's Engine on token prompts serves the CPU's tokens."""
    from repro_torch.models import build_model, layers, transformer
    from repro_torch.serve.engine import Engine, Request

    cfg = _encdec_cfg(arch)
    params = build_model(cfg, device="cpu").init(0)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    if cfg.encoder_layers:
        batch = {"encoder_frames": 0.02 * torch.randn(2, 30, cfg.d_model, generator=g),
                 "tokens": tokens}
        want = cfg.encoder_layers + 2 * cfg.num_layers
    else:
        batch = {"inputs_embeds": layers.embed_tokens(params["embed"], tokens)}
        want = cfg.num_layers
    out = {}
    for dev in ("cpu", cuda):
        p = transformer.tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        sto_step.reset_launches()
        m = build_model(cfg, device=dev)
        out[str(dev)] = _greedy(m, p, b, 8, 24, cfg)
        launches = sto_step.LAUNCHES["flash_attention"]
        if dev != "cpu":
            cross = cfg.num_layers * 8 if cfg.encoder_layers else 0  # a cross block a step
            assert launches == want + cross, (launches, want + cross)
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    assert (out["cpu"][1] - out["cuda"][1]).abs().max() <= 1e-4
    if not cfg.encoder_layers:
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 19, 24, 17)]
        served = {}
        for dev in ("cpu", cuda):
            p = transformer.tree_map(lambda t: t.to(dev), params)
            reqs = [Request(i, torch.from_numpy(x), 6) for i, x in enumerate(prompts)]
            served[str(dev)] = Engine(cfg, p, num_slots=2, capacity=32, device=dev).run(reqs)
        assert served["cpu"] == served["cuda"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-mistral-7b"])
def test_reduced_encdec_grads_on_the_card_match_the_cpu(cuda, arch):
    """Reduced whisper (with remat: the encoder's gradient through the
    checkpointed period's cross-attention) and llava at head dim 64, f32:
    the loss and every gradient leaf on the card against the CPU's within
    TRAIN_RTOL (a k bias, whose gradient is 0 in exact arithmetic, against
    the tree's largest magnitude), no flash launch under grad."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.launch import steps
    from repro_torch.models import build_model, layers

    cfg = dataclasses.replace(_encdec_cfg(arch), remat=True)
    model, model_gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    params = model.init(0)
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
    batch = {"labels": torch.randint(0, cfg.vocab_size, (2, 24), generator=g)}
    if cfg.encoder_layers:
        batch.update(encoder_frames=0.02 * torch.randn(2, 30, cfg.d_model, generator=g),
                     tokens=tokens)
    else:
        batch["inputs_embeds"] = layers.embed_tokens(params["embed"], tokens)
    sto_step.reset_launches()
    loss_gpu, g_gpu = steps.loss_and_grads(model_gpu, _tree_to(params, cuda),
                                           {k: v.to(cuda) for k, v in batch.items()})
    assert sto_step.LAUNCHES["flash_attention"] == 0
    loss_cpu, g_cpu = steps.loss_and_grads(model, params, batch)
    scale = max(float(b.abs().max()) for b in tree.leaves(g_cpu))
    assert abs(float(loss_gpu) - float(loss_cpu)) <= TRAIN_RTOL * abs(float(loss_cpu))
    for (path, b), a in zip(tree.leaves_with_path(g_cpu), tree.leaves(g_gpu)):
        diff = float((a.cpu().double() - b.double()).abs().max())
        ref = scale if path[-2:] == ("wk", "bias") else float(b.abs().max())
        assert diff <= TRAIN_RTOL * max(ref, 1e-30), (path, diff, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("topology", ["coupled_array", "time_multiplexed", "array_transient"])
def test_f64_engine_under_auto(cuda, topology):
    """impl="auto" on an f64 spec resolves to "ref" on the card (the kernels
    take f32): ReservoirEngine builds, serves a few ticks, and matches the
    same engine on the CPU within F64_ATOL = 1e-10. A kernel impl the caller
    names still raises."""
    from repro_torch.api import make_array_transient_spec, make_spec, make_time_multiplexed_spec
    from repro_torch.serve.reservoir import ReservoirEngine, StreamSession

    build = {"coupled_array": make_spec, "time_multiplexed": make_time_multiplexed_spec,
             "array_transient": lambda n, **kw: make_array_transient_spec(n, 2, **kw)}[topology]
    rng = np.random.default_rng(3)
    streams = [rng.uniform(0.0, 0.5, (6 + i, 1)) for i in range(3)]
    got = {}
    for dev in ("cpu", cuda):
        spec = build(16, hold_steps=4, seed=0, dtype=torch.float64, device=dev)
        eng = ReservoirEngine(spec, num_slots=4, chunk_ticks=3, device=dev)
        assert eng.backend == "ref"
        got[str(dev)] = eng.run([StreamSession(sid=i, u_seq=u) for i, u in enumerate(streams)])
    for sid in range(3):
        a, b = got["cuda"][sid], got["cpu"][sid]
        assert a.states.dtype == np.float64
        assert np.abs(a.states - b.states).max() <= 1e-10
        assert np.abs(a.final_m - b.final_m).max() <= 1e-10
    with pytest.raises(NotImplementedError, match="f32 state"):
        ReservoirEngine(build(16, hold_steps=4, seed=0, dtype=torch.float64, device=cuda),
                        num_slots=4, backend="chunk", device=cuda)


# ---------------------------------------------------------------------------
# the fleet on the card
# ---------------------------------------------------------------------------

FLEET_KW = dict(n=64, num_slots=8, hold_steps=5, seed=0, backend="chunk", chunk_ticks=4)


def _fleet_streams(count=20, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.0, 0.5, (int(rng.integers(5, 19)), 1)).astype(np.float32)
            for _ in range(count)]


@pytest.mark.cuda
def test_local_replicas_from_the_executor_thread(cuda):
    """FleetFrontend steps its local replicas from its one-worker executor,
    not the thread that built them: each session's states and final_m are
    bit-equal to the same replicas stepped on the main thread, and an
    autoscaling replica's prewarm thread, started from the executor, warms
    its buckets without error."""
    import asyncio
    import dataclasses
    import threading

    from repro_torch.api import PLAN_CACHE
    from repro_torch.serve.fleet import FleetFrontend, FleetRouter, start_fleet
    from repro_torch.serve.reservoir import StreamSession, _bucket_ladder

    kw = dict(FLEET_KW, device="cuda")
    streams = _fleet_streams()
    router = FleetRouter()
    for r in start_fleet(2, "local", **kw):
        router.add_replica(r)
    for sid, u in enumerate(streams):
        router.submit(64, StreamSession(sid=sid, u_seq=u.copy()))
    main_thread = router.drain()
    router.close()

    threads, scaled = set(), {}

    async def serve():
        router = FleetRouter()
        for r in start_fleet(2, "local", **kw):
            router.add_replica(r)
        async with FleetFrontend(router) as fleet:
            # an autoscaling replica built on the executor's thread (its
            # prewarm thread starts there) serves a pool of its own
            (scaler,) = await fleet._call(
                lambda: start_fleet(1, "local", **dict(kw, n=48, autoscale=True, min_slots=4,
                                                      max_slots=16))
            )
            router.add_replica(scaler)
            for sid, u in enumerate(streams):
                await fleet.submit_stream(64, u.copy(), sid=sid)
            for sid, u in enumerate(streams[:12]):
                await fleet.submit_stream(48, u.copy(), sid=100 + sid)
            got = await fleet.drain_results()
            await fleet._call(lambda: threads.add(threading.get_ident()))
            await fleet._call(scaler.engine.prewarm_buckets, True)
            scaled["engine"] = scaler.engine
        return got

    sto_step.reset_launches()
    got = asyncio.run(serve())
    assert sto_step.LAUNCHES["rk4_chunk"] > 0
    assert threads and threading.get_ident() not in threads
    assert sorted(got) == list(range(len(streams))) + list(range(100, 112))
    for sid, want in main_thread.items():
        assert np.array_equal(got[sid].states, want.states)
        assert np.array_equal(got[sid].final_m, want.final_m)
    for sid in range(100, 112):
        assert got[sid].error is None and np.isfinite(got[sid].states).all()
    eng = scaled["engine"]
    assert eng.prewarm_errors == []
    ladder = _bucket_ladder(eng.min_slots, eng.max_slots)
    adjacent = [max((b for b in ladder if b < eng.num_slots), default=None),
                min((b for b in ladder if b > eng.num_slots), default=None)]
    for width in (b for b in adjacent if b is not None):
        assert PLAN_CACHE.is_warm(
                eng.sim.spec, dataclasses.replace(eng.sim.plan, ensemble=width),
                n_out=eng.store.n_out, device=eng.device, spec_hash=eng._spec_hash,
            ), width


class _TensorDevices:
    """The devices of every tensor inside a message, found by pickling it."""

    def __init__(self, msg):
        import io
        import pickle

        devices = self.devices = set()

        class Recorder(pickle.Pickler):
            def persistent_id(self, obj):
                if isinstance(obj, torch.Tensor):
                    devices.add(obj.device.type)
                return None

        Recorder(io.BytesIO(), protocol=pickle.HIGHEST_PROTOCOL).dump(msg)


@pytest.mark.cuda
def test_process_replica_on_cuda_moves_only_host_data(cuda):
    """A process replica on the card is sent a session whose params, readout
    and m0 live on the card, and answers with results, stats, a snapshot and
    a checkpoint: nothing that crossed the pipe holds CUDA storage, and the
    child served with the chunk kernel."""
    from repro_torch.core.reservoir import Readout
    from repro_torch.serve.fleet import LocalReplica, start_fleet
    from repro_torch.serve.fleet.replica import _host_session
    from repro_torch.serve.reservoir import StreamSession

    kw = dict(FLEET_KW, device="cuda")
    (rep,) = start_fleet(1, "process", rpc_timeout_s=120.0, **kw)
    try:
        spec = LocalReplica(**kw).engine.res
        rng = np.random.default_rng(6)
        w = torch.from_numpy(rng.normal(0, 0.1, (65, 1)).astype(np.float32)).to(cuda)
        sessions = [
            StreamSession(sid=i, u_seq=u, readout=Readout(w, 0),
                          params=spec.params._replace(current=torch.tensor(2.5e-3, device=cuda)),
                          m0=spec.m0.clone())
            for i, u in enumerate(_fleet_streams(6))
        ]
        for s in sessions:
            msg = ("submit", _host_session(s))
            assert _TensorDevices(msg).devices <= {"cpu"}
            assert s.readout.w_out.device.type == "cuda"  # the caller's session is untouched
            rep.submit(s)
        rep.run_for(1)
        replies = {"snapshot": rep.snapshot(), "checkpoint": rep.checkpoint_session(0)}
        rep.restore_session(replies["checkpoint"])
        while rep.run_for(1):
            pass
        replies["results"] = rep.results()
        replies["stats"] = rep.stats()
        assert len(replies["results"]) == 6 and replies["stats"].backend == "chunk"
        assert replies["stats"].ticks > 0
        for op, reply in replies.items():
            assert _TensorDevices(reply).devices <= {"cpu"}, op
    finally:
        rep.close()
    assert not rep._proc.is_alive()


def _engine_without_nvcc(**kw):
    """A replica factory that loads the kernel library after building the
    engine and refuses to come up if that load ran nvcc."""
    from repro_torch.kernels import _build
    from repro_torch.serve.fleet import make_engine

    eng = make_engine(**kw)
    _build.load()
    if _build.BUILD_LOG is not None:
        raise RuntimeError(f"the replica child ran nvcc in {_build.BUILD_DIR}")
    return eng


@pytest.mark.cuda
def test_process_fleet_children_run_no_nvcc(cuda, tmp_path):
    """start_fleet(transport="process") builds the kernel library once in the
    parent, into the children's compilation_cache_dir, before any child
    spawns: each child only loads it (its factory raises if it ran nvcc),
    and the directory holds that one library and no object file."""
    from repro_torch.kernels import _build
    from repro_torch.serve.fleet import start_fleet
    from repro_torch.serve.reservoir import StreamSession

    where = tmp_path / "kernels"
    reps = start_fleet(2, "process", factory=_engine_without_nvcc, rpc_timeout_s=120.0,
                       compilation_cache_dir=str(where), device="cuda", **FLEET_KW)
    try:
        built = sorted(p.name for p in where.iterdir())
        assert built == [f"librepro_torch_{_build._source_hash()}.so"], built
        for i, (r, u) in enumerate(zip(reps, _fleet_streams(2))):
            r.submit(StreamSession(sid=i, u_seq=u))
            while r.run_for(1):
                pass
            assert len(r.results()) == 1 and r.stats().backend == "chunk"
        assert sorted(p.name for p in where.iterdir()) == built
    finally:
        for r in reps:
            r.close()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 1])
def test_learners_keep_their_bits_in_any_lane(cuda, k):
    """Every lane of a width-8 batch holds one lane's numbers (S = 2501
    features: lane e's rows start at four alignments): rls_chunk's P, W and
    predictions and lms_chunk's W and predictions are bit-equal in every
    lane, so a learner migrated into another lane keeps its bits."""
    e, s = 8, 2501
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((s, s), generator=g, device=cuda)
    lane = (
        torch.eye(s, device=cuda) / 1e-2 + 1e-3 * (a + a.T),
        0.1 * torch.randn((s, 1), generator=g, device=cuda),
        torch.randn((k, s), generator=g, device=cuda),
        torch.randn((k, 1), generator=g, device=cuda),
    )
    p, w = (t[None].expand(e, *t.shape).contiguous() for t in lane[:2])
    x, y = (t[:, None].expand(k, e, *t.shape[1:]).contiguous() for t in lane[2:])
    mask = torch.ones((k, e), dtype=torch.bool, device=cuda)
    p2, w2, preds = krls.rls_chunk(p, w, x, y, mask, 1.0)
    w3, preds3 = krls.lms_chunk(w, x, y, mask, 0.5)
    for out in (p2, w2, preds.transpose(0, 1), w3, preds3.transpose(0, 1)):
        assert all(torch.equal(out[i], out[0]) for i in range(1, e))


_NCCL_SCRIPT = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.api import ExecPlan, compile_plan, make_spec
from repro_torch.kernels import ops

torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
dist.init_process_group("nccl", store=dist.FileStore(sys.argv[1], 1), rank=0, world_size=1)
try:
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    n, e, k = 64, 8, 3
    spec = make_spec(n, n_in=1, seed=0, hold_steps=3, device="cuda")
    rng = np.random.default_rng(0)
    u = torch.as_tensor(rng.uniform(0.0, 0.5, (k, e, 1)), dtype=torch.float32, device="cuda")
    y = torch.as_tensor(rng.normal(size=(k, e, 1)), dtype=torch.float32, device="cuda")
    mask = torch.ones((k, e), dtype=torch.bool, device="cuda")
    mask[:, 0] = False
    mask[1:, 1] = False
    m0 = ops.to_planes(spec.m0.expand(e, n, 3)).contiguous()
    for learn in (None, "rls"):
        kw = dict(ensemble=e, chunk_ticks=k, learn=learn, learn_reg=1e-2)
        sh = compile_plan(spec, ExecPlan(mesh=mesh, **kw), device="cuda")
        un = compile_plan(spec, ExecPlan(impl="scan", **kw), device="cuda")
        assert sh.device == torch.device("cuda", 0), sh.device
        extra = {} if learn is None else dict(targets=y, learn_state=un.init_learn_state())
        a, b = sh.tick_chunk(m0, u, mask, **extra), un.tick_chunk(m0, u, mask, **extra)
        flat = lambda out: [out[0], out[1]] + ([] if learn is None else [*out[2], out[3]])
        for x, z in zip(flat(a), flat(b)):
            assert torch.equal(x, z), (learn, (x - z).abs().max().item())
        assert torch.equal(a[0][:, :, 0], m0[:, :, 0])
    try:
        compile_plan(spec, ExecPlan(ensemble=e, mesh=mesh), device="cpu")
        raise AssertionError("a cpu device on a cuda mesh was accepted")
    except ValueError as exc:
        assert "device type 'cuda'" in str(exc), exc
    print("ok")
finally:
    dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_world_size_one_nccl_mesh_is_bit_equal_to_scan(cuda, tmp_path):
    """A sharded plan on a (1, 1) NCCL mesh, in a process of its own (rank 0
    of a world of one, a FileStore): tick_chunk and the RLS chunk bit-equal
    to the unsharded impl="scan" at N = 64, E = 8 (the frozen lane
    bit-identical), and a CPU device refused on a CUDA mesh."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"), RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0")
    proc = subprocess.run([sys.executable, "-c", _NCCL_SCRIPT, str(tmp_path / "store")],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-4000:]


# -- training on the card ------------------------------------------------------

# one train step on the card against the same step on the CPU, relative to
# each leaf's largest magnitude: f32 on both sides with TF32 off, sums in
# other orders (cuBLAS, atomics in the gather's and the embedding's backward)
TRAIN_RTOL = 1e-5
# the whole step's worst updated leaf: AdamW divides each gradient element by
# the root of its second moment, so an element small against its leaf's f32
# rounding moves by more than that rounding; below a step with the wrong step
# index, without the clip or on bf16 parameters
TRAIN_STEP_RTOL = 5e-4
# a resumed run against the uninterrupted one (tests/test_train_substrate.py's
# bound; the backward's atomics make the card's steps not bit-reproducible)
RESUME_RTOL = 2e-4


def _train_cfg(dtype="float32"):
    """Reduced h2o-danube at d_model 320, 4 heads: head dim 80, one the flash
    kernel takes, so a step that reached it would show in its counter."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_config

    cfg = reduce_config(get_config("h2o-danube-1.8b"), d_model=320)
    assert cfg.head_dim == 80
    return dataclasses.replace(cfg, dtype=dtype)


def _tree_to(t, dev):
    from repro_torch import tree

    return tree.tree_map(lambda x: x.detach().to(dev).clone(), t)


@pytest.mark.cuda
def test_training_grads_reach_wq_wk_wv_through_the_einsum_path(cuda):
    """Under grad, the attention of a bf16 model whose head dim the flash
    kernel takes runs the einsum path (no launch) and wq / wk / wv get
    non-zero gradients, equal to a no-flash forward's (the einsum path
    forced by hand) within one bf16 ulp; under no_grad the same loss launches the
    kernel once a layer, and the two losses agree within 5e-3."""
    from repro_torch.data import DataConfig, SyntheticTokens, to_device
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.launch import steps
    from repro_torch.models import attention, build_model

    cfg = _train_cfg("bfloat16")
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    batch = to_device(SyntheticTokens(DataConfig(cfg.vocab_size, 128, 2)).batch(0), "cuda")
    grads = lambda: steps.loss_and_grads(model, params, batch)  # noqa: E731
    LAUNCHES["flash_attention"] = 0
    loss, g = grads()
    assert LAUNCHES["flash_attention"] == 0
    mixer = g["stack"][0]["mixer"]
    for name in ("wq", "wk", "wv"):
        assert float(mixer[name]["kernel"].float().abs().max()) > 0, name
    on_card = attention._on_card
    attention._on_card = lambda q: False  # every call to the einsum path
    try:
        _, g_dense = grads()
    finally:
        attention._on_card = on_card
    for name in ("wq", "wk", "wv"):
        a, b = mixer[name]["kernel"].float(), g_dense["stack"][0]["mixer"][name]["kernel"].float()
        # one path, run twice: within one bf16 ulp of the leaf's largest
        # magnitude (2^-7 of it), should a reduction on the card reorder
        assert float((a - b).abs().max()) <= 2.0**-7 * float(b.abs().max()), name
    with torch.no_grad():
        flash_loss, _ = model.loss_fn(params, batch)
    assert LAUNCHES["flash_attention"] == cfg.num_layers
    assert abs(float(flash_loss) - float(loss)) <= 5e-3 * abs(float(loss))


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """From the same weights and an AdamW state two CPU steps warmed: the
    loss and every gradient leaf, the global norm, and the AdamW update on
    the same clipped gradients match the CPU's within TRAIN_RTOL; the whole
    step's loss and grad norm too, with no flash launch, and its updated
    leaves within TRAIN_STEP_RTOL, which a step with the wrong step index,
    without the clip or on bf16 parameters exceeds."""
    from repro_torch import tree
    from repro_torch.data import DataConfig, SyntheticTokens, to_device
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.launch import steps
    from repro_torch.optim import clip_by_global_norm, global_norm

    cfg = _train_cfg()
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 4))
    kw = dict(lr=1e-3, warmup=2, total_steps=100)
    step_cpu, opt, model = steps.make_train_step(cfg, device="cpu", **kw)
    step_gpu, _, model_gpu = steps.make_train_step(cfg, device="cuda", **kw)
    params = model.init(0)
    state = opt.init(params, device="cpu")
    for s in range(2):
        params, state, _ = step_cpu(params, state, to_device(data.batch(s), "cpu"), torch.tensor(s))
    b_cpu, b_gpu = to_device(data.batch(2), "cpu"), to_device(data.batch(2), "cuda")
    rel = lambda a, b: float((a.cpu().double() - b.double()).abs().max()  # noqa: E731
                             / b.double().abs().max().clamp(min=1e-30))
    LAUNCHES["flash_attention"] = 0
    p_gpu = _tree_to(params, cuda)
    loss_gpu, g_gpu = steps.loss_and_grads(model_gpu, p_gpu, b_gpu)
    loss_cpu, g_cpu = steps.loss_and_grads(model, _tree_to(params, "cpu"), b_cpu)
    assert rel(loss_gpu, loss_cpu) <= TRAIN_RTOL
    gn_gpu, gn_cpu = global_norm(g_gpu), global_norm(g_cpu)
    assert rel(gn_gpu, gn_cpu) <= TRAIN_RTOL
    g_gpu, g_cpu = clip_by_global_norm(g_gpu, 1.0, gn_gpu), clip_by_global_norm(g_cpu, 1.0, gn_cpu)
    for a, b in zip(tree.leaves(g_gpu), tree.leaves(g_cpu)):
        assert rel(a, b) <= TRAIN_RTOL
    s_gpu = _tree_to(state, cuda)
    opt.update(p_gpu, g_gpu, s_gpu, torch.tensor(2, device=cuda))
    p_ref, s_ref = _tree_to(params, "cpu"), _tree_to(state, "cpu")
    opt.update(p_ref, _tree_to(g_gpu, "cpu"), s_ref, torch.tensor(2))
    for a, b in zip(tree.leaves({"p": p_gpu, "s": s_gpu}), tree.leaves({"p": p_ref, "s": s_ref})):
        assert rel(a, b) <= TRAIN_RTOL
    two = torch.tensor(2, device=cuda)
    p_gpu, s_gpu, m_gpu = step_gpu(_tree_to(params, cuda), _tree_to(state, cuda), b_gpu, two)
    assert LAUNCHES["flash_attention"] == 0
    controls = {"step index 3": step_gpu(_tree_to(params, cuda), _tree_to(state, cuda), b_gpu,
                                         torch.tensor(3, device=cuda))[:2]}
    p_nc, s_nc = _tree_to(params, cuda), _tree_to(state, cuda)
    controls["no clip"] = opt.update(p_nc, steps.loss_and_grads(model_gpu, p_nc, b_gpu)[1],
                                     s_nc, two)
    step_bf16 = steps.make_train_step(_train_cfg("bfloat16"), device="cuda", **kw)[0]
    p_bf, s_bf = step_bf16(tree.tree_map(lambda x: x.to(cuda, torch.bfloat16), params),
                           _tree_to(state, cuda), b_gpu, two)[:2]
    controls["bf16 parameters"] = (tree.tree_map(torch.Tensor.float, p_bf), s_bf)
    p_cpu, s_cpu, m_cpu = step_cpu(params, state, b_cpu, torch.tensor(2))
    assert rel(m_gpu["loss"], m_cpu["loss"]) <= TRAIN_RTOL
    assert rel(m_gpu["grad_norm"], m_cpu["grad_norm"]) <= TRAIN_RTOL
    want = tree.leaves({"p": p_cpu, "s": s_cpu})
    worst = lambda got: max(rel(a, b) for a, b in zip(tree.leaves(got), want))  # noqa: E731
    step_err = worst({"p": p_gpu, "s": s_gpu})
    control_errs = {k: worst({"p": p, "s": st}) for k, (p, st) in controls.items()}
    print(f"whole step's worst leaf {step_err:.3e}; controls {control_errs}")
    assert step_err <= TRAIN_STEP_RTOL
    assert min(control_errs.values()) > TRAIN_STEP_RTOL, control_errs


@pytest.mark.cuda
def test_training_resumes_after_a_crash_on_the_card(cuda, tmp_path):
    """12 steps with a checkpoint every 4; a crash at step 9; the relaunch
    resumes at step 8 and its losses track the uninterrupted run's."""
    from repro_torch.train import LoopConfig, train

    cfg = _train_cfg()
    kw = dict(total_steps=12, seq_len=64, global_batch=4, ckpt_every=4, log_every=0,
              lr=1e-3, warmup=5)
    ref = train(cfg, LoopConfig(ckpt_dir=str(tmp_path / "ref"), resume=False, **kw))
    with pytest.raises(RuntimeError, match="injected failure"):
        train(cfg, LoopConfig(ckpt_dir=str(tmp_path / "ft"), fail_at_step=9, **kw))
    hist = train(cfg, LoopConfig(ckpt_dir=str(tmp_path / "ft"), fail_at_step=9, **kw))
    assert hist[0]["step"] == 8 and hist[-1]["step"] == 11
    ref_loss = {h["step"]: h["loss"] for h in ref}
    for h in hist:
        assert abs(h["loss"] - ref_loss[h["step"]]) <= RESUME_RTOL * abs(ref_loss[h["step"]])


# -- the dry run on fake CUDA tensors (launch/dryrun.py) -----------------------------
#
# A whole model on fake CUDA tensors needs PyTorch built for CUDA (the CPU
# build's indexing asks for a CUDA device guard), so these run here;
# tests/test_torch_dryrun.py holds the rest of the dry run on the CPU.


def _dryrun_cfg():
    from repro_torch.configs import get_config, reduce_config

    return reduce_config(get_config("h2o-danube-1.8b"), d_model=128, n_heads=4)  # head dim 32


@pytest.mark.cuda
def test_dry_run_prefill_counts_flash_launches(cuda, monkeypatch):
    """A reduced h2o-danube prefill on fake CUDA tensors: one flash launch a
    layer at the band formula's FLOPs, the kernel library never loaded and
    the card's counters unchanged; the same prefill on the card launches the
    kernel as often."""
    from repro_torch.configs import ShapeCell
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model

    cfg = _dryrun_cfg()
    b, s = 2, 96

    def refuse():
        raise AssertionError("the kernel library was loaded in a dry run")

    with monkeypatch.context() as patch:
        patch.setattr(_build, "load", refuse)
        before = dict(_build.LAUNCHES)
        rec = dryrun.lower_step(cfg, ShapeCell("prefill", s, b, "prefill"), device="cuda")
        assert _build.LAUNCHES == before
    flash = rec["kernels"]["flash_attention"]
    per_layer = 4.0 * b * cfg.num_heads * cfg.head_dim * fa.band_pairs(s, s, True,
                                                                        cfg.sliding_window)
    assert flash["launches"] == cfg.num_layers
    assert flash["flops"] == cfg.num_layers * per_layer
    model = build_model(cfg, "cuda")
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32, device=cuda)
    n0 = _build.LAUNCHES["flash_attention"]
    with torch.no_grad():
        model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] - n0 == flash["launches"]


@pytest.mark.cuda
def test_dry_run_train_step_counts_the_card_step(cuda):
    """A reduced h2o-danube train step (AdamW) on fake CUDA tensors against
    the same step on the card: FLOPs equal FlopCounterMode's, argument bytes
    the trees held, and the temp peak the cost counter's reading there."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import tree
    from repro_torch.configs import ShapeCell
    from repro_torch.data import DataConfig, SyntheticTokens, to_device
    from repro_torch.launch import costs, dryrun, steps

    cfg = _dryrun_cfg()
    cell = ShapeCell("train", 64, 2, "train")
    rec = dryrun.lower_step(cfg, cell, device="cuda")

    def real():
        step, opt, model = steps.make_train_step(cfg, device="cuda")
        params = model.init(0)
        batch = to_device(SyntheticTokens(DataConfig(cfg.vocab_size, 64, 2)).batch(0), "cuda")
        return step, (params, opt.init(params, device="cuda"), batch,
                      torch.zeros((), dtype=torch.int64, device=cuda))

    step, args = real()
    with FlopCounterMode(display=False) as counter:
        step(*args)
    step, args = real()
    _, got = costs.measure(step, *args)
    held = sum(t.numel() * t.element_size() for a in args for t in tree.leaves(a))
    assert rec["hlo_flops"] == counter.get_total_flops() == got["hlo_flops"]
    assert rec["argument_size_in_bytes"] == held == got["argument_size_in_bytes"]
    assert rec["temp_size_in_bytes"] == got["temp_size_in_bytes"]
