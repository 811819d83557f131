"""The port's MLA (models/attention.py: make_mla, mla_forward, mla_decode)
and the deepseek-v2-lite model around it against the reference package, on
the CPU.

Both packages compute from the same numbers: the reference's `make_mla` /
`init_params` weights carried across by convert.py, numpy inputs. Each layer
function runs at reduce_config's MLA dims (r 32, dn 16, dr 8, dv 16) and at
the full ones (r 512, dn 128, dr 64, dv 128: a concat head dim of 192, the
flash kernel's instantiation) with d_model 256 and 2 heads. Tolerances:

  - layer functions in f32: atol 1e-5 (f32 sums in another order), as
    tests/test_torch_models.py holds them;
  - the flash plain version at D = 192 against the reference's Pallas
    kernel in interpret mode: f32 5e-6, bf16 3e-2 (tests/test_torch_flash.py);
    v's zero-padded columns come back exactly 0;
  - the latent cache written in place: the written rows within 1e-5, every
    other row bit-equal to what it held; rows past a position are masked:
    changing them changes nothing, bit for bit;
  - counts, layouts, checkpoints: equal, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduce_config as jreduce
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as jatt
from repro.models import build_model as jbuild
from repro.models import transformer as jtransformer
from repro.optim import optimizer as jopt
from repro.train import restore_checkpoint as jrestore
from repro.train import save_checkpoint as jsave
from repro_torch import tree
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import lm_caches_from_numpy, lm_params_from_numpy, opt_state_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention, build_model, counting, transformer
from repro_torch.serve.engine import _splice_cache
from repro_torch.train import restore_checkpoint, save_checkpoint

from test_torch_moe import _same_bits  # noqa: E402

torch.set_num_threads(2)

ARCH = "deepseek-v2-lite-16b"
LAYER_ATOL = 1e-5
FLASH_ATOL = {torch.float32: 5e-6, torch.bfloat16: 3e-2}
FULL_PARAMS = 15_706_482_176  # count_params of the full-width config


def _cfgs(dims="reduced", dtype="float32"):
    """(reference config, port config): reduced, or reduced to d_model 256 and
    2 heads with the full MLA dims put back."""
    out = []
    for get, reduce in ((jget, jreduce), (get_config, reduce_config)):
        full = get(ARCH)
        if dims == "full":
            cfg = dataclasses.replace(reduce(full, d_model=256, n_heads=2), mla=full.mla)
        else:
            cfg = reduce(full)
        out.append(dataclasses.replace(cfg, dtype=dtype))
    return tuple(out)


def _mla_params(dims, seed=0):
    """The reference's make_mla leaves (f32) and the port's copy of them."""
    jcfg, cfg = _cfgs(dims)
    jp = jatt.make_mla(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, cfg, jp, lm_caches_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=atol)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", ["reduced", "full"])
def test_make_mla_layout_and_scales(dims):
    """make_mla's leaves, shapes and dtypes are the reference's (w_uk and w_uv
    bare tensors, kv_norm an rmsnorm of width r), and its draws have the
    reference's scales."""
    jcfg, cfg = _cfgs(dims)
    ref = jax.eval_shape(lambda: jatt.make_mla(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    ours = attention.make_mla(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    jl = jax.tree_util.tree_leaves_with_path(ref)
    tl = jax.tree_util.tree_leaves_with_path(ours)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in tl]
    assert [(tuple(a.shape), str(a.dtype)) for _, a in jl] == [
        (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for _, t in tl]
    assert isinstance(ours["w_uk"], torch.Tensor) and isinstance(ours["w_uv"], torch.Tensor)
    assert set(ours["kv_norm"]) == {"scale"} and bool((ours["kv_norm"]["scale"] == 1).all())
    d, h, m = cfg.d_model, cfg.num_heads, cfg.mla
    r, dv = m.kv_lora_rank, m.v_head_dim
    scales = {"wq": d**-0.5, "wkv_a": d**-0.5, "w_uk": r**-0.5, "w_uv": r**-0.5,
              "wo": (h * dv) ** -0.5 / (2.0 * cfg.num_layers) ** 0.5}
    for name, scale in scales.items():
        leaf = ours[name] if isinstance(ours[name], torch.Tensor) else ours[name]["kernel"]
        assert abs(float(leaf.float().std()) / scale - 1) < 0.1, name


@pytest.mark.parametrize("dims", ["reduced", "full"])
def test_mla_forward_matches_reference(dims):
    """y and the latent cache (c_kv, k_rope) of a prefill, rows at their own
    positions per batch row."""
    jcfg, cfg, jp, p = _mla_params(dims)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    posn = np.stack([np.arange(24), np.arange(7, 31)]).astype(np.int32)
    jy, jc = jatt.mla_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(posn), return_cache=True)
    ty, tc = attention.mla_forward(p, cfg, torch.from_numpy(x), torch.from_numpy(posn),
                                   return_cache=True)
    assert set(tc) == {"c_kv", "k_rope"}
    assert tuple(tc["c_kv"].shape) == (2, 24, cfg.mla.kv_lora_rank)
    assert tuple(tc["k_rope"].shape) == (2, 24, cfg.mla.qk_rope_head_dim)
    _close(ty.numpy(), jy, LAYER_ATOL)
    for k in ("c_kv", "k_rope"):
        _close(tc[k].numpy(), jc[k], LAYER_ATOL)
    y_only = attention.mla_forward(p, cfg, torch.from_numpy(x), torch.from_numpy(posn))
    assert torch.equal(y_only, ty)


@pytest.mark.parametrize("dims", ["reduced", "full"])
def test_mla_decode_matches_reference(dims):
    """One absorbed decode step on a stale cache of capacity 40, rows at
    distinct positions (the first and the last included): y and the written
    rows against the reference's, the cache written in place at exactly
    [b, pos[b]], and the rows past each position masked."""
    jcfg, cfg, jp, p = _mla_params(dims)
    r, dr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    rng = np.random.default_rng(2)
    c = rng.standard_normal((3, 40, r)).astype(np.float32)
    kr = rng.standard_normal((3, 40, dr)).astype(np.float32)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 17, 39], np.int32)
    jy, jc = jatt.mla_decode(jp, jcfg, jnp.asarray(x),
                             {"c_kv": jnp.asarray(c), "k_rope": jnp.asarray(kr)}, jnp.asarray(pos))
    cache = {"c_kv": torch.from_numpy(c.copy()), "k_rope": torch.from_numpy(kr.copy())}
    leaves = dict(cache)
    ty, tc = attention.mla_decode(p, cfg, torch.from_numpy(x), cache, torch.from_numpy(pos))
    assert tc is cache and all(tc[k] is leaves[k] for k in leaves)  # in place
    _close(ty.numpy(), jy, LAYER_ATOL)
    written = np.zeros((3, 40), bool)
    written[np.arange(3), pos] = True
    for k, before in (("c_kv", c), ("k_rope", kr)):
        got = tc[k].numpy()
        _close(got, jc[k], LAYER_ATOL)
        assert np.array_equal(got[~written], before[~written]), k
        assert not np.array_equal(got[written], before[written]), k
    # the rows past each position are masked: other stale values, the same y
    stale = {k: v.clone() for k, v in tc.items()}
    for k in stale:
        for b, q in enumerate(pos):
            stale[k][b, q + 1:] = torch.from_numpy(
                rng.standard_normal(stale[k][b, q + 1:].shape).astype(np.float32))
    ty2, _ = attention.mla_decode(p, cfg, torch.from_numpy(x), stale, torch.from_numpy(pos))
    assert torch.equal(ty2, ty)


def test_mla_decode_writes_the_cache_dtype():
    """A bf16 cache takes the new rows cast to bf16, in place, while the
    attention itself runs in f32."""
    _, cfg, _, p = _mla_params("reduced")
    pb = tree.tree_map(lambda t: t.to(torch.bfloat16), p)
    r, dr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    cache = {"c_kv": torch.zeros(2, 8, r, dtype=torch.bfloat16),
             "k_rope": torch.zeros(2, 8, dr, dtype=torch.bfloat16)}
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator().manual_seed(0))
    y, out = attention.mla_decode(pb, cfg, x.to(torch.bfloat16), cache, torch.tensor([3, 5]))
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    assert out["c_kv"].dtype == torch.bfloat16
    assert bool(out["c_kv"][0, 3].ne(0).any()) and bool(out["c_kv"][1, 5].ne(0).any())
    assert bool(out["c_kv"][0, 4:].eq(0).all()) and bool(out["k_rope"][1, :5].eq(0).all())


# ---------------------------------------------------------------------------
# the flash kernel's contract at D = 192
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plain_at_192_matches_pallas_interpret(dtype):
    """MLA's prefill call shape: H = KVH, D = dn + dr = 192, v zero-padded
    from dv = 128; the port's plain version against the reference's Pallas
    kernel in interpret mode, the pad columns exactly 0 in both."""
    rng = np.random.default_rng(3)
    b, h, s, d, dv = 1, 2, 256, 192, 128
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    v[..., dv:] = 0.0
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pallas = np.asarray(jax_flash(*(jnp.asarray(a, jd) for a in (q, k, v)), causal=True,
                                  interpret=True), np.float32)
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    plain = fa.flash_attention_plain(t(q), t(k), t(v), causal=True)
    _close(plain.float().numpy(), pallas, FLASH_ATOL[dtype])
    assert bool(plain[..., dv:].eq(0).all()) and not pallas[..., dv:].any()
    assert 192 in fa.HEAD_DIMS and (fa.kv_tile(192), fa.ring_depth(192)) == (64, 2)
    assert fa.smem_bytes(192) == 148_480 <= fa.SMEM_LIMIT


def test_kernel_takes_a_bf16_mla_prefill_but_not_under_grad():
    q = torch.zeros(1, 5, 16, 192, dtype=torch.bfloat16)
    assert attention._kernel_takes(q, q, q, 0, None, 0.0)
    assert attention._kernel_takes(q.float(), q.float(), q.float(), 0, None, 0.0)
    w = q.clone().requires_grad_()
    assert attention._needs_grad(w, q, q)
    with torch.no_grad():
        assert not attention._needs_grad(w, q, q)


def test_mla_prefill_reaches_the_kernel_with_contiguous_operands(monkeypatch):
    """With the card's route forced on the CPU: a bf16 prefill at the full
    MLA dims hands the kernel's wrapper q, k and v of head dim 192 that are
    contiguous (no stride-0 head axis: the TMA maps need 16-byte rows), the
    padded v columns zero; under grad mode with parameters that need a
    gradient, the einsum path runs and the wrapper is not called."""
    _, cfg, _, p = _mla_params("full")
    pb = tree.tree_map(lambda t: t.to(torch.bfloat16), p)
    calls = []
    real = attention.flash_attention_bshd

    def spy(q, k, v, **kw):
        calls.append((q, k, v))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "_on_card", lambda q: True)
    monkeypatch.setattr(attention, "flash_attention_bshd", spy)
    x = torch.randn(2, 20, cfg.d_model, generator=torch.Generator().manual_seed(4))
    x = x.to(torch.bfloat16)
    posn = torch.arange(20).expand(2, 20)
    with torch.no_grad():
        y = attention.mla_forward(pb, cfg, x, posn)
    assert len(calls) == 1
    dv = cfg.mla.v_head_dim
    for t in calls[0]:
        assert t.shape[-1] == 192 and t.dtype == torch.bfloat16 and t.is_contiguous()
        assert 0 not in t.stride()
    assert bool(calls[0][2][..., dv:].eq(0).all())
    grad_p = tree.tree_map(lambda t: t.clone().requires_grad_(), pb)
    y_grad = attention.mla_forward(grad_p, cfg, x, posn)
    assert len(calls) == 1 and y_grad.requires_grad
    # the einsum path and the kernel's plain version agree within bf16 rounding
    assert float((y_grad.detach().float() - y.float()).abs().max()) <= 3e-2


# ---------------------------------------------------------------------------
# the model: caches, counts, layouts, checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def deepseek():
    jcfg, cfg = _cfgs()
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jcfg, cfg, jm, jp, lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                                    device="cpu")


def test_pad_caches_pads_the_latents(deepseek):
    """The prefix layer's latents (B, S, r) grow at axis 1 and the period
    stack's (P, B, S, r) at axis 2, with zeros, as the reference pads them."""
    jcfg, cfg, jm, jp, p = deepseek
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    _, tc = build_model(cfg, device="cpu").prefill(p, {"tokens": torch.from_numpy(toks)})
    jc, tc = jtransformer.pad_caches(jcfg, jc, 40), transformer.pad_caches(cfg, tc, 40)
    r, dr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    pre, stk = tc["prefix"][0]["self"], tc["stack"][0]["self"]
    assert tuple(pre["c_kv"].shape) == (2, 40, r) and tuple(pre["k_rope"].shape) == (2, 40, dr)
    assert tuple(stk["c_kv"].shape) == (cfg.num_periods, 2, 40, r)
    assert bool(pre["c_kv"][:, 12:].eq(0).all()) and bool(stk["k_rope"][:, :, 12:].eq(0).all())
    for a, b in zip(jax.tree.leaves(jc), tree.leaves(tc)):
        assert a.shape == tuple(b.shape)
        _close(b.numpy(), a, 1e-4)


def test_splice_cache_latents_pick_the_batch_axis():
    """The engine's splice finds axis 0 on a prefix layer's 3-d latent and
    axis 1 on the stack's 4-d one, and writes rows [0, L) of the slot only."""
    dst = {"prefix": [{"self": {"c_kv": torch.full((3, 10, 4), -1.0)}}],
           "stack": [{"self": {"c_kv": torch.full((2, 3, 10, 4), -1.0)}}]}
    src = {"prefix": [{"self": {"c_kv": torch.ones(1, 6, 4)}}],
           "stack": [{"self": {"c_kv": torch.ones(2, 1, 6, 4)}}]}
    _splice_cache(dst, src, 1)
    pre, stk = dst["prefix"][0]["self"]["c_kv"], dst["stack"][0]["self"]["c_kv"]
    assert pre[1, :6].eq(1).all() and pre[1, 6:].eq(-1).all() and pre[[0, 2]].eq(-1).all()
    assert stk[:, 1, :6].eq(1).all() and stk[:, 1, 6:].eq(-1).all()
    assert stk[:, [0, 2]].eq(-1).all()


def test_cache_specs_hold_the_latent_cache():
    """At full width, 4 slots x 4640 positions: r + dr = 576 values a token a
    layer, the prefix layer's and the 26 periods' together 0.577 GB in bf16."""
    cfg = get_config(ARCH)
    spec = build_model(cfg, device="cpu").cache_specs(4, 4640)
    assert {k: tuple(s.shape) for k, s in spec["prefix"][0]["self"].items()} == {
        "c_kv": (4, 4640, 512), "k_rope": (4, 4640, 64)}
    assert tuple(spec["stack"][0]["self"]["c_kv"].shape) == (26, 4, 4640, 512)
    nbytes = sum(int(np.prod(s.shape)) * 2 for s in tree.leaves(spec))
    assert nbytes == 27 * 4 * 4640 * 576 * 2 and round(nbytes / 1e9, 3) == 0.577


def test_count_params_matches_the_init_and_the_template():
    """counting.py's MLA count is make_mla's, leaf for leaf; the reduced model
    within the reference's 2 %; the full-width template holds the reference's
    init leaf for leaf, the count within one norm of it."""
    _, cfg = _cfgs()
    p = attention.make_mla(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert sum(t.numel() for t in tree.leaves(p)) == counting._mla_params(cfg)
    actual = sum(t.numel() for t in tree.leaves(build_model(cfg, device="cpu").init(0)))
    analytic = counting.count_params(cfg)
    assert abs(actual - analytic) / actual < 0.02, (actual, analytic)
    full = transformer.param_template(get_config(ARCH))
    n = sum(t.numel() for t in tree.leaves(full))
    ref = jax.eval_shape(lambda: jtransformer.init_params(jax.random.PRNGKey(0), jget(ARCH)))
    assert n == sum(a.size for a in jax.tree.leaves(ref))
    # count_params leaves out the final norm (d_model), as the reference's does
    assert counting.count_params(get_config(ARCH)) == FULL_PARAMS == n - get_config(ARCH).d_model
    assert tuple(full["stack"][0]["mixer"]["w_uk"].shape) == (26, 512, 16, 128)
    assert tuple(full["prefix"][0]["mixer"]["wq"]["kernel"].shape) == (2048, 3072)


@pytest.fixture(scope="module")
def bf16_deepseek():
    """Reduced deepseek in bf16 and a nonzero AdamW state, in both packages'
    trees (the same numbers)."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    js = jax.tree.map(lambda a: a + 0.5, jopt.make_adamw().init(jp))
    return (cfg, jp, js, lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu"),
            opt_state_from_numpy("adamw", jax.tree.map(np.asarray, js), device="cpu"))


def test_reference_checkpoint_restores_in_the_port(bf16_deepseek, tmp_path):
    cfg, jp, js, _, s = bf16_deepseek
    jsave(tmp_path, 3, jp, js)
    p2, s2, _, step = restore_checkpoint(tmp_path, None, transformer.param_template(cfg), s,
                                         device="cpu")
    assert step == 3
    _same_bits({"p": p2, "s": s2}, {"p": jp, "s": js})
    assert set(p2["prefix"][0]["mixer"]) == {"wq", "wkv_a", "kv_norm", "w_uk", "w_uv", "wo"}


def test_port_checkpoint_restores_in_the_reference(bf16_deepseek, tmp_path):
    cfg, jp, js, p, s = bf16_deepseek
    save_checkpoint(tmp_path, 3, p, s)
    jp2, js2, _, step = jrestore(tmp_path, None, jp, js)
    assert step == 3
    _same_bits({"p": p, "s": s}, {"p": jp2, "s": js2})
