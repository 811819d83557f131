"""The port's LM substrate (configs, layers, attention, transformer,
counting, Model) against the reference package.

Both packages compute from the same numbers: the reference's
`init_params(PRNGKey(0), cfg)` with every leaf `np.asarray`'d, carried
across by `convert.lm_params_from_numpy`; inputs are numpy draws. Configs
are reduced (d_model 64, one period, f32): h2o-danube (SWA, window 16),
phi4-mini, gemma-7b (geglu, embed_scale, tied head), command-r-plus
(layernorm, parallel block), a GQA variant of h2o-danube with 2 kv heads
(reduce_config collapses GQA to MHA), and qwen2-moe (MoE layers, q/k/v
biases) and deepseek-v2-lite (MLA mixers, a dense prefix layer with its own
latent cache, then MoE periods), each at reduce_config's dropless capacity
and, as "+cap", at its published capacity factor 1.25, where decode rows
compete for an expert's slots, and the recurrent archs: jamba (Mamba layers
around one attention layer, MoE on every second layer) and xlstm-125m (three
mLSTM blocks and an sLSTM block, no MLP), and the archs with other inputs:
whisper-base (2 encoder layers, one decoder layer with cross-attention;
its batches carry encoder frames, 0.02 x normal) and llava-next-mistral-7b
(embedding input, served here on tokens as the reference's Engine serves it;
tests/test_torch_encdec.py holds its inputs_embeds). The qwen2-moe variants draw their q/k/v biases from a seed (the
reference's init leaves them zero), so the bias path is held too. Prompts
are longer than the window and decode runs past it, so the band bites.

Tolerance: logits and caches atol 1e-4 (f32 on both sides, sums in another
order; TF32 plays no part on the CPU). Layer functions atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.configs import reduce_config as jax_reduce
from repro.models import build_model as jax_build_model
from repro.models import counting as jax_counting
from repro.models import layers as jax_layers
from repro.models import attention as jax_attention
from repro.models import transformer as jax_transformer
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.models.model import make_input_specs as jax_input_specs
from repro_torch.configs import SHAPES, get_config, list_configs, reduce_config
from repro_torch.convert import lm_caches_from_numpy, lm_params_from_numpy
from repro_torch.models import attention, build_model, counting, layers, transformer
from repro_torch.models.model import make_input_specs

LOGIT_ATOL = 1e-4
LAYER_ATOL = 1e-5
DENSE_ARCHS = ["h2o-danube-1.8b", "phi4-mini-3.8b", "gemma-7b", "command-r-plus-104b"]
INPUT_ARCHS = ["whisper-base", "llava-next-mistral-7b"]  # encoder frames; embedding input
MOE_VARIANTS = ["qwen2-moe-a2.7b", "qwen2-moe-a2.7b+cap"]
MLA_VARIANTS = ["deepseek-v2-lite-16b", "deepseek-v2-lite-16b+cap"]
RECURRENT_ARCHS = ["jamba-1.5-large-398b", "xlstm-125m"]
VARIANTS = (DENSE_ARCHS + ["h2o-danube-1.8b+gqa"] + MOE_VARIANTS + MLA_VARIANTS
            + RECURRENT_ARCHS + INPUT_ARCHS)


def _cfgs(variant):
    """(reference config, port config) for a reduced variant: "+gqa" 2 kv
    heads, "+cap" the MoE's published capacity factor (1.25)."""
    arch, _, extra = variant.partition("+")
    jcfg, cfg = jax_reduce(jax_get_config(arch)), reduce_config(get_config(arch))
    if extra == "gqa":
        jcfg = dataclasses.replace(jcfg, num_kv_heads=2)
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    if extra == "cap":
        cf = jax_get_config(arch).moe.capacity_factor
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return jcfg, cfg


def with_qkv_biases(jcfg, jp, seed=0):
    """The reference's params with every q/k/v bias drawn from `seed` (its
    init leaves them zero); unchanged for a config without them."""
    if not jcfg.qkv_bias:
        return jp
    rng = np.random.default_rng(seed)
    stack = []
    for layer in jp["stack"]:
        mixer = dict(layer["mixer"])
        for w in ("wq", "wk", "wv"):
            b = mixer[w]["bias"]
            draw = 0.5 * rng.standard_normal(b.shape).astype(np.float32)
            mixer[w] = dict(mixer[w], bias=jnp.asarray(draw).astype(b.dtype))
        stack.append(dict(layer, mixer=mixer))
    return dict(jp, stack=stack)


@pytest.fixture(scope="module", params=VARIANTS)
def pair(request):
    """Reference and port models with the same weights."""
    jcfg, cfg = _cfgs(request.param)
    jm = jax_build_model(jcfg)
    jp = with_qkv_biases(jcfg, jm.init(jax.random.PRNGKey(0)))
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, jp=jp, m=build_model(cfg, device="cpu"), p=params,
                jdecode=jax.jit(jm.decode_step))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _batches(cfg, toks, seed=0):
    """(reference batch, port batch) of `toks`; an encoder-decoder arch's
    also carries 16 encoder frames a row, 0.02 x normal."""
    batch = {"tokens": toks}
    if cfg.encoder_layers:
        frames = 0.02 * np.random.default_rng(seed).standard_normal((len(toks), 16, cfg.d_model))
        batch["encoder_frames"] = frames.astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=atol)


def _cache_close(jc, tc, atol):
    leaves_j, leaves_t = jax.tree.leaves(jc), jax.tree.leaves(
        transformer.tree_map(lambda t: t.numpy(), tc)
    )
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_j, leaves_t):
        assert a.shape == b.shape
        _close(a, b, atol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_registry_names_match():
    assert list_configs() == jax_list_configs()


@pytest.mark.parametrize("arch", jax_list_configs())
def test_configs_match(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(reduce_config(get_config(arch))) == dataclasses.asdict(
        jax_reduce(jax_get_config(arch))
    )
    assert {s: dataclasses.asdict(c) for s, c in SHAPES.items()} == {
        s: dataclasses.asdict(c) for s, c in JAX_SHAPES.items()
    }


@pytest.mark.parametrize("arch", jax_list_configs())
def test_count_params_matches(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert counting.count_params(cfg) == jax_counting.count_params(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert counting.count_params(cfg, active_only=True) == jax_counting.count_params(
        jcfg, active_only=True
    )
    assert counting.decode_step_flops(cfg, 4, 4640) == jax_counting.decode_step_flops(jcfg, 4, 4640)
    assert counting.train_step_flops(cfg, 8, 4096) == jax_counting.train_step_flops(jcfg, 8, 4096)


@pytest.mark.parametrize("variant", VARIANTS)
def test_reduced_count_params_matches(variant):
    """count_params of each reduced variant, and the number of values its
    init draws, against the reference's."""
    jcfg, cfg = _cfgs(variant)
    assert counting.count_params(cfg) == jax_counting.count_params(jcfg)
    assert counting.count_params(cfg, active_only=True) == jax_counting.count_params(
        jcfg, active_only=True)
    ref = jax.eval_shape(lambda: jax_transformer.init_params(jax.random.PRNGKey(0), jcfg))
    ours = transformer.param_template(cfg)
    assert sum(t.numel() for t in jax.tree.leaves(ours)) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(ref))


def test_build_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(reduce_config(get_config("h2o-danube-1.8b")))


def test_h2o_danube_full_width():
    cfg = get_config("h2o-danube-1.8b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (
        24, 2560, 32, 8, 80
    )
    assert (cfg.d_ff, cfg.sliding_window, cfg.vocab_size, cfg.dtype) == (
        6912, 4096, 32000, "bfloat16"
    )
    assert 1.8e9 < counting.count_params(cfg) < 1.9e9


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_apply_norm(norm_type):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32)}
    if norm_type == "layernorm":
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    ref = jax_layers.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    out = layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    _close(out.numpy(), ref, LAYER_ATOL)


def test_apply_norm_casts_back():
    x = torch.randn(3, 16, dtype=torch.bfloat16)
    out = layers.apply_norm({"scale": torch.ones(16, dtype=torch.bfloat16)}, x)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu"])
def test_apply_mlp(mlp_type):
    rng = np.random.default_rng(1)
    jp = jax_layers.make_mlp(jax.random.PRNGKey(0), 32, 64, mlp_type, jnp.float32, bias=True)
    jp = jax.tree.map(lambda a: a + 0.1, jp)  # nonzero biases
    tp = lm_caches_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    _close(layers.apply_mlp(tp, torch.from_numpy(x), mlp_type).numpy(),
           jax_layers.apply_mlp(jp, jnp.asarray(x), mlp_type), LAYER_ATOL)


def test_rope():
    """Half-split rotation (the reference's code, not its docstring)."""
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 3, 80)).astype(np.float32)
    ja = jax_layers.rope_freqs(jnp.asarray(pos), 80, 10_000.0)
    ta = layers.rope_freqs(torch.from_numpy(pos), 80, 10_000.0)
    _close(ta.numpy(), ja, 1e-3)  # angles up to 5e3 rad: f32 ulp ~5e-4
    # rotate with the reference's angles so only the rotation is compared
    out = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(ja)))
    _close(out.numpy(), jax_layers.apply_rope(jnp.asarray(x), ja), LAYER_ATOL)


@pytest.mark.parametrize("scale", [False, True])
def test_embed_and_logits(scale):
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((128, 16)).astype(np.float32)
    toks = rng.integers(0, 128, (2, 5)).astype(np.int32)
    je = jax_layers.embed_tokens({"embed": jnp.asarray(emb)}, jnp.asarray(toks), scale=scale)
    te = layers.embed_tokens({"embed": torch.from_numpy(emb)}, torch.from_numpy(toks).long(),
                             scale=scale)
    _close(te.numpy(), je, LAYER_ATOL)
    head = rng.standard_normal((16, 128)).astype(np.float32)
    _close(layers.lm_logits({"kernel": torch.from_numpy(head)}, te).numpy(),
           jax_layers.lm_logits({"kernel": jnp.asarray(head)}, je), LAYER_ATOL)
    _close(layers.lm_logits(None, te, tied_embed={"embed": torch.from_numpy(emb)}).numpy(),
           jax_layers.lm_logits(None, je, tied_embed={"embed": jnp.asarray(emb)}), LAYER_ATOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kvh", [4, 2, 1])
@pytest.mark.parametrize("window", [0, 16])
def test_grouped_attend_prefill_and_decode(kvh, window):
    """q_offset 0 (prefill) and per-row q_offset / kv_len (decode against
    a cache with stale rows past kv_len)."""
    rng = np.random.default_rng(4)
    b, s, h, d = 2, 30, 4, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    out = attention.grouped_attend(t(q), t(k), t(v), causal=True, window=window, q_offset=0)
    ref = jax_attention.grouped_attend(j(q), j(k), j(v), causal=True, window=window, q_offset=0)
    _close(out.numpy(), ref, LAYER_ATOL)
    pos = np.array([25, 9], np.int32)
    out = attention.grouped_attend(t(q[:, :1]), t(k), t(v), causal=True, window=window,
                                   q_offset=t(pos), kv_len=t(pos) + 1)
    ref = jax_attention.grouped_attend(j(q[:, :1]), j(k), j(v), causal=True, window=window,
                                       q_offset=j(pos), kv_len=j(pos) + 1)
    _close(out.numpy(), ref, LAYER_ATOL)


def test_attn_forward_and_decode(pair):
    """The first period's first mixer of its kind: attn_forward / attn_decode
    (jamba: its attention layer), for an MLA config mla_forward / mla_decode
    over its latent cache, for xlstm the first mLSTM block's forward and
    decode (tests/test_torch_recurrent.py holds every recurrent function)."""
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    kinds = [spec.mixer for spec in cfg.period]
    i = kinds.index("attn") if "attn" in kinds else 0
    lp_j = jax.tree.map(lambda a: a[0], pair["jp"]["stack"][i]["mixer"])
    lp_t = transformer.tree_map(lambda t: t[0], pair["p"]["stack"][i]["mixer"])
    window = cfg.sliding_window
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    posn = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    if cfg.mla is not None:
        _mla_forward_and_decode(cfg, jcfg, lp_t, lp_j, rng, x, posn)
        return
    if kinds[i] == "mlstm":
        _mlstm_forward_and_decode(cfg, jcfg, lp_t, lp_j, x)
        return
    jy, jc = jax_attention.attn_forward(lp_j, jcfg, jnp.asarray(x), jnp.asarray(posn),
                                        window=window, return_cache=True)
    ty, tc = attention.attn_forward(lp_t, cfg, torch.from_numpy(x), torch.from_numpy(posn),
                                    window=window, return_cache=True)
    _close(ty.numpy(), jy, LOGIT_ATOL)
    _cache_close(jc, tc, LOGIT_ATOL)
    # one decode step on a cache of capacity 32, rows past each pos stale
    cache = rng.standard_normal((2, 32, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([20, 31], np.int32)
    jy, jc = jax_attention.attn_decode(lp_j, jcfg, jnp.asarray(xd),
                                       {"k": jnp.asarray(cache), "v": jnp.asarray(-cache)},
                                       jnp.asarray(pos), window=window)
    tcache = {"k": torch.from_numpy(cache.copy()), "v": torch.from_numpy(-cache)}
    ty, tc = attention.attn_decode(lp_t, cfg, torch.from_numpy(xd), tcache,
                                   torch.from_numpy(pos), window=window)
    assert tc is tcache  # in place
    _close(ty.numpy(), jy, LOGIT_ATOL)
    _cache_close(jc, tc, LOGIT_ATOL)


def _mlstm_forward_and_decode(cfg, jcfg, lp_t, lp_j, x):
    from repro.models import xlstm as jax_xlstm
    from repro_torch.models import xlstm

    jy, jc = jax_xlstm.mlstm_forward(lp_j, jcfg, jnp.asarray(x), return_cache=True)
    ty, tc = xlstm.mlstm_forward(lp_t, cfg, torch.from_numpy(x), return_cache=True)
    _close(ty.numpy(), jy, LOGIT_ATOL)
    _cache_close(jc, tc, LOGIT_ATOL)
    xd = x[:, :1] + 1.0
    jy, jc = jax_xlstm.mlstm_decode(lp_j, jcfg, jnp.asarray(xd), jc)
    ty, out = xlstm.mlstm_decode(lp_t, cfg, torch.from_numpy(xd), tc)
    assert out is tc  # in place
    _close(ty.numpy(), jy, LOGIT_ATOL)
    _cache_close(jc, tc, LOGIT_ATOL)


def _mla_forward_and_decode(cfg, jcfg, lp_t, lp_j, rng, x, posn):
    jy, jc = jax_attention.mla_forward(lp_j, jcfg, jnp.asarray(x), jnp.asarray(posn),
                                       return_cache=True)
    ty, tc = attention.mla_forward(lp_t, cfg, torch.from_numpy(x), torch.from_numpy(posn),
                                   return_cache=True)
    _close(ty.numpy(), jy, LOGIT_ATOL)
    _cache_close(jc, tc, LOGIT_ATOL)
    # one decode step on a latent cache of capacity 32, rows past each pos stale
    r, dr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    c = rng.standard_normal((2, 32, r)).astype(np.float32)
    kr = rng.standard_normal((2, 32, dr)).astype(np.float32)
    xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([20, 31], np.int32)
    jy, jc = jax_attention.mla_decode(lp_j, jcfg, jnp.asarray(xd),
                                      {"c_kv": jnp.asarray(c), "k_rope": jnp.asarray(kr)},
                                      jnp.asarray(pos))
    tcache = {"c_kv": torch.from_numpy(c.copy()), "k_rope": torch.from_numpy(kr.copy())}
    ty, tc = attention.mla_decode(lp_t, cfg, torch.from_numpy(xd), tcache, torch.from_numpy(pos))
    assert tc is tcache  # in place
    _close(ty.numpy(), jy, LOGIT_ATOL)
    _cache_close(jc, tc, LOGIT_ATOL)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


def test_forward_logits_train(pair):
    jb, tb = _batches(pair["cfg"], _tokens(pair["cfg"], 2, 24))
    jl, _, _ = jax_transformer.forward_logits(pair["jp"], pair["jcfg"], jb)
    tl = pair["m"].forward(pair["p"], tb)
    assert tl.shape == (2, 24, pair["cfg"].padded_vocab) and tl.dtype == torch.float32
    _close(tl.numpy(), jl, LOGIT_ATOL)


def test_prefill_then_decode(pair):
    """prefill (last logits and caches), pad_caches, then 12 decode steps
    from the one cache, rows at different positions, past the window."""
    cfg, jcfg, jm, m = pair["cfg"], pair["jcfg"], pair["jm"], pair["m"]
    jb, tb = _batches(cfg, _tokens(cfg, 2, 24, seed=1), seed=1)
    jl, jc = jm.prefill(pair["jp"], jb)
    tl, tc = m.prefill(pair["p"], tb)
    _close(tl.numpy(), jl, LOGIT_ATOL)
    _cache_close(jc, tc, LOGIT_ATOL)
    jc = jax_transformer.pad_caches(jcfg, jc, 40)
    tc = transformer.pad_caches(cfg, tc, 40)
    _cache_close(jc, tc, LOGIT_ATOL)
    # from here on both decode from the reference's cache
    tc = lm_caches_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    tok = np.array([[3], [5]], np.int32)
    for step in range(12):
        pos = np.array([24 + step, 18 + step], np.int32)
        jl, jc = pair["jdecode"](pair["jp"], jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, tc = m.decode_step(pair["p"], torch.from_numpy(tok), tc, torch.from_numpy(pos))
        _close(tl.numpy(), jl, LOGIT_ATOL)
        tok = np.asarray(jnp.argmax(jl[:, -1, : cfg.vocab_size], -1)).astype(np.int32)[:, None]
    _cache_close(jc, tc, LOGIT_ATOL)


def test_cache_and_input_specs():
    """Shapes and dtypes of the cache specs (bf16 k / v and latents; the
    recurrent mixers' f32 states and bf16 conv tails) and of the input specs,
    against the reference's."""
    for arch in DENSE_ARCHS + ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"] + RECURRENT_ARCHS + \
            INPUT_ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        ours = transformer.cache_specs(cfg, 4, 4640)
        ref = jax_transformer.cache_specs(jcfg, 4, 4640)
        shapes = lambda tree: [tuple(s.shape) for s in jax.tree.leaves(  # noqa: E731
            tree, is_leaf=lambda x: hasattr(x, "shape"))]
        assert shapes(ours) == shapes(ref)
        dtypes = [str(s.dtype).split(".")[1] for s in jax.tree.leaves(
            ours, is_leaf=lambda x: isinstance(x, transformer.TensorSpec))]
        assert dtypes == [str(s.dtype) for s in jax.tree.leaves(ref)]
        assert "bfloat16" in dtypes
        for cell in ("prefill_32k", "decode_32k"):
            assert shapes(make_input_specs(cfg, SHAPES[cell])) == shapes(
                jax_input_specs(jcfg, JAX_SHAPES[cell])
            )


def test_init_params_layout_matches_reference():
    """The port's own init draws a tree with the reference's leaf paths,
    shapes (period stack included) and dtypes, on the generator's device."""
    for variant in VARIANTS:
        jcfg, cfg = _cfgs(variant)
        ref = jax.eval_shape(lambda: jax_transformer.init_params(jax.random.PRNGKey(0), jcfg))
        ours = transformer.init_params(cfg, torch.Generator().manual_seed(0))
        jl = jax.tree_util.tree_leaves_with_path(ref)
        tl = jax.tree_util.tree_leaves_with_path(ours)
        assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in tl]
        assert [tuple(a.shape) for _, a in jl] == [tuple(t.shape) for _, t in tl]
        assert all(t.dtype == torch.float32 for _, t in tl)
    cfg = dataclasses.replace(reduce_config(get_config("h2o-danube-1.8b")), dtype="bfloat16")
    bf16 = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(bf16))


def test_bf16_leaves_carry_across_bit_for_bit():
    """The reference's bf16 leaves reach numpy as ml_dtypes bfloat16."""
    leaf = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (3, 5), jnp.bfloat16))
    out = lm_caches_from_numpy({"stack": [{"self": {"k": leaf}}]}, device="cpu")
    t = out["stack"][0]["self"]["k"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(), leaf.view(np.int16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 80, 256])
def test_flash_routing_by_head_dim_and_dtype(d, dtype, monkeypatch):
    """grouped_attend sends a call to the flash kernel only when its head dim
    is one the kernel was built for (16, the reduced configs', is not) and
    its dtype one the kernel takes; the predicate is the contract with the
    device aside, and on the CPU no call reaches the kernel."""
    q = torch.zeros(1, 5, 4, d, dtype=dtype)
    k = v = torch.zeros(1, 5, 2, d, dtype=dtype)
    takes = attention._kernel_takes(q, k, v, None, None, 0.0)
    assert takes == (d in (80, 256))
    assert not attention._kernel_takes(q.half(), k.half(), v.half(), None, None, 0.0)
    assert not attention._kernel_takes(q, k.float() if dtype != torch.float32 else k.bfloat16(),
                                       v, None, None, 0.0)
    assert not attention._kernel_takes(q, k, v, None, 5, 0.0)  # kv_len: decode
    assert not attention._kernel_takes(q, k, v, None, None, 30.0)  # softcap
    assert attention._kernel_takes(q, k, v, 0, None, 0.0) == takes  # q_offset Sk - Sq

    def refuse(*args, **kw):
        raise AssertionError("a CPU call reached the flash kernel")

    monkeypatch.setattr(attention, "flash_attention_bshd", refuse)
    out = attention.grouped_attend(q.float(), k.float(), v.float(), causal=True)
    assert out.shape == q.shape
