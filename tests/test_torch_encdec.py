"""The port's encoder-decoder and embedding-input paths against the reference:
whisper's encoder, cross-attention and learned decoder positions, and
llava's inputs_embeds.

Both packages compute from the same numbers: the reference's
`init_params(PRNGKey(0), cfg)` with every leaf `np.asarray`'d, carried across
by `convert.lm_params_from_numpy` (the encoder's layers, each decoder
layer's cross block and dec_pos leaf for leaf); inputs are numpy draws.
Configs are reduced (d_model 64, f32): whisper with 2 encoder layers, one
decoder layer and a 64-row position table; llava with one period. Encoder
frames are 0.02 x normal, as the reference's concrete_batch draws them.

Tolerances, as tests/test_torch_models.py states them: logits and caches
atol 1e-4 (f32 on both sides, sums in another order), layer functions atol
1e-5; loss and gradient leaves within GRAD_RTOL 1e-5 of the reference's,
relative to each leaf's largest magnitude (tests/test_torch_train.py).
The sinusoidal table at 1500 rows: angles up to 1.5e3 rad, where an f32
ulp is 1.2e-4, so one ulp of angle moves sin / cos by as much (atol 2e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import reduce_config as jreduce
from repro.launch import steps as jsteps
from repro.models import attention as jattention
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.model import make_input_specs as jinput_specs
from repro_torch import tree
from repro_torch.configs import SHAPES, get_config, reduce_config
from repro_torch.convert import lm_caches_from_numpy, lm_params_from_numpy
from repro_torch.launch import steps
from repro_torch.models import attention, build_model, layers, transformer
from repro_torch.models.model import concrete_batch, make_input_specs

torch.set_num_threads(2)

LOGIT_ATOL = 1e-4
LAYER_ATOL = 1e-5
GRAD_RTOL = 1e-5
SINUSOID_ATOL = 2e-4
WHISPER, LLAVA = "whisper-base", "llava-next-mistral-7b"
ARCHS = [WHISPER, LLAVA]
B, T, T0, SE = 2, 24, 20, 16  # batch, tokens, prompt, encoder frames


def _cfgs(arch, **kw):
    """(reference config, port config), reduced (f32)."""
    return (dataclasses.replace(jreduce(jget(arch)), **kw),
            dataclasses.replace(reduce_config(get_config(arch)), **kw))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Reference and port models with the same weights."""
    jcfg, cfg = _cfgs(request.param)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    p = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return dict(jcfg=jcfg, cfg=cfg, jm=jm, jp=jp, m=build_model(cfg, device="cpu"), p=p,
                jdecode=jax.jit(jm.decode_step))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=atol)


def _cache_close(jc, tc, atol):
    leaves_j = jax.tree.leaves(jc)
    leaves_t = tree.leaves(transformer.tree_map(lambda t: t.numpy(), tc))
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_j, leaves_t):
        assert a.shape == b.shape
        _close(a, b, atol)


def _rel(a, b):
    a = np.asarray(a.detach().float().numpy() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _inputs(cfg, p, tokens, seed=0):
    """The model inputs of `tokens` (B, S) as numpy: whisper's encoder
    frames (B, SE, d) beside the tokens; llava's inputs_embeds, the tokens'
    embedding rows (the port's table: the reference's, carried across)."""
    if cfg.encoder_layers:
        frames = 0.02 * np.random.default_rng(seed).standard_normal((tokens.shape[0], SE,
                                                                    cfg.d_model))
        return {"encoder_frames": frames.astype(np.float32), "tokens": tokens}
    return {"inputs_embeds": p["embed"]["embed"][torch.from_numpy(tokens).long()].numpy()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,d", [(16, 64), (7, 10), (1500, 512)])
def test_sinusoidal_positions(seq, d):
    out = layers.sinusoidal_positions(seq, d)
    assert out.dtype == torch.float32 and out.shape == (seq, d)
    _close(out.numpy(), jlayers.sinusoidal_positions(seq, d), SINUSOID_ATOL)


def test_encode_matches_reference():
    jcfg, cfg = _cfgs(WHISPER)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    p = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    assert len(p["encoder"]["layers"]) == cfg.encoder_layers == 2
    frames = _inputs(cfg, p, _tokens(cfg, B, 4))["encoder_frames"]
    ours = transformer.encode(p, cfg, torch.from_numpy(frames))
    ref = jtransformer.encode(jp, jcfg, jnp.asarray(frames))
    assert ours.shape == (B, SE, cfg.d_model)
    _close(ours.numpy(), ref, LAYER_ATOL)


def test_cross_attention_forward_and_decode():
    """attn_forward(kv_x=...): k / v from the encoder output, no RoPE (on a
    rope config too: llava's attention params with kv_x), no mask; its
    cache is kv_x's k / v. attn_decode(cross=True) attends to the whole
    static cache, writes nothing and returns the same cache."""
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
        lp_j = jax.tree.map(lambda a: a[0], jp["stack"][0]["cross" if arch == WHISPER else "mixer"])
        lp_t = lm_caches_from_numpy(jax.tree.map(np.asarray, lp_j), device="cpu")
        rng = np.random.default_rng(1)
        x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
        enc = rng.standard_normal((B, SE, cfg.d_model)).astype(np.float32)
        posn = np.tile(np.arange(5, dtype=np.int32), (B, 1))
        jy, jc = jattention.attn_forward(lp_j, jcfg, jnp.asarray(x), jnp.asarray(posn),
                                         causal=False, kv_x=jnp.asarray(enc), return_cache=True)
        ty, tc = attention.attn_forward(lp_t, cfg, torch.from_numpy(x), torch.from_numpy(posn),
                                        causal=False, kv_x=torch.from_numpy(enc),
                                        return_cache=True)
        _close(ty.numpy(), jy, LAYER_ATOL)
        _cache_close(jc, tc, LAYER_ATOL)
        assert tc["k"].shape == (B, SE, cfg.num_kv_heads, cfg.head_dim)
        xd = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        pos = np.array([5, 3], np.int32)
        jy, jc2 = jattention.attn_decode(lp_j, jcfg, jnp.asarray(xd), jc, jnp.asarray(pos),
                                         cross=True)
        before = {k: v.clone() for k, v in tc.items()}
        ty, tc2 = attention.attn_decode(lp_t, cfg, torch.from_numpy(xd), tc,
                                        torch.from_numpy(pos), cross=True)
        assert tc2 is tc and all(torch.equal(tc[k], before[k]) for k in tc)
        _close(ty.numpy(), jy, LAYER_ATOL)


def test_cross_prefill_routes_to_the_kernel_contract(monkeypatch):
    """A cross-attention prefill (q_offset 0, Sq != Sk, no causal mask, no
    window) and a cross decode (Sq = 1) are inside the flash kernel's
    contract; a causal or windowed call with another alignment is not. On
    the CPU none reaches the kernel."""
    q = torch.zeros(2, 5, 8, 64)
    k = v = torch.zeros(2, 1500, 8, 64)
    assert attention._kernel_takes(q, k, v, 0, None, 0.0, causal=False, window=0)
    assert attention._kernel_takes(q[:, :1], k, v, None, None, 0.0, causal=False)
    assert not attention._kernel_takes(q, k, v, 0, None, 0.0, causal=True, window=0)
    assert not attention._kernel_takes(q, k, v, 0, None, 0.0, causal=False, window=16)
    assert attention._kernel_takes(q, k, v, 1495, None, 0.0, causal=True, window=16)
    assert not attention._kernel_takes(q, k, v, torch.zeros(2, dtype=torch.long), None, 0.0,
                                       causal=False)

    def refuse(*args, **kw):
        raise AssertionError("a CPU call reached the flash kernel")

    monkeypatch.setattr(attention, "flash_attention_bshd", refuse)
    out = attention.grouped_attend(q, k, v, causal=False, q_offset=0)
    assert out.shape == q.shape


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


def test_forward_logits_train(pair):
    cfg = pair["cfg"]
    batch = _inputs(cfg, pair["p"], _tokens(cfg, B, T))
    jl, _, _ = jtransformer.forward_logits(pair["jp"], pair["jcfg"], _j(batch))
    tl = pair["m"].forward(pair["p"], _t(batch))
    assert tl.shape == (B, T, cfg.padded_vocab) and tl.dtype == torch.float32
    _close(tl.numpy(), jl, LOGIT_ATOL)


def test_prefill_then_decode(pair):
    """prefill (last logits, the self caches and whisper's cross caches),
    pad_caches (the cross cache passed through as it is), then 12 decode
    steps, rows at different positions."""
    cfg, jcfg, jm, m = pair["cfg"], pair["jcfg"], pair["jm"], pair["m"]
    batch = _inputs(cfg, pair["p"], _tokens(cfg, B, T, seed=1))
    jl, jc = jm.prefill(pair["jp"], _j(batch))
    tl, tc = m.prefill(pair["p"], _t(batch))
    _close(tl.numpy(), jl, LOGIT_ATOL)
    _cache_close(jc, tc, LOGIT_ATOL)
    if cfg.encoder_layers:
        assert tc["stack"][0]["cross"]["k"].shape == (1, B, SE, cfg.num_kv_heads, cfg.head_dim)
    jc = jtransformer.pad_caches(jcfg, jc, 40)
    padded = transformer.pad_caches(cfg, tc, 40)
    _cache_close(jc, padded, LOGIT_ATOL)
    if cfg.encoder_layers:
        assert padded["stack"][0]["cross"] is tc["stack"][0]["cross"]
    tc = lm_caches_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    tok = np.array([[3], [5]], np.int32)
    for step in range(12):
        pos = np.array([T + step, 18 + step], np.int32)
        jl, jc = pair["jdecode"](pair["jp"], jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, tc = m.decode_step(pair["p"], torch.from_numpy(tok), tc, torch.from_numpy(pos))
        _close(tl.numpy(), jl, LOGIT_ATOL)
        tok = np.asarray(jnp.argmax(jl[:, -1, : cfg.vocab_size], -1)).astype(np.int32)[:, None]
    _cache_close(jc, tc, LOGIT_ATOL)


def test_prefill_then_decode_matches_the_forward(pair):
    """tests/test_archs_smoke.py's pattern: prefill the first T0 inputs
    (llava: inputs_embeds, decode then embeds tokens; whisper: the frames
    and T0 tokens), decode tokens T0 ... T - 1, each step's logits against
    the full forward's at that position, in both packages."""
    cfg, jcfg, jm, m, p = pair["cfg"], pair["jcfg"], pair["jm"], pair["m"], pair["p"]
    tokens = _tokens(cfg, B, T, seed=3)
    batch = _inputs(cfg, p, tokens)
    full = m.forward(p, _t(batch))
    pre = dict(batch)
    key = "tokens" if cfg.encoder_layers else "inputs_embeds"
    pre[key] = batch[key][:, :T0]
    jlast, jc = jm.prefill(pair["jp"], _j(pre))
    last, tc = m.prefill(p, _t(pre))
    _close(last[:, 0].numpy(), full[:, T0 - 1].numpy(), LOGIT_ATOL)
    _close(last.numpy(), jlast, LOGIT_ATOL)
    jc = jtransformer.pad_caches(jcfg, jc, T)
    tc = transformer.pad_caches(cfg, tc, T)
    for i in range(T0, T):
        tok = tokens[:, i:i + 1]
        pos = np.full((B,), i, np.int32)
        jl, jc = pair["jdecode"](pair["jp"], jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, tc = m.decode_step(p, torch.from_numpy(tok), tc, torch.from_numpy(pos))
        _close(tl[:, 0].numpy(), full[:, i].numpy(), LOGIT_ATOL)
        _close(tl.numpy(), jl, LOGIT_ATOL)


def test_inputs_embeds_path_is_the_token_path():
    """llava: a prefill from embed_tokens(tokens) is the token prefill bit
    for bit (logits and caches): the embeddings are the same rows."""
    _, cfg = _cfgs(LLAVA)
    m = build_model(cfg, device="cpu")
    p = m.init(0)
    tokens = torch.from_numpy(_tokens(cfg, B, T))
    a = m.prefill(p, {"tokens": tokens})
    b = m.prefill(p, {"inputs_embeds": layers.embed_tokens(p["embed"], tokens.long())})
    leaves_a, leaves_b = tree.leaves(list(a)), tree.leaves(list(b))
    assert len(leaves_a) == len(leaves_b) == 3
    for x, y in zip(leaves_a, leaves_b):
        assert torch.equal(x, y)


def test_sinusoidal_embedding_input_without_an_encoder():
    """An embedding-input arch with sinusoidal positions and no encoder (no
    registered config is one; the reference's _embed_inputs adds the table)."""
    jcfg, cfg = _cfgs(LLAVA, pos_type="sinusoidal")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    p = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    batch = _inputs(cfg, p, _tokens(cfg, B, T))
    jl, _, _ = jtransformer.forward_logits(jp, jcfg, _j(batch))
    tl, _, _ = transformer.forward_logits(p, cfg, _t(batch))
    _close(tl.numpy(), jl, LOGIT_ATOL)


def _hold_leaves(port_tree, ref_tree):
    """Every leaf within GRAD_RTOL of the reference's, relative to its
    largest magnitude; yields (keystr, port leaf). A k bias adds q.b to every
    logit of a row, which the softmax cancels: its gradient is 0 in exact
    arithmetic and both packages return rounding noise (~1e-11), so a
    "['wk']['bias']" leaf is held against the tree's largest magnitude."""
    flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    ours = tree.leaves(port_tree)
    assert len(ours) == len(flat)
    scale = max(float(np.abs(np.asarray(b)).max()) for _, b in flat)
    for (path, b), a in zip(flat, ours):
        name = jax.tree_util.keystr(path)
        assert tuple(a.shape) == tuple(b.shape), name
        if name.endswith("['wk']['bias']"):
            diff = np.abs(a.double().numpy() - np.asarray(b, np.float64)).max()
            assert diff <= GRAD_RTOL * scale, (name, diff, scale)
        else:
            assert _rel(a, b) <= GRAD_RTOL, (name, _rel(a, b))
        yield name, a


def _train_batch(cfg, p, seed=0):
    rng = np.random.default_rng(seed)
    batch = _inputs(cfg, p, _tokens(cfg, B, T, seed))
    batch["labels"] = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    batch["loss_mask"] = (rng.random((B, T)) > 0.3).astype(np.float32)
    return batch


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    """The loss, its CE and every gradient leaf within GRAD_RTOL, remat off
    and on; whisper's encoder leaves get their gradient through each
    period's cross-attention (enc_out an input of the checkpointed body)."""
    jcfg, cfg = _cfgs(arch, remat=remat)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    p = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    batch = _train_batch(cfg, p)
    (jl, jmet), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, _j(batch))
    model = build_model(cfg, device="cpu")
    loss, grads = steps.loss_and_grads(model, p, _t(batch))
    _, met = model.loss_fn(p, _t(batch))
    assert _rel(loss, jl) <= GRAD_RTOL and _rel(met["ce"], jmet["ce"]) <= GRAD_RTOL
    for name, a in _hold_leaves(grads, jg):
        if name.startswith("['encoder']['layers']") and "bias" not in name:
            assert a.abs().max() > 0, name


def test_train_step_and_serve_steps_match_reference():
    """launch.steps as they are: one make_train_step on each arch's batch
    (whisper's frames and tokens, llava's inputs_embeds) against the
    reference's at step 1 (step 0's warmup rate is 0), every updated leaf
    held as _hold_leaves holds gradients; SGD, whose update is linear in the
    gradient (AdamW's first step is g / (|g| + eps), which turns a gradient
    near eps into any value; tests/test_torch_train.py holds AdamW from a
    warmed state); make_serve_steps' prefill and a greedy decode step."""
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        jstep, jo, jm = jsteps.make_train_step(jcfg, optimizer="sgd", lr=1e-3, warmup=2,
                                               total_steps=100)
        step, opt, _ = steps.make_train_step(cfg, optimizer="sgd", lr=1e-3, warmup=2,
                                             total_steps=100, device="cpu")
        jp = jm.init(jax.random.PRNGKey(0))
        p = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
        batch = _train_batch(cfg, p, seed=1)
        jp2, _, jmet = jax.jit(jstep)(jp, jo.init(jp), _j(batch), jnp.asarray(1, jnp.int32))
        before = [t.clone() for t in tree.leaves(p)]
        p2, _, met = step(p, opt.init(p, device="cpu"), _t(batch), torch.tensor(1))  # in place
        assert _rel(met["loss"], jmet["loss"]) <= GRAD_RTOL
        assert _rel(met["grad_norm"], jmet["grad_norm"]) <= GRAD_RTOL
        moved = [bool((a - b).abs().max() > 0)
                 for (_, a), b in zip(_hold_leaves(p2, jp2), before)]
        assert sum(moved) > len(moved) // 2
        # the serve steps, from the reference's initial weights
        p = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
        prefill, decode = steps.make_serve_steps(cfg, device="cpu")
        jprefill, jdecode = jsteps.make_serve_steps(jcfg)
        pre = {k: v for k, v in _inputs(cfg, p, _tokens(cfg, B, T0)).items()}
        last, caches = prefill(p, _t(pre))
        jlast, jcaches = jprefill(jp, _j(pre))
        _close(last.numpy(), jlast, LOGIT_ATOL)
        caches = transformer.pad_caches(cfg, caches, T)
        jcaches = jtransformer.pad_caches(jcfg, jcaches, T)
        tok, pos = np.array([[3], [5]], np.int32), np.array([T0, T0], np.int32)
        nxt, logits, _ = decode(p, {"tokens": torch.from_numpy(tok), "caches": caches,
                                    "pos": torch.from_numpy(pos)})
        jnxt, jlogits, _ = jdecode(jp, {"tokens": jnp.asarray(tok), "caches": jcaches,
                                        "pos": jnp.asarray(pos)})
        _close(logits.numpy(), jlogits, LOGIT_ATOL)
        assert np.array_equal(nxt.numpy(), np.asarray(jnxt))


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def _shapes(specs):
    return [tuple(s.shape) for s in jax.tree.leaves(specs, is_leaf=lambda x: hasattr(x, "shape"))]


def _dtypes(specs):
    return [str(s.dtype).split(".")[-1]
            for s in jax.tree.leaves(specs, is_leaf=lambda x: hasattr(x, "shape"))]


@pytest.mark.parametrize("enc_seq", [None, 1500, 16])
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs(arch, reduced, enc_seq):
    """cache_specs and make_input_specs (the Model's too) with enc_seq (its
    default 4096 where None) against the reference's ShapeDtypeStructs, at
    full and at reduced width: shapes and dtypes, nothing allocated."""
    cfg, jcfg = get_config(arch), jget(arch)
    if reduced:
        cfg, jcfg = reduce_config(cfg), jreduce(jcfg)
    kw = {} if enc_seq is None else {"enc_seq": enc_seq}
    ours, ref = transformer.cache_specs(cfg, 4, 448, **kw), jtransformer.cache_specs(
        jcfg, 4, 448, **kw)
    assert _shapes(ours) == _shapes(ref) and _dtypes(ours) == _dtypes(ref)
    if cfg.encoder_layers:
        assert ours["stack"][0]["cross"]["k"].shape[2] == (enc_seq or 4096)
    assert _shapes(build_model(cfg, device="cpu").cache_specs(4, 448, **kw)) == _shapes(ref)
    for cell in ("train_4k", "prefill_32k", "decode_32k"):
        ours = make_input_specs(cfg, SHAPES[cell], **kw)
        ref = jinput_specs(jcfg, JSHAPES[cell], **kw)
        assert list(ours) == list(ref)
        assert _shapes(ours) == _shapes(ref) and _dtypes(ours) == _dtypes(ref), cell
        assert _shapes(build_model(cfg, device="cpu").input_specs(SHAPES[cell], **kw)) == \
            _shapes(ref)


def test_concrete_batch_carries_the_inputs():
    for arch in ARCHS:
        cfg = reduce_config(get_config(arch))
        cell = dataclasses.replace(SHAPES["prefill_32k"], seq_len=20, global_batch=2)
        batch = concrete_batch(cfg, cell, torch.Generator().manual_seed(0), enc_seq=12)
        if cfg.encoder_layers:
            assert batch["encoder_frames"].shape == (2, 12, cfg.d_model)
            assert batch["tokens"].shape == (2, 20)
        else:
            assert list(batch) == ["inputs_embeds"] and batch["inputs_embeds"].shape == (
                2, 20, cfg.d_model)
        logits = build_model(cfg, device="cpu").prefill(
            build_model(cfg, device="cpu").init(0), batch)[0]
        assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# what the port refuses, as the reference fails
# ---------------------------------------------------------------------------


def test_every_arch_builds():
    from repro_torch.configs import list_configs

    for arch in list_configs():
        build_model(get_config(arch), device="cpu")
        build_model(reduce_config(get_config(arch)), device="cpu")


def test_lm_params_from_numpy_needs_the_encoder():
    jcfg, cfg = _cfgs(WHISPER)
    jp = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))
    for key in ("encoder", "dec_pos"):
        with pytest.raises(ValueError, match=key):
            lm_params_from_numpy(cfg, {k: v for k, v in jp.items() if k != key}, device="cpu")


@pytest.mark.parametrize("entry", ["forward", "engine", "launch.serve", "train", "launch.train"])
def test_whisper_without_frames_is_refused(entry, tmp_path):
    """Whisper's forward needs encoder frames: a token batch, and the entry
    points that feed only token batches (the Engine's first prefill, the
    serve launcher, train()'s first step and the train launcher), raise
    ValueError saying so."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.train import LoopConfig, train

    cfg = reduce_config(get_config(WHISPER))
    with pytest.raises(ValueError, match="encoder_frames"):
        if entry == "forward":
            m = build_model(cfg, device="cpu")
            m.forward(m.init(0), {"tokens": torch.zeros((1, 4), dtype=torch.long)})
        elif entry == "engine":
            engine = Engine(cfg, build_model(cfg, device="cpu").init(0), num_slots=2, capacity=8,
                            device="cpu")
            engine.run([Request(0, torch.zeros(4, dtype=torch.long), 2)])
        elif entry == "launch.serve":
            launch_serve.main(["--arch", WHISPER, "--reduced", "--requests", "2", "--slots", "2",
                               "--gen", "2", "--prompt-len", "8", "--device", "cpu"])
        elif entry == "train":
            train(cfg, LoopConfig(total_steps=1, global_batch=2, seq_len=8,
                                  ckpt_dir=str(tmp_path)), device="cpu")
        else:
            launch_train.main(["--arch", WHISPER, "--reduced", "--steps", "1", "--batch", "2",
                               "--seq", "8", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
