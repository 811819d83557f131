"""The recurrent mixers, Mamba (models/mamba.py) and xLSTM's mLSTM and sLSTM
blocks (models/xlstm.py), against the reference package on the CPU.

Mirrors tests/test_model_components.py (TestMambaChunks) and the recurrent
parts of tests/test_archs_smoke.py. Configs are reduced (f32): jamba (d_model
64, d_inner 128, d_state 8, chunk 8) and xlstm-125m (d_model 64, 4 heads,
mLSTM d_inner 128). Weights are the reference's `make_*` draws from a
PRNGKey, carried across by convert.lm_caches_from_numpy (a generic tree
converter); inputs are numpy draws from a seed.

Tolerances, each with its basis:
  - Mamba, port against the reference, and the port against itself at
    another chunk (4 / 8 / 16 / 64 against one chunk of the whole sequence,
    with a remainder): atol 2e-5, the reference's own chunk-invariance bound
    (TestMambaChunks), and max|diff| within 1e-5 of max|ref| (MAMBA_RTOL;
    the port reads at most 3.5e-7), so that the atol cannot hide a dropped
    term of small outputs. The inputs are of unit scale (TestMambaChunks
    draws them at 0.1, where max|y| is 5e-4 and 2e-5 would be 4 % of it).
    The port runs the in-chunk recurrence as a sequential loop where the
    reference runs lax.associative_scan's tree, so the two sum the same
    products in another order, as two chunk sizes do.
  - mLSTM and sLSTM, port against the reference: atol 1e-5 (f32 on both
    sides; cumsums, einsums and the sequential sLSTM step in another order).
  - prefill then decode against one forward over the whole sequence: the
    reference's contract (test_archs_smoke's decode-vs-forward checks), atol
    1e-4 (a recurrence carried in f32 and a parallel form that sums it in
    another order).
  - the q-chunked mLSTM branch against the unchunked one: atol 1e-6 (the
    same sums, row blocks apart).
  - in-place decode writes: the cache dict and its tensors are the same
    objects afterwards, holding the reference's new state (atol as above).
  - the engine's splice of recurrent leaves: bit-equal copies.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce
from repro.models import mamba as jax_mamba
from repro.models import transformer as jax_transformer
from repro.models import xlstm as jax_xlstm
from repro_torch import tree
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import lm_caches_from_numpy
from repro_torch.models import build_model, mamba, transformer, xlstm
from repro_torch.serve.engine import _splice_cache

JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-125m"
MAMBA_ATOL = 2e-5  # the reference's chunk-invariance bound
MAMBA_RTOL = 1e-5
XLSTM_ATOL = 1e-5
DECODE_ATOL = 1e-4
QCHUNK_ATOL = 1e-6


def _cfgs(arch, **mamba_kw):
    jcfg, cfg = jax_reduce(jax_get_config(arch)), reduce_config(get_config(arch))
    if mamba_kw:
        jcfg = dataclasses.replace(jcfg, mamba=dataclasses.replace(jcfg.mamba, **mamba_kw))
        cfg = dataclasses.replace(cfg, mamba=dataclasses.replace(cfg.mamba, **mamba_kw))
    return jcfg, cfg


def _params(make_jax, jcfg, seed=0):
    """The reference's block params from PRNGKey(seed) and the port's copy."""
    jp = make_jax(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, lm_caches_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(a, b, atol, rtol=None):
    """Within atol elementwise and, where rtol is given, max|a - b| within
    rtol of max|b|, so that atol cannot hide a term of small outputs."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, atol=atol)
    if rtol is not None:
        assert np.abs(a - b).max() <= rtol * np.abs(b).max(), np.abs(a - b).max() / np.abs(b).max()


def _tree_close(ours, theirs, atol, rtol=None):
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert tuple(ours[k].shape) == tuple(theirs[k].shape), k
        _close(ours[k], theirs[k], atol, rtol)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [22, 24, 5])
def test_mamba_forward_matches_reference(s):
    """Output, h and conv_tail of a prefill: S = 22 leaves a remainder of 6
    after chunks of 8 (padded steps), 24 divides, 5 is shorter than a chunk."""
    jcfg, cfg = _cfgs(JAMBA)
    jp, p = _params(jax_mamba.make_mamba, jcfg)
    x = _x((2, s, cfg.d_model))
    jy, jc = jax_mamba.mamba_forward(jp, jcfg, jnp.asarray(x), return_cache=True)
    y, c = mamba.mamba_forward(p, cfg, torch.from_numpy(x), return_cache=True)
    _close(y, jy, MAMBA_ATOL, MAMBA_RTOL)
    _tree_close(c, jc, MAMBA_ATOL, MAMBA_RTOL)
    assert c["h"].dtype == torch.float32 and c["h"].is_contiguous()


@pytest.mark.parametrize("chunk", [4, 8, 16, 64])
def test_mamba_chunk_size_invariance(chunk):
    """TestMambaChunks on the port: chunk 4 / 8 / 16 / 64 against one chunk
    of the whole 22-token sequence, and against the reference at that chunk."""
    jcfg, cfg = _cfgs(JAMBA, chunk=chunk)
    jp, p = _params(jax_mamba.make_mamba, jcfg)
    x = _x((2, 22, cfg.d_model))
    out = mamba.mamba_forward(p, cfg, torch.from_numpy(x))
    whole = mamba.mamba_forward(p, dataclasses.replace(
        cfg, mamba=dataclasses.replace(cfg.mamba, chunk=22)), torch.from_numpy(x))
    _close(out, whole.numpy(), MAMBA_ATOL, MAMBA_RTOL)
    _close(out, jax_mamba.mamba_forward(jp, jcfg, jnp.asarray(x)), MAMBA_ATOL, MAMBA_RTOL)


def test_mamba_padded_steps_are_identity_transitions():
    """The state after a 22-token prefill in chunks of 8 (two padded steps)
    is the state after the same 22 tokens in chunks of 11 (none) and of 22."""
    _, cfg = _cfgs(JAMBA)
    p = build_model(cfg, device="cpu").init(0)["stack"][0]["mixer"]
    p = tree.tree_map(lambda t: t[0], p)
    x = torch.from_numpy(_x((2, 22, cfg.d_model)))
    states = [mamba.mamba_forward(p, dataclasses.replace(
        cfg, mamba=dataclasses.replace(cfg.mamba, chunk=c)), x, return_cache=True)[1]["h"]
        for c in (8, 11, 22)]
    for h in states[1:]:
        _close(states[0], h.numpy(), MAMBA_ATOL, MAMBA_RTOL)


def test_mamba_decode_matches_reference_in_place():
    jcfg, cfg = _cfgs(JAMBA)
    jp, p = _params(jax_mamba.make_mamba, jcfg)
    rng = np.random.default_rng(2)
    spec = mamba.mamba_cache_spec(cfg, 3, torch.float32)
    cache_np = {k: rng.standard_normal(s.shape).astype(np.float32) for k, s in spec.items()}
    x = _x((3, 1, cfg.d_model), seed=3)
    jy, jc = jax_mamba.mamba_decode(jp, jcfg, jnp.asarray(x),
                                    {k: jnp.asarray(v) for k, v in cache_np.items()})
    cache = {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}
    leaves = dict(cache)
    y, out = mamba.mamba_decode(p, cfg, torch.from_numpy(x), cache)
    assert out is cache and all(cache[k] is leaves[k] for k in leaves)
    _close(y, jy, MAMBA_ATOL, MAMBA_RTOL)
    _tree_close(cache, jc, MAMBA_ATOL, MAMBA_RTOL)
    assert not np.allclose(cache["h"].numpy(), cache_np["h"])


@pytest.mark.parametrize("s,steps", [(13, 6), (16, 3)])
def test_mamba_prefill_then_decode_equals_forward(s, steps):
    """A prefill of s tokens, then `steps` one-token decodes from its cache,
    against one forward over the s + steps tokens (per position)."""
    _, cfg = _cfgs(JAMBA)
    p = tree.tree_map(lambda t: t[0], build_model(cfg, device="cpu").init(0)["stack"][0]["mixer"])
    x = torch.from_numpy(_x((2, s + steps, cfg.d_model)))
    full = mamba.mamba_forward(p, cfg, x)
    y, cache = mamba.mamba_forward(p, cfg, x[:, :s], return_cache=True)
    _close(y, full[:, :s].numpy(), DECODE_ATOL)
    for t in range(s, s + steps):
        yt, _ = mamba.mamba_decode(p, cfg, x[:, t : t + 1], cache)
        _close(yt, full[:, t : t + 1].numpy(), DECODE_ATOL)


def test_conv_causal_carries_its_tail():
    """The causal conv of a sequence in two pieces, the second continuing
    from the first's tail, equals the conv of the whole (bit for bit: the
    same products in the same order), as in the reference."""
    rng = np.random.default_rng(4)
    w, b = _t(rng.standard_normal((4, 6))), _t(rng.standard_normal(6))
    x = _t(rng.standard_normal((2, 9, 6)))
    whole, tail = mamba._conv_causal(w, b, x)
    a, t1 = mamba._conv_causal(w, b, x[:, :5])
    c, t2 = mamba._conv_causal(w, b, x[:, 5:], t1)
    assert torch.equal(torch.cat([a, c], 1), whole) and torch.equal(t2, tail)
    jy, jt = jax_mamba._conv_causal(jnp.asarray(w.numpy()), jnp.asarray(b.numpy()),
                                    jnp.asarray(x.numpy()))
    _close(whole, jy, 1e-6)
    _close(tail, jt, 0.0)


def test_make_mamba_matches_reference_layout():
    """make_mamba's tree: the reference's leaf paths, shapes and dtypes at
    jamba's full width in bf16 (a_log f32, as the reference keeps it), on
    meta tensors; and the init's values: a_log = log(1..d_state), dt_proj's
    bias the inverse softplus of a dt in [1e-3, 0.1]."""
    jcfg, cfg = jax_get_config(JAMBA), get_config(JAMBA)
    ref = jax.eval_shape(lambda: jax_mamba.make_mamba(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))

    class Meta:
        device = torch.device("meta")

    ours = mamba.make_mamba(Meta(), cfg, torch.bfloat16)
    jl = jax.tree_util.tree_leaves_with_path(ref)
    tl = jax.tree_util.tree_leaves_with_path(ours)
    assert [jax.tree_util.keystr(k) for k, _ in jl] == [jax.tree_util.keystr(k) for k, _ in tl]
    assert [tuple(a.shape) for _, a in jl] == [tuple(t.shape) for _, t in tl]
    assert [str(a.dtype) for _, a in jl] == [str(t.dtype).split(".")[1] for _, t in tl]
    _, small = _cfgs(JAMBA)
    p = mamba.make_mamba(torch.Generator().manual_seed(0), small, torch.float32)
    assert torch.equal(p["a_log"][0], torch.log(torch.arange(1.0, small.mamba.d_state + 1)))
    dt = torch.nn.functional.softplus(p["dt_proj"]["bias"])
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * (1 + 1e-5)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [21, 8])
def test_mlstm_forward_matches_reference(s):
    jcfg, cfg = _cfgs(XLSTM)
    jp, p = _params(jax_xlstm.make_mlstm, jcfg)
    x = _x((2, s, cfg.d_model))
    jy, jc = jax_xlstm.mlstm_forward(jp, jcfg, jnp.asarray(x), return_cache=True)
    y, c = xlstm.mlstm_forward(p, cfg, torch.from_numpy(x), return_cache=True)
    _close(y, jy, XLSTM_ATOL)
    _tree_close(c, jc, XLSTM_ATOL)


def test_mlstm_state_from_seq_matches_reference():
    rng = np.random.default_rng(5)
    b, s, h, dh = 2, 11, 4, 8
    q, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32) for _ in range(3))
    i_pre, f_pre = (3 * rng.standard_normal((b, s, h)).astype(np.float32) for _ in range(2))
    tail = rng.standard_normal((b, 3, h * dh)).astype(np.float32)
    ref = jax_xlstm._mlstm_state_from_seq(*(jnp.asarray(a) for a in (q, k, v, i_pre, f_pre, tail)))
    ours = xlstm._mlstm_state_from_seq(*(torch.from_numpy(a) for a in (q, k, v, i_pre, f_pre, tail)))
    _tree_close(ours, ref, XLSTM_ATOL)


def test_mlstm_decode_matches_reference_in_place():
    jcfg, cfg = _cfgs(XLSTM)
    jp, p = _params(jax_xlstm.make_mlstm, jcfg)
    rng = np.random.default_rng(6)
    spec = xlstm.mlstm_cache_spec(cfg, 3, torch.float32)
    cache_np = {k: rng.standard_normal(s.shape).astype(np.float32) for k, s in spec.items()}
    cache_np["m"] = np.abs(cache_np["m"])
    x = _x((3, 1, cfg.d_model), seed=7)
    jy, jc = jax_xlstm.mlstm_decode(jp, jcfg, jnp.asarray(x),
                                    {k: jnp.asarray(v) for k, v in cache_np.items()})
    cache = {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}
    leaves = dict(cache)
    y, out = xlstm.mlstm_decode(p, cfg, torch.from_numpy(x), cache)
    assert out is cache and all(cache[k] is leaves[k] for k in leaves)
    _close(y, jy, XLSTM_ATOL)
    _tree_close(cache, jc, XLSTM_ATOL)


def test_mlstm_q_chunked_branch_equals_unchunked(monkeypatch):
    """The threshold lowered to 16 and the chunk to 8: a 32-token prefill
    takes the q-chunked branch (4 row blocks) and gives the unchunked
    result; the reference's chunked branch, lowered alike, agrees too."""
    jcfg, cfg = _cfgs(XLSTM)
    jp, p = _params(jax_xlstm.make_mlstm, jcfg)
    x = _x((2, 32, cfg.d_model))
    whole, wc = xlstm.mlstm_forward(p, cfg, torch.from_numpy(x), return_cache=True)
    calls = []
    einsum = torch.einsum

    def spy(eq, *ops):
        if eq == "bthd,bshd->btsh":
            calls.append(ops[0].shape[1])
        return einsum(eq, *ops)

    for mod, t, c in ((xlstm, 16, 8), (jax_xlstm, 16, 8)):
        monkeypatch.setattr(mod, "_MLSTM_CHUNK_THRESHOLD", t)
        monkeypatch.setattr(mod, "_MLSTM_CHUNK", c)
    monkeypatch.setattr(xlstm.torch, "einsum", spy)
    chunked, cc = xlstm.mlstm_forward(p, cfg, torch.from_numpy(x), return_cache=True)
    monkeypatch.undo()
    assert calls == [8, 8, 8, 8]
    _close(chunked, whole.detach().numpy(), QCHUNK_ATOL)
    _tree_close(cc, {k: v.numpy() for k, v in wc.items()}, QCHUNK_ATOL)
    monkeypatch.setattr(jax_xlstm, "_MLSTM_CHUNK_THRESHOLD", 16)
    monkeypatch.setattr(jax_xlstm, "_MLSTM_CHUNK", 8)
    _close(chunked, jax_xlstm.mlstm_forward(jp, jcfg, jnp.asarray(x)), XLSTM_ATOL)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [19, 1])
def test_slstm_forward_matches_reference(s):
    jcfg, cfg = _cfgs(XLSTM)
    jp, p = _params(jax_xlstm.make_slstm, jcfg)
    jp = jax.tree.map(lambda a: a + 0.1 if a.ndim == 2 and a.shape[0] == 4 else a, jp)
    p = lm_caches_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")  # nonzero b_gates
    x = _x((2, s, cfg.d_model))
    jy, jc = jax_xlstm.slstm_forward(jp, jcfg, jnp.asarray(x), return_cache=True)
    y, c = xlstm.slstm_forward(p, cfg, torch.from_numpy(x), return_cache=True)
    _close(y, jy, XLSTM_ATOL)
    _tree_close(c, jc, XLSTM_ATOL)


def test_slstm_decode_matches_reference_in_place():
    jcfg, cfg = _cfgs(XLSTM)
    jp, p = _params(jax_xlstm.make_slstm, jcfg)
    rng = np.random.default_rng(8)
    spec = xlstm.slstm_cache_spec(cfg, 3, torch.float32)
    cache_np = {k: rng.standard_normal(s.shape).astype(np.float32) for k, s in spec.items()}
    cache_np["n"] = np.abs(cache_np["n"]) + 1.0
    x = _x((3, 1, cfg.d_model), seed=9)
    jy, jc = jax_xlstm.slstm_decode(jp, jcfg, jnp.asarray(x),
                                    {k: jnp.asarray(v) for k, v in cache_np.items()})
    cache = {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}
    leaves = dict(cache)
    y, out = xlstm.slstm_decode(p, cfg, torch.from_numpy(x), cache)
    assert out is cache and all(cache[k] is leaves[k] for k in leaves)
    _close(y, jy, XLSTM_ATOL)
    _tree_close(cache, jc, XLSTM_ATOL)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_prefill_then_decode_equals_forward(block):
    _, cfg = _cfgs(XLSTM)
    layer = 0 if block == "mlstm" else 3
    p = build_model(cfg, device="cpu").init(0)["stack"][layer]["mixer"]
    p = tree.tree_map(lambda t: t[0], p)
    fwd = getattr(xlstm, f"{block}_forward")
    dec = getattr(xlstm, f"{block}_decode")
    x = torch.from_numpy(_x((2, 17, cfg.d_model)))
    full = fwd(p, cfg, x)
    y, cache = fwd(p, cfg, x[:, :12], return_cache=True)
    _close(y, full[:, :12].numpy(), DECODE_ATOL)
    for t in range(12, 17):
        yt, _ = dec(p, cfg, x[:, t : t + 1], cache)
        _close(yt, full[:, t : t + 1].numpy(), DECODE_ATOL)


@pytest.mark.parametrize("make,name", [(xlstm.make_mlstm, "make_mlstm"),
                                       (xlstm.make_slstm, "make_slstm")])
def test_make_xlstm_blocks_match_reference_layout(make, name):
    """xlstm-125m's blocks at full width in bf16: the reference's leaf paths,
    shapes and dtypes."""
    jcfg, cfg = jax_get_config(XLSTM), get_config(XLSTM)
    ref = jax.eval_shape(lambda: getattr(jax_xlstm, name)(jax.random.PRNGKey(0), jcfg,
                                                          jnp.bfloat16))

    class Meta:
        device = torch.device("meta")

    ours = make(Meta(), cfg, torch.bfloat16)
    jl = jax.tree_util.tree_leaves_with_path(ref)
    tl = jax.tree_util.tree_leaves_with_path(ours)
    assert [jax.tree_util.keystr(k) for k, _ in jl] == [jax.tree_util.keystr(k) for k, _ in tl]
    assert [tuple(a.shape) for _, a in jl] == [tuple(t.shape) for _, t in tl]
    assert all(t.dtype == torch.bfloat16 for _, t in tl)


# ---------------------------------------------------------------------------
# the whole stack: cache specs, pad_caches, the engine's splice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_recurrent_cache_specs_match_reference(arch):
    """cache_specs at full width: the reference's shapes and dtypes (f32
    states, conv tails in bf16) for each layer kind; only attention's k and
    v depend on the capacity."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    ours = tree.leaves(transformer.cache_specs(cfg, 4, 4640))
    ref = jax.tree.leaves(jax_transformer.cache_specs(jcfg, 4, 4640),
                          is_leaf=lambda x: hasattr(x, "shape"))
    assert [tuple(s.shape) for s in ours] == [tuple(s.shape) for s in ref]
    assert [str(s.dtype).split(".")[1] for s in ours] == [str(s.dtype) for s in ref]
    short = tree.leaves(transformer.cache_specs(cfg, 4, 8))
    by_capacity = sum(a.shape != b.shape for a, b in zip(ours, short))
    assert by_capacity == {JAMBA: 2, XLSTM: 0}[arch]


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_pad_caches_passes_recurrent_states_through(arch):
    """pad_caches grows attention's k / v to the capacity and hands every
    recurrent leaf back as the same tensor; the reference's padded shapes."""
    jcfg, cfg = _cfgs(arch)
    m = build_model(cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 11))
    _, caches = m.prefill(m.init(0), {"tokens": torch.from_numpy(toks)})
    padded = transformer.pad_caches(cfg, caches, 20)
    jpadded = jax_transformer.pad_caches(jcfg, jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), caches), 20)
    assert [tuple(a.shape) for a in tree.leaves(padded)] == [
        tuple(b.shape) for b in jax.tree.leaves(jpadded)]
    for new, old, spec in zip(padded["stack"], caches["stack"], cfg.period):
        for k, t in new["self"].items():
            assert t.shape[2] == 20 if spec.mixer == "attn" else t is old["self"][k], k


@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
@pytest.mark.parametrize("layout", ["stack", "prefix"])
@pytest.mark.parametrize("periods,slots", [(1, 2), (2, 4)])
def test_splice_copies_recurrent_states_whole(arch, layout, periods, slots):
    """_splice_cache of a one-sequence prefill cache (a 5-token prompt) into
    slot 1: every recurrent leaf (h, conv_tail; c, n, m, conv_tail; c, n, m,
    h), whose axis after the batch axis is d_inner, heads or K - 1 and equal
    on both sides, lands whole and bit-equal; attention's k / v land in rows
    [0, 5); the other slots and the rows past the prompt keep what they held.
    Stacked leaves carry the period axis in front (one period and 2 slots
    included); prefix leaves have the batch at axis 0."""
    _, cfg = _cfgs(arch)
    kinds = cfg.period
    if layout == "prefix":
        cfg = dataclasses.replace(cfg, prefix=kinds * periods, period=(),
                                  num_layers=periods * len(kinds))
    else:
        cfg = dataclasses.replace(cfg, num_layers=periods * len(kinds))
    rng = np.random.default_rng(slots)
    fill = lambda s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s.shape).astype(np.float32)).to(s.dtype)
    dst = tree.tree_map(fill, transformer.cache_specs(cfg, slots, 8))
    src = tree.tree_map(fill, transformer.cache_specs(cfg, 1, 5))
    before = tree.tree_map(torch.clone, dst)
    _splice_cache(dst, src, 1)
    b_axis = 0 if layout == "prefix" else 1
    whole = 0
    for (path, d), s, old in zip(tree.leaves_with_path(dst), tree.leaves(src),
                                 tree.leaves(before)):
        name, slot, was = tree.path_str(path), d.narrow(b_axis, 1, 1), old.narrow(b_axis, 1, 1)
        if name.endswith(("/k", "/v")):
            assert torch.equal(slot.narrow(b_axis + 1, 0, 5), s), name
            assert torch.equal(slot.narrow(b_axis + 1, 5, 3), was.narrow(b_axis + 1, 5, 3)), name
        else:
            assert torch.equal(slot, s), name
            whole += 1
        for i in range(slots):
            if i != 1:
                assert torch.equal(d.narrow(b_axis, i, 1), old.narrow(b_axis, i, 1)), name
    assert whole == {JAMBA: 2 * 7, XLSTM: 4 * 4}[arch] * (periods if layout == "prefix" else 1)


def test_engine_splices_a_prefill_state_bit_equal():
    """A reduced jamba engine (2 slots) after admitting one request: the
    slot's h and conv_tail in every Mamba layer are the request's lone
    prefill's, bit for bit."""
    from repro_torch.serve.engine import Engine, Request

    _, cfg = _cfgs(JAMBA)
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    eng = Engine(cfg, params, num_slots=2, capacity=32, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, 19))
    eng._admit(Request(0, prompt, 4), 1)
    _, alone = m.prefill(params, {"tokens": prompt[None]})
    n = 0
    for layer, lone, spec in zip(eng.caches["stack"], alone["stack"], cfg.period):
        if spec.mixer == "mamba":
            for k in ("h", "conv_tail"):
                assert torch.equal(layer["self"][k][:, 1], lone["self"][k][:, 0]), k
                n += 1
    assert n == 2 * 7
