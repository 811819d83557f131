"""The port's MoE channel mixer (models/moe.py) and the MoE model around it
against the reference package, on the CPU.

Both packages compute from the same numbers: the reference's `make_moe` /
`init_params` weights carried across by convert.py, numpy inputs. Routing
(top_e, capacity positions, keep) is compared bit for bit with a jax mirror
of the reference's routing lines (src/repro/models/moe.py:50-67, lax.top_k
and the exclusive cumsum), chunk by chunk, the remainder chunk included;
y and aux come from the reference's apply_moe itself. Tolerances:

  - f32: y atol 1e-5 (f32 sums in another order), aux 1e-6 relative;
  - bf16 weights and activations: y within BF16_RTOL of max |y| (the four
    expert products round their outputs to bf16 on both sides, from f32
    sums taken in another order, so an element may land one bf16 ulp away,
    at most 2^-7 of its value; one ulp at max |y| = 2.625, 5.95e-3 of it,
    read here), aux 1e-6;
  - loss_fn and every gradient leaf: 1e-5 relative to the leaf's largest
    magnitude, as tests/test_torch_train.py holds the dense family;
  - layouts, checkpoints: equal, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import get_config as jget
from repro.configs import reduce_config as jreduce
from repro.distributed import sharding as jshd
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.optim import optimizer as jopt
from repro.train import restore_checkpoint as jrestore
from repro.train import save_checkpoint as jsave
from repro_torch import tree
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import lm_caches_from_numpy, lm_params_from_numpy, opt_state_from_numpy
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import build_model, counting, moe, transformer
from repro_torch.train import restore_checkpoint, save_checkpoint

torch.set_num_threads(2)

ARCH = "qwen2-moe-a2.7b"
Y_ATOL = 1e-5
AUX_RTOL = 1e-6
BF16_RTOL = 1e-2
GRAD_RTOL = 1e-5


def _cfgs(arch=ARCH, dtype="float32", **moe_kw):
    """(reference config, port config): reduced, with MoEConfig fields
    replaced by moe_kw."""
    out = []
    for cfg in (jreduce(jget(arch)), reduce_config(get_config(arch))):
        cfg = dataclasses.replace(cfg, dtype=dtype)
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return tuple(out)


def _moe_params(jcfg, seed=0, dtype=jnp.float32):
    """The reference's make_moe weights, and the same numbers for the port."""
    jp = jmoe.make_moe(jax.random.PRNGKey(seed), jcfg, dtype)
    return jp, lm_caches_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _ref_routing(jp, moe_cfg, x):
    """The reference's routing lines (moe.py:50-67) for one chunk x (T, D)."""
    t = x.shape[0]
    e, k = moe_cfg.num_experts, moe_cfg.top_k
    cap = max(1, int(np.ceil(t * k / e * moe_cfg.capacity_factor)))
    logits = x.astype(jnp.float32) @ jp["router"]["kernel"] + jp["router"].get("bias", 0.0)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    flat = jax.nn.one_hot(top_e, e, dtype=jnp.int32).reshape(t * k, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat, axis=-1).reshape(t, k)
    return np.asarray(top_e), np.asarray(pos), np.asarray(pos < cap), cap


def _chunks(n_tokens, chunk):
    """apply_moe's chunk boundaries over B*S tokens, the remainder last."""
    chunk = min(chunk, n_tokens)
    bounds = [(i, i + chunk) for i in range(0, n_tokens - chunk + 1, chunk)]
    if bounds[-1][1] < n_tokens:
        bounds.append((bounds[-1][1], n_tokens))
    return bounds


def _hold_routing(jp, tp, moe_cfg, x):
    """Every chunk's top_e, pos and keep bit-equal to the reference's;
    returns the count of dropped (token, k) pairs."""
    flat = x.reshape(-1, x.shape[-1])
    dropped = 0
    for lo, hi in _chunks(flat.shape[0], moe_cfg.router_chunk):
        ref_e, ref_pos, ref_keep, ref_cap = _ref_routing(jp, moe_cfg, jnp.asarray(flat[lo:hi]))
        r = moe.route(tp, moe_cfg, torch.from_numpy(flat[lo:hi]))
        assert r.cap == ref_cap, (lo, hi)
        assert np.array_equal(r.top_e.numpy(), ref_e), (lo, hi)
        assert np.array_equal(r.pos.numpy(), ref_pos), (lo, hi)
        assert np.array_equal(r.keep.numpy(), ref_keep), (lo, hi)
        dropped += int((~ref_keep).sum())
    return dropped


def _hold_outputs(jp, tp, jcfg, cfg, x, y_atol=Y_ATOL):
    jy, jaux = jmoe.apply_moe(jp, jcfg, jnp.asarray(x))
    y, aux = moe.apply_moe(tp, cfg, torch.from_numpy(x))
    assert y.shape == x.shape and y.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=y_atol, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)


# ---------------------------------------------------------------------------
# apply_moe and its routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 37), (1, 16), (3, 5)])
def test_apply_moe_dropless_matches_reference(shape):
    """reduce_config's dropless capacity (8 / top_k), router_chunk 16: whole
    chunks, a remainder, and a batch smaller than one chunk."""
    jcfg, cfg = _cfgs()
    jp, tp = _moe_params(jcfg)
    x = _x(shape + (cfg.d_model,))
    assert _hold_routing(jp, tp, cfg.moe, x) == 0
    _hold_outputs(jp, tp, jcfg, cfg, x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_capacity_routing_bit_equal(seed):
    """capacity_factor 1.25, router_chunk 16, T = 37: two chunks of 16 and a
    remainder of 5 with its own capacity; tokens drop."""
    jcfg, cfg = _cfgs(capacity_factor=1.25)
    jp, tp = _moe_params(jcfg, seed)
    x = _x((1, 37, cfg.d_model), seed)
    assert _hold_routing(jp, tp, cfg.moe, x) > 0
    _hold_outputs(jp, tp, jcfg, cfg, x)


@pytest.mark.parametrize("router", ["zero", "tied_columns"])
def test_ties_follow_lax_top_k(router):
    """Equal probabilities go lowest expert first, as lax.top_k orders them:
    a zero router (every probability ties: experts 0..k-1 for every token,
    then capacity drops the later tokens) and a router whose columns come in
    equal pairs (each pair ties)."""
    jcfg, cfg = _cfgs(capacity_factor=1.25)
    jp, _ = _moe_params(jcfg)
    kern = np.asarray(jp["router"]["kernel"])
    kern = np.zeros_like(kern) if router == "zero" else np.repeat(kern[:, ::2], 2, axis=1)
    jp = dict(jp, router={"kernel": jnp.asarray(kern)})
    tp = lm_caches_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = _x((1, 37, cfg.d_model))
    assert _hold_routing(jp, tp, cfg.moe, x) > 0
    if router == "zero":
        r = moe.route(tp, cfg.moe, torch.from_numpy(x[0, :16]))
        assert r.top_e.tolist() == [list(range(cfg.moe.top_k))] * 16
    _hold_outputs(jp, tp, jcfg, cfg, x)


def test_decode_batch_capacity_one():
    """A 4-row decode step at qwen2-moe's routing (60 experts, top-4,
    capacity 1.25): the chunk is the batch and every expert holds one token,
    so later rows lose experts to earlier ones."""
    full = get_config(ARCH).moe
    kw = dict(num_experts=full.num_experts, top_k=full.top_k,
              capacity_factor=full.capacity_factor)
    jcfg, cfg = _cfgs(**kw)
    x = _x((4, 1, cfg.d_model), 3)
    jp, tp = _moe_params(jcfg, 3)
    assert moe.route(tp, cfg.moe, torch.from_numpy(x[:, 0])).cap == 1
    assert _hold_routing(jp, tp, cfg.moe, x) > 0
    _hold_outputs(jp, tp, jcfg, cfg, x)


@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_bf16_matches_reference(capacity_factor):
    kw = {} if capacity_factor is None else dict(capacity_factor=capacity_factor)
    jcfg, cfg = _cfgs(dtype="bfloat16", **kw)
    jp, tp = _moe_params(jcfg, dtype=jnp.bfloat16)
    x = np.asarray(jnp.asarray(_x((2, 37, cfg.d_model))).astype(jnp.bfloat16))
    jy, jaux = jmoe.apply_moe(jp, jcfg, jnp.asarray(x))
    y, aux = moe.apply_moe(tp, cfg, lm_caches_from_numpy({"x": x}, device="cpu")["x"])
    assert y.dtype == torch.bfloat16
    jy = np.asarray(jy.astype(jnp.float32))
    err = np.abs(y.float().numpy() - jy).max() / np.abs(jy).max()
    assert err <= BF16_RTOL, err
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)


def test_router_mass_conserved():
    """The reference's test_moe_router_mass_conserved on the port's own
    init: y finite, aux > 0; and each token's combine weights sum to 1
    where nothing was dropped, to less where something was."""
    cfg = dataclasses.replace(reduce_config(get_config(ARCH)))
    params = build_model(cfg, device="cpu").init(0)
    p = tree.tree_map(lambda t: t[0], params["stack"][0]["mlp"])
    x = torch.from_numpy(_x((2, 16, cfg.d_model), 5, scale=0.1))
    y, aux = moe.apply_moe(p, cfg, x)
    assert y.shape == x.shape and torch.isfinite(y).all() and float(aux) > 0
    for capacity_factor in (cfg.moe.capacity_factor, 1.0):
        m = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
        r = moe.route(p, m, x.reshape(-1, cfg.d_model)[:16])
        mass = (r.top_p * r.keep).sum(-1)
        whole = r.keep.all(-1)
        assert torch.allclose(mass[whole], torch.ones(()), atol=1e-6)
        assert (mass[~whole] < 1).all()
    assert not r.keep.all()  # capacity 1.0 drops


def test_routing_is_permutation_stable():
    """The reference's TestMoEDeterminism case on the port (deepseek's
    reduced MoE, dropless): permuting the batch permutes the outputs."""
    cfg = reduce_config(get_config("deepseek-v2-lite-16b"))
    p = moe.make_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.from_numpy(_x((4, 8, cfg.d_model), 1, scale=0.3))
    y, _ = moe.apply_moe(p, cfg, x)
    perm = torch.tensor([2, 0, 3, 1])
    y_p, _ = moe.apply_moe(p, cfg, x[perm])
    np.testing.assert_allclose(y[perm].numpy(), y_p.numpy(), atol=2e-5)


def test_make_moe_layout_and_scales():
    """make_moe's leaves, shapes and dtypes are the reference's, and its
    draws have the reference's scales."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    ref = jax.eval_shape(lambda: jmoe.make_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    ours = moe.make_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    jl = jax.tree_util.tree_leaves_with_path(ref)
    tl = jax.tree_util.tree_leaves_with_path(ours)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in tl]
    assert [(tuple(a.shape), str(a.dtype)) for _, a in jl] == [
        (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for _, t in tl]
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    assert ours["router"]["kernel"].dtype == torch.float32
    for name, scale in (("w_gate", d**-0.5), ("w_in", d**-0.5),
                        ("w_out", f**-0.5 / (2.0 * cfg.num_layers) ** 0.5)):
        assert abs(float(ours[name].float().std()) / scale - 1) < 0.05, name


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v2-lite-16b"])
def test_param_count_matches_analytic(arch):
    """counting.py's MoE count is the real init's, leaf for leaf; the whole
    reduced model within the reference's 2 % (qwen2-moe)."""
    cfg = reduce_config(get_config(arch))
    p = moe.make_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert sum(t.numel() for t in tree.leaves(p)) == counting._moe_params(cfg, False)
    if arch == ARCH:
        actual = sum(t.numel() for t in tree.leaves(build_model(cfg, device="cpu").init(0)))
        analytic = counting.count_params(cfg)
        assert abs(actual - analytic) / actual < 0.02, (actual, analytic)


def test_full_width_template():
    """qwen2-moe-a2.7b at full width, as meta tensors: every parameter
    counted (~14.3 B), the experts stacked (24, 60, 2048, 1408)."""
    cfg = get_config(ARCH)
    p = transformer.param_template(cfg)
    mlp = p["stack"][0]["mlp"]
    assert tuple(mlp["w_gate"].shape) == (24, 60, 2048, 1408)
    assert tuple(mlp["shared"]["w_in"]["kernel"].shape) == (24, 2048, 5632)
    assert mlp["router"]["kernel"].dtype == torch.float32
    assert mlp["w_out"].dtype == torch.bfloat16
    assert "bias" in p["stack"][0]["mixer"]["wq"] and "bias" not in p["stack"][0]["mixer"]["wo"]
    n = sum(t.numel() for t in tree.leaves(p))
    assert abs(n - counting.count_params(cfg)) / n < 1e-3 and 14.2e9 < n < 14.4e9


# ---------------------------------------------------------------------------
# the model: loss, gradients, layouts, checkpoints
# ---------------------------------------------------------------------------


def _np(x):
    return np.asarray(x.detach().float().numpy() if isinstance(x, torch.Tensor) else x, np.float64)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _batch(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "loss_mask": (rng.random((b, s)) > 0.3).astype(np.float32)}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_loss_and_grads_match_reference(capacity_factor, remat):
    """{"ce", "aux"} and every gradient leaf (the router's included) against
    jax.grad of the reference's loss_fn; remat sums the aux through the
    checkpointed period body."""
    kw = {} if capacity_factor is None else dict(capacity_factor=capacity_factor)
    jcfg, cfg = _cfgs(**kw)
    jcfg, cfg = (dataclasses.replace(c, remat=remat) for c in (jcfg, cfg))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    p = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    b = _batch(cfg)
    (jl, jmet), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    model = build_model(cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    _, met = model.loss_fn(p, tb)
    loss, grads = steps.loss_and_grads(model, p, tb)
    assert set(met) == set(jmet) == {"ce", "aux"}
    assert float(met["aux"]) > 0
    for a, b_ in ((loss, jl), (met["ce"], jmet["ce"]), (met["aux"], jmet["aux"])):
        assert _rel(a, b_) <= GRAD_RTOL, (float(a), float(b_))
    names = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    ours, theirs = tree.leaves(grads), jax.tree.leaves(jg)
    assert len(ours) == len(theirs)
    assert any("router" in n for n in names)
    for name, a, b_ in zip(names, ours, theirs):
        assert tuple(a.shape) == tuple(b_.shape), name
        assert _rel(a, b_) <= GRAD_RTOL, (name, _rel(a, b_))
        if "router" in name:
            assert np.abs(_np(a)).max() > 0, name


@pytest.mark.parametrize("shape,names", [((2, 4), ("data", "model")),
                                         ((2, 16, 16), ("pod", "data", "model"))])
def test_param_specs_match_reference(shape, names):
    """Experts on `model` where 60 divides by it (4), else the expert ff
    dimension (16)."""
    jmesh, mesh = JAbstractMesh(shape, names), shd.AbstractMesh(shape, names)
    jt = jax.eval_shape(lambda: jtransformer.init_params(jax.random.PRNGKey(0), jget(ARCH)))
    ours = shd.param_specs(mesh, transformer.param_template(get_config(ARCH)))
    theirs = [tuple(s.spec) for s in jax.tree.leaves(jshd.param_shardings(jmesh, jt))]
    assert tree.leaves(ours) == theirs
    w_gate = ours["stack"][0]["mlp"]["w_gate"]
    assert w_gate == ((None, "model", None, None) if shape[-1] == 4 else
                      (None, None, None, "model")), w_gate


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy())
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def bf16_moe():
    """Reduced qwen2-moe in bf16 and a nonzero AdamW state, in both
    packages' trees (the same numbers)."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    js = jax.tree.map(lambda a: a + 0.5, jopt.make_adamw().init(jp))
    return (cfg, jp, js, lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu"),
            opt_state_from_numpy("adamw", jax.tree.map(np.asarray, js), device="cpu"))


def _same_bits(ours, theirs):
    a, b = tree.leaves(ours), jax.tree.leaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert str(x.dtype).removeprefix("torch.") == str(y.dtype)
        assert np.array_equal(_bits(x), _bits(y))


def test_reference_checkpoint_restores_in_the_port(bf16_moe, tmp_path):
    cfg, jp, js, _, s = bf16_moe
    jsave(tmp_path, 2, jp, js)
    p2, s2, _, step = restore_checkpoint(tmp_path, None, transformer.param_template(cfg), s,
                                         device="cpu")
    assert step == 2
    _same_bits({"p": p2, "s": s2}, {"p": jp, "s": js})
    assert "router" in p2["stack"][0]["mlp"] and "shared" in p2["stack"][0]["mlp"]


def test_port_checkpoint_restores_in_the_reference(bf16_moe, tmp_path):
    cfg, jp, js, p, s = bf16_moe
    save_checkpoint(tmp_path, 2, p, s)
    jp2, js2, _, step = jrestore(tmp_path, None, jp, js)
    assert step == 2
    _same_bits({"p": p, "s": s}, {"p": jp2, "s": js2})
