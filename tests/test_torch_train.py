"""The port's training path (loss, optimizers, data, checkpoints, the step,
the loop, the LM layouts) against the reference package, on the CPU.

Every case of tests/test_train_substrate.py runs on the port (phi4-mini
reduced where the reference uses xlstm for the loss and compression cases;
the restart case runs xlstm-125m, as the reference's does, and h2o-danube),
then parity: both packages compute from the same numbers (the
reference's weights and optimizer states carried across by convert.py,
numpy inputs). Tolerances, each at its check:

  - SyntheticTokens.batch: bit-equal (the same numpy draws);
  - cross_entropy_loss / cross_entropy_from_features: 1e-6 relative (f32 on
    both sides, the logsumexp in another order);
  - loss_fn and every gradient leaf from the same weights: 1e-5 relative to
    the leaf's largest magnitude (f32 sums in another order), remat on and
    off;
  - one make_train_step under adamw, adafactor and sgd, plain, microbatch 2
    and int8: every updated parameter and state leaf within 1e-5 relative.
    The step starts from a state the reference warmed with two steps: the
    first AdamW step from a zero state normalises each gradient element to
    about +-lr, so an element at the f32 noise floor of the gradient (|g| ~
    1e-9, reached by another summation order) can flip its sign; with the
    second moment holding that element's history it cannot;
  - checkpoints across the packages: bit-equal, manifests equal;
  - the port's train resumed from a reference checkpoint: losses within rtol
    1e-4 of the reference's, the final checkpoint within 1e-5 relative per
    leaf;
  - the LM layouts against the reference's PartitionSpecs: equal, entry for
    entry.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import get_config as jget
from repro.configs import reduce_config as jreduce
from repro.configs.base import SHAPES as JSHAPES
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.distributed import sharding as jshd
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.model import make_input_specs as jinput_specs
from repro.optim import optimizer as jopt
from repro.train import LoopConfig as JLoopConfig
from repro.train import restore_checkpoint as jrestore
from repro.train import save_checkpoint as jsave
from repro.train import train as jtrain
from repro_torch import tree
from repro_torch.configs import SHAPES, get_config, reduce_config
from repro_torch.convert import (
    lm_params_from_numpy,
    lm_params_to_numpy,
    opt_state_from_numpy,
    opt_state_to_numpy,
)
from repro_torch.data import DataConfig, SyntheticTokens, to_device
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import attention, build_model, layers, transformer
from repro_torch.models.model import concrete_batch, make_input_specs
from repro_torch.optim import (
    cosine_schedule,
    global_norm,
    clip_by_global_norm,
    make_adafactor,
    make_adamw,
    make_compressor,
    make_sgd,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.train import LoopConfig, latest_step, restore_checkpoint, save_checkpoint, train

torch.set_num_threads(2)

CE_RTOL = 1e-6
GRAD_RTOL = 1e-5
STEP_RTOL = 1e-5
LOOP_LOSS_RTOL = 1e-4
LOOP_PARAM_RTOL = 1e-5
DENSE_ARCHS = ["h2o-danube-1.8b", "phi4-mini-3.8b", "gemma-7b", "command-r-plus-104b"]


def _cfgs(arch, **kw):
    """(reference config, port config), reduced (f32, one period)."""
    return (dataclasses.replace(jreduce(jget(arch)), **kw),
            dataclasses.replace(reduce_config(get_config(arch)), **kw))


def _np(x):
    return np.asarray(x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)) if b.size else 0.0


def _hold_leaves(port_tree, ref_tree, rtol, what, skip=None):
    """Every leaf within rtol of the reference's, relative to its largest
    magnitude; skip maps a leaf's keystr to a boolean mask of elements left
    out (int8 quantum flips, test_train_step_matches_reference)."""
    ours, theirs = tree.leaves(port_tree), jax.tree.leaves(ref_tree)
    assert len(ours) == len(theirs), (what, len(ours), len(theirs))
    names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(ref_tree)[0]]
    for name, a, b in zip(names, ours, theirs):
        assert tuple(np.shape(a)) == tuple(np.shape(b)), (what, name)
        a, b = _np(a), _np(b)
        if skip is not None and name in skip:
            b = np.where(skip[name], a, b)
        assert _rel(a, b) <= rtol, (what, name, _rel(a, b))


def _batch(cfg, b=2, s=24, seed=0, partial=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32) if partial else np.ones((b, s), np.float32)
    return {"tokens": toks, "labels": labels, "loss_mask": mask}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# tests/test_train_substrate.py on the port
# ---------------------------------------------------------------------------


class TestData:
    def test_deterministic_by_step(self):
        cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=3)
        a = SyntheticTokens(cfg).batch(7)
        b = SyntheticTokens(cfg).batch(7)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        c = SyntheticTokens(cfg).batch(8)
        assert not np.array_equal(a["tokens"], c["tokens"])

    def test_labels_are_shifted_tokens(self):
        cfg = DataConfig(vocab_size=50, seq_len=8, global_batch=2)
        b = SyntheticTokens(cfg).batch(0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_any_host_can_slice(self):
        """Straggler story: a shard equals the slice of the global batch."""
        cfg = DataConfig(vocab_size=50, seq_len=8, global_batch=8)
        src = SyntheticTokens(cfg)
        full = src.batch(3)
        part = src.batch(3, batch_slice=slice(2, 6))
        np.testing.assert_array_equal(full["tokens"][2:6], part["tokens"])

    @pytest.mark.parametrize("seed,step,batch_slice", [(0, 0, None), (3, 7, None), (5, 11, slice(1, 3))])
    def test_batches_bit_equal_to_reference(self, seed, step, batch_slice):
        kw = dict(vocab_size=1000, seq_len=40, global_batch=4, seed=seed)
        ours = SyntheticTokens(DataConfig(**kw)).batch(step, batch_slice)
        ref = JSyntheticTokens(JDataConfig(**kw)).batch(step, batch_slice)
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k

    def test_to_device_slices_rows(self):
        b = SyntheticTokens(DataConfig(vocab_size=50, seq_len=8, global_batch=4)).batch(0)
        t = to_device(b, "cpu", slice(2, 4))
        assert t["tokens"].dtype == torch.int32 and t["loss_mask"].dtype == torch.float32
        np.testing.assert_array_equal(t["labels"].numpy(), b["labels"][2:4])


class TestOptimizers:
    def _quad(self):
        params = {"w": torch.tensor([1.0, -2.0, 3.0])}

        def grad_fn(p):
            return {"w": 2.0 * p["w"]}

        return params, grad_fn

    @pytest.mark.parametrize("make", [make_adamw, make_adafactor, make_sgd])
    def test_descends_quadratic(self, make):
        opt = make(lr_fn=lambda s: 0.05)
        params, grad_fn = self._quad()
        state = opt.init(params, device="cpu")
        for step in range(120):
            g = grad_fn(params)
            params, state = opt.update(params, g, state, step)
        assert float(torch.sum(params["w"] ** 2)) < 0.2

    def test_adafactor_states_are_factored(self):
        opt = make_adafactor()
        params = {"w": torch.zeros((8, 16)), "b": torch.zeros((16,))}
        st = opt.init(params, device="cpu")
        assert st["w"]["vr"].shape == (8,)
        assert st["w"]["vc"].shape == (16,)
        assert st["b"]["v"].shape == (16,)

    def test_cosine_schedule_shape(self):
        assert float(cosine_schedule(0, warmup=100)) < float(cosine_schedule(99, warmup=100))
        assert float(cosine_schedule(100)) > float(cosine_schedule(9000))

    def test_int8_compression_bounded_error(self):
        comp = make_compressor("int8")
        g = {"a": torch.tensor([1.0, -0.5, 0.001, 0.7])}
        out = comp(g)
        err = torch.max(torch.abs(out["a"] - g["a"]))
        assert float(err) <= 1.0 / 127.0 + 1e-6

    def test_init_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("checks the behaviour without a CUDA card")
        for make in (make_adamw, make_adafactor, make_sgd):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make().init({"w": torch.zeros(3)})

    def test_schedule_norm_clip_and_int8_match_reference(self):
        """cosine_schedule over warmup and decay, global_norm, the clip and
        the int8 round trip, each within f32 rounding (1e-6 relative)."""
        for step in (0, 1, 7, 49, 50, 51, 300, 9999, 12000):
            a = float(cosine_schedule(step, base_lr=1e-3, warmup=50, total=10_000))
            b = float(jopt.cosine_schedule(step, base_lr=1e-3, warmup=50, total=10_000))
            assert abs(a - b) <= 1e-6 * abs(b), (step, a, b)
        rng = np.random.default_rng(0)
        g = {"b": rng.normal(size=(7,)).astype(np.float32),
             "a": [rng.normal(size=(4, 5)).astype(np.float32) * 3.0]}
        tg = {"b": torch.from_numpy(g["b"]), "a": [torch.from_numpy(g["a"][0])]}
        jg = jax.tree.map(jnp.asarray, g)
        assert _rel(global_norm(tg), jopt.global_norm(jg)) <= 1e-6
        _hold_leaves(clip_by_global_norm(tg, 1.0), jopt.clip_by_global_norm(jg, 1.0), 1e-6, "clip")
        _hold_leaves(make_compressor("int8")(tg), jopt.make_compressor("int8")(jg), 1e-6, "int8")


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3, dtype=torch.bfloat16)}
        opt = {"mu": tree.tree_map(torch.zeros_like, params)}
        save_checkpoint(tmp_path, 5, params, opt, extra={"x": 1})
        p2, o2, extra, step = restore_checkpoint(tmp_path, None, params, opt, device="cpu")
        assert step == 5 and extra == {"x": 1}
        np.testing.assert_array_equal(p2["w"].numpy(), params["w"].numpy())
        assert p2["b"].dtype == torch.bfloat16

    def test_gc_keeps_latest(self, tmp_path):
        params = {"w": torch.zeros(2)}
        for s in [1, 2, 3, 4, 5]:
            save_checkpoint(tmp_path, s, params, {}, keep=2)
        assert latest_step(tmp_path) == 5
        steps_ = sorted(d.name for d in tmp_path.glob("step_*"))
        assert len(steps_) == 2

    def test_mismatched_tree_is_refused(self, tmp_path):
        save_checkpoint(tmp_path, 0, {"w": torch.zeros(2)}, {})
        with pytest.raises(ValueError, match="tree mismatch"):
            restore_checkpoint(tmp_path, None, {"v": torch.zeros(2)}, {}, device="cpu")


class TestTrainLoop:
    def _loop_cfg(self, tmp_path, **kw):
        return LoopConfig(total_steps=6, seq_len=16, global_batch=2, ckpt_every=2, log_every=0,
                          ckpt_dir=str(tmp_path), **kw)

    def test_loss_decreases(self, tmp_path):
        cfg = reduce_config(get_config("phi4-mini-3.8b"))
        loop = LoopConfig(total_steps=30, seq_len=32, global_batch=4, ckpt_every=0,
                          log_every=0, ckpt_dir=str(tmp_path), lr=3e-3, warmup=5)
        hist = train(cfg, loop, device="cpu")
        first = np.mean([h["loss"] for h in hist[:5]])
        last = np.mean([h["loss"] for h in hist[-5:]])
        assert last < first - 0.2, (first, last)

    @pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "xlstm-125m"])
    def test_restart_resumes_exactly(self, tmp_path, arch):
        """Crash at step 4, relaunch, and the combined trajectory matches an
        uninterrupted run (xlstm-125m, as in the reference's test, and
        h2o-danube)."""
        cfg = reduce_config(get_config(arch))
        ref = train(cfg, self._loop_cfg(tmp_path / "ref", resume=False), device="cpu")
        with pytest.raises(RuntimeError, match="injected failure"):
            train(cfg, self._loop_cfg(tmp_path / "ft", fail_at_step=4), device="cpu")
        hist2 = train(cfg, self._loop_cfg(tmp_path / "ft"), device="cpu")
        assert hist2[0]["step"] == 4  # the step-3 checkpoint resumes at 4
        ref_by_step = {h["step"]: h["loss"] for h in ref}
        for h in hist2:
            np.testing.assert_allclose(h["loss"], ref_by_step[h["step"]], rtol=2e-4)

    def test_grad_compression_trains(self, tmp_path):
        cfg = reduce_config(get_config("phi4-mini-3.8b"))
        loop = LoopConfig(total_steps=12, seq_len=16, global_batch=2, ckpt_every=0,
                          log_every=0, ckpt_dir=str(tmp_path), grad_compression="int8",
                          lr=2e-3, warmup=2)
        hist = train(cfg, loop, device="cpu")
        assert hist[-1]["loss"] < hist[0]["loss"] + 0.05
        assert all(np.isfinite(h["loss"]) for h in hist)

    def test_train_defaults_to_the_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("checks the behaviour without a CUDA card")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train(reduce_config(get_config("h2o-danube-1.8b")), self._loop_cfg(tmp_path))


# ---------------------------------------------------------------------------
# the refusals this slice lifted, as behaviour
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma-7b"])
def test_forward_logits_features(arch):
    """mode "features" returns the final-normed features; projecting them
    gives mode "train"'s logits, and both match the reference's."""
    jcfg, cfg = _cfgs(arch)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    p = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = _batch(cfg)["tokens"]
    feats, aux, caches = transformer.forward_logits(p, cfg, {"tokens": torch.from_numpy(toks)},
                                                    mode="features")
    jfeats, _, _ = jtransformer.forward_logits(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                               mode="features")
    assert feats.shape == (2, 24, cfg.d_model) and float(aux) == 0.0 and caches == {}
    assert _rel(feats, jfeats) <= 1e-5
    logits, _, _ = transformer.forward_logits(p, cfg, {"tokens": torch.from_numpy(toks)})
    w = p["embed"]["embed"].T if cfg.tie_embeddings else p["lm_head"]["kernel"]
    assert torch.allclose(feats.float() @ w.float(), logits, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="mode"):
        transformer.forward_logits(p, cfg, {"tokens": torch.from_numpy(toks)}, mode="decode")


def test_train_input_specs_and_concrete_batch():
    for arch in DENSE_ARCHS:
        cfg, jcfg = get_config(arch), jget(arch)
        ours = make_input_specs(cfg, SHAPES["train_4k"])
        ref = jinput_specs(jcfg, JSHAPES["train_4k"])
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert tuple(ours[k].shape) == tuple(ref[k].shape), k
            assert str(ours[k].dtype).removeprefix("torch.") == str(ref[k].dtype), k
    cfg = reduce_config(get_config("h2o-danube-1.8b"))
    cell = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=2)
    b = concrete_batch(cfg, cell, torch.Generator().manual_seed(0))
    assert b["tokens"].shape == (2, 16) and b["tokens"].dtype == torch.int32
    assert int(b["labels"].max()) < cfg.vocab_size and bool((b["loss_mask"] == 1).all())
    loss, metrics = build_model(cfg, device="cpu").loss_fn(
        build_model(cfg, device="cpu").init(0), b)
    assert torch.isfinite(loss) and float(metrics["aux"]) == 0.0


# ---------------------------------------------------------------------------
# the routing repair: a call that needs a gradient never reaches the kernel
# ---------------------------------------------------------------------------


def test_flash_routing_under_grad_and_no_grad(monkeypatch):
    """With the device check stubbed to "on the card", a prefill-shaped call
    inside the kernel's contract reaches the flash wrapper under no_grad (and
    with inputs that need no gradient), and the einsum path under grad with
    inputs that require it; the gradients flow to q, k and v."""
    calls = []

    def fake_flash(q, k, v, **kw):
        calls.append(q.requires_grad)
        return attention._grouped_attend_dense(q, k, v, causal=kw["causal"], window=kw["window"])

    monkeypatch.setattr(attention, "_on_card", lambda q: True)
    monkeypatch.setattr(attention, "flash_attention_bshd", fake_flash)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 6, 4, 80, generator=g)
    k, v = torch.randn(1, 6, 2, 80, generator=g), torch.randn(1, 6, 2, 80, generator=g)
    with torch.no_grad():
        attention.grouped_attend(q.requires_grad_(), k, v, causal=True, q_offset=0)
    q = q.detach()
    attention.grouped_attend(q, k, v, causal=True, q_offset=0)  # nothing requires grad
    assert calls == [True, False]
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = attention.grouped_attend(qg, kg, vg, causal=True, q_offset=0)
    assert len(calls) == 2  # the einsum path
    out.square().sum().backward()
    assert all(t.grad is not None and float(t.grad.abs().max()) > 0 for t in (qg, kg, vg))


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_wrapper_refuses_inputs_that_need_a_gradient(layout):
    fn = fa.flash_attention_bshd if layout == "bshd" else fa.flash_attention
    q = torch.randn(1, 4, 4, 32, requires_grad=True)
    k = v = torch.randn(1, 4, 4, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(q, k, v, causal=True)
    with torch.no_grad():
        assert fn(q, k, v, causal=True).shape == q.shape


# ---------------------------------------------------------------------------
# parity: loss, gradients, one step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk", [(24, 1024), (40, 16), (37, 8)])
def test_cross_entropy_matches_reference(s, chunk):
    """A padded vocab (100 of 128 columns), a partial mask, and S a multiple
    of the chunk or not."""
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 16)).astype(np.float32)
    w = rng.normal(size=(16, 128)).astype(np.float32)
    labels = rng.integers(0, 100, (2, s)).astype(np.int32)
    mask = (rng.random((2, s)) > 0.4).astype(np.float32)
    ours = layers.cross_entropy_from_features(torch.from_numpy(x), torch.from_numpy(w),
                                              torch.from_numpy(labels), 100,
                                              torch.from_numpy(mask), chunk=chunk)
    ref = jlayers.cross_entropy_from_features(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                                              100, jnp.asarray(mask), chunk=chunk)
    assert _rel(ours, ref) <= CE_RTOL
    logits = x @ w
    for m in (None, mask):
        ours = layers.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), 100,
                                         None if m is None else torch.from_numpy(m))
        ref = jlayers.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), 100,
                                         None if m is None else jnp.asarray(m))
        assert _rel(ours, ref) <= CE_RTOL


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma-7b", "deepseek-v2-lite-16b"])
def test_loss_and_grads_match_reference(arch, remat):
    jcfg, cfg = _cfgs(arch, remat=remat)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    p = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    b = _batch(cfg)
    (jl, jmet), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, _jbatch(b))
    model = build_model(cfg, device="cpu")
    _, met = model.loss_fn(p, _tbatch(b))
    loss, grads = steps.loss_and_grads(model, p, _tbatch(b))
    assert _rel(loss, jl) <= GRAD_RTOL and _rel(met["ce"], jmet["ce"]) <= GRAD_RTOL
    _hold_leaves(grads, jg, GRAD_RTOL, "grads")


# The recurrent archs' gradient leaves against the reference's, relative to
# each leaf's largest magnitude (the port reads 1.1e-5 jamba, 2.2e-5 xlstm;
# the loss itself stays within GRAD_RTOL; GRAD_RTOL holds the dense family).
# Basis (tools/recurrent_grad_margin.py --device cuda, NVIDIA H100 80GB
# HBM3, 700.00 W): these gradients are that sensitive. One f32 rounding of
# every parameter moves the host CPU's own leaves by up to 6.3e-5, and the
# card against the host CPU reads up to 1.0e-4 (xlstm; jamba 1.6e-5) over
# seeds 0-4 and two steps. The subtlest planted fault (sLSTM's normaliser
# clamp dropped) reads 0.22. The limit sits 5x above the one, 440x below
# the other.
RECURRENT_GRAD_RTOL = 5e-4


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_recurrent_loss_and_grads_match_reference(arch, remat):
    """Reduced jamba (Mamba, attention, MoE) and xlstm-125m (mLSTM, sLSTM):
    the loss and CE within GRAD_RTOL, every gradient leaf within
    RECURRENT_GRAD_RTOL of the reference's, remat on and off."""
    jcfg, cfg = _cfgs(arch, remat=remat)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    p = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    b = _batch(cfg)
    (jl, jmet), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, _jbatch(b))
    loss, grads = steps.loss_and_grads(build_model(cfg, device="cpu"), p, _tbatch(b))
    assert _rel(loss, jl) <= GRAD_RTOL
    _hold_leaves(grads, jg, RECURRENT_GRAD_RTOL, "grads")


def _warm_reference(jcfg, name, mb, comp, data):
    """The reference's params and state after two steps, and its third."""
    jstep, jo, _ = jsteps.make_train_step(jcfg, optimizer=name, microbatch=mb,
                                          grad_compression=comp, lr=1e-3, warmup=2,
                                          total_steps=100)
    jstep = jax.jit(jstep)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    js = jo.init(jp)
    for s in range(2):
        jp, js, _ = jstep(jp, js, _jbatch(data.batch(s)), jnp.asarray(s, jnp.int32))
    jp3, js3, jmet = jstep(jp, js, _jbatch(data.batch(2)), jnp.asarray(2, jnp.int32))
    return jp, js, jp3, js3, jmet


MAX_INT8_FLIPS = 4


def _int8_flips(jcfg, cfg, jp, batch):
    """keystr of each parameter -> the elements whose int8 gradient quantum
    differs between the packages (|q - q_ref| above half a quantum): the
    gradients agree to ~1e-6, but an element within that of a rounding
    boundary of g / scale lands on the other quantum, and AdamW moves it by
    a whole quantum's share of lr."""
    (_, _), jg = jax.value_and_grad(jbuild(jcfg).loss_fn, has_aux=True)(jp, _jbatch(batch))
    p = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    _, g = steps.loss_and_grads(build_model(cfg, device="cpu"), p, _tbatch(batch))
    ours = tree.leaves(make_compressor("int8")(g))
    theirs = jax.tree.leaves(jopt.make_compressor("int8")(jg))
    flips = {}
    for (path, _), a, b in zip(jax.tree_util.tree_flatten_with_path(jg)[0], ours, theirs):
        b = _np(b)
        flips[jax.tree_util.keystr(path)] = np.abs(_np(a) - b) > 0.5 * np.abs(b).max() / 127
    return flips


def _state_skip(flips):
    """The flips under the elementwise states' names (AdamW's mu / nu, SGD's
    mom, Adafactor's unfactored v); factored vr / vc keep every element."""
    out = {}
    for name, mask in flips.items():
        for top in ("['mu']", "['nu']", "['mom']"):
            out[top + name] = mask
        out[name + "['v']"] = mask
    return out


@pytest.mark.parametrize("mb,comp", [(0, "none"), (2, "none"), (0, "int8")])
@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_train_step_matches_reference(name, mb, comp):
    """With int8 compression, elements whose gradient quantum flips between
    the packages (at most MAX_INT8_FLIPS in the tree; one here) are left out
    of the 1e-5 comparison."""
    jcfg, cfg = _cfgs("h2o-danube-1.8b")
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=24, global_batch=4))
    jp, js, jp3, js3, jmet = _warm_reference(jcfg, name, mb, comp, data)
    step, opt, _ = steps.make_train_step(cfg, optimizer=name, microbatch=mb, grad_compression=comp,
                                         lr=1e-3, warmup=2, total_steps=100, device="cpu")
    assert opt.name == name
    flips = _int8_flips(jcfg, cfg, jp, data.batch(2)) if comp == "int8" else {}
    assert sum(int(m.sum()) for m in flips.values()) <= MAX_INT8_FLIPS
    p = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    s = opt_state_from_numpy(name, jax.tree.map(np.asarray, js), device="cpu")
    p, s, met = step(p, s, to_device(data.batch(2), "cpu"), torch.tensor(2))
    assert _rel(met["loss"], jmet["loss"]) <= STEP_RTOL
    assert _rel(met["grad_norm"], jmet["grad_norm"]) <= STEP_RTOL
    assert not any(t.requires_grad for t in tree.leaves(p))
    _hold_leaves(lm_params_to_numpy(p), jp3, STEP_RTOL, "params", skip=flips)
    _hold_leaves(opt_state_to_numpy(s), js3, STEP_RTOL, "state", skip=_state_skip(flips))


def test_a_microbatch_that_does_not_divide_the_batch_is_refused():
    """A batch of 5 rows with microbatch 2: the reference's reshape into
    (n, microbatch, ...) fails, and the port refuses it too, rather than
    dropping the row left over."""
    jcfg, cfg = _cfgs("h2o-danube-1.8b")
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=5))
    jstep, jo, jm = jsteps.make_train_step(jcfg, microbatch=2)
    jp = jm.init(jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match="cannot reshape"):
        jstep(jp, jo.init(jp), _jbatch(data.batch(0)), jnp.asarray(0, jnp.int32))
    step, opt, model = steps.make_train_step(cfg, microbatch=2, device="cpu")
    p = model.init(0)
    with pytest.raises(ValueError, match="not a multiple of microbatch 2"):
        step(p, opt.init(p, device="cpu"), to_device(data.batch(0), "cpu"), torch.tensor(0))


def test_default_optimizer_and_serve_steps():
    for arch in DENSE_ARCHS:
        assert steps.default_optimizer(get_config(arch)) == jsteps.default_optimizer(jget(arch))
    jcfg, cfg = _cfgs("h2o-danube-1.8b")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    p = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = _batch(cfg)["tokens"]
    prefill, decode = steps.make_serve_steps(cfg, device="cpu")
    jprefill, jdecode = jsteps.make_serve_steps(jcfg)
    last, caches = prefill(p, {"tokens": torch.from_numpy(toks)})
    jlast, jcaches = jprefill(jp, {"tokens": jnp.asarray(toks)})
    assert _rel(last, jlast) <= 1e-5
    caches = transformer.pad_caches(cfg, caches, 32)
    jcaches = jtransformer.pad_caches(jcfg, jcaches, 32)
    tok = np.array([[3], [5]], np.int32)
    pos = np.array([24, 24], np.int32)
    nxt, logits, _ = decode(p, {"tokens": torch.from_numpy(tok), "caches": caches,
                                "pos": torch.from_numpy(pos)})
    jnxt, jlogits, _ = jdecode(jp, {"tokens": jnp.asarray(tok), "caches": jcaches,
                                    "pos": jnp.asarray(pos)})
    assert _rel(logits, jlogits) <= 1e-4
    assert nxt.dtype == torch.int32 and np.array_equal(nxt.numpy(), np.asarray(jnxt))


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16
                else x.numpy())
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def bf16_model():
    """Reduced h2o-danube in bf16 and its AdamW / Adafactor states after one
    reference step, in both packages' trees (the same numbers)."""
    jcfg, cfg = _cfgs("h2o-danube-1.8b", dtype="bfloat16")
    out = {"cfg": cfg, "jcfg": jcfg}
    b = _jbatch(_batch(cfg, partial=False))
    for name in ("adamw", "adafactor"):
        jstep, jo, _ = jsteps.make_train_step(jcfg, optimizer=name, lr=1e-3, warmup=1)
        jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
        jp, js, _ = jax.jit(jstep)(jp, jo.init(jp), b, jnp.asarray(0, jnp.int32))
        out[name] = (jp, js, lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu"),
                     opt_state_from_numpy(name, jax.tree.map(np.asarray, js), device="cpu"))
    return out


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_reference_checkpoint_restores_in_the_port_bit_equal(bf16_model, name, tmp_path):
    jp, js, p, s = bf16_model[name]
    jsave(tmp_path, 3, jp, js, extra={"data_seed": 0})
    p2, s2, extra, step = restore_checkpoint(
        tmp_path, None, transformer.param_template(bf16_model["cfg"]), s, device="cpu")
    assert step == 3 and extra == {"data_seed": 0}
    for a, b in zip(tree.leaves({"p": p2, "s": s2}), jax.tree.leaves({"p": jp, "s": js})):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        assert np.array_equal(_bits(a), _bits(b))
    assert any(t.dtype == torch.bfloat16 for t in tree.leaves(p2))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_port_checkpoint_restores_in_the_reference_bit_equal(bf16_model, name, tmp_path):
    jp, js, p, s = bf16_model[name]
    save_checkpoint(tmp_path / "port", 3, p, s, extra={"data_seed": 0})
    jsave(tmp_path / "ref", 3, jp, js, extra={"data_seed": 0})
    ours = json.loads((tmp_path / "port" / "step_00000003" / "manifest.json").read_text())
    ref = json.loads((tmp_path / "ref" / "step_00000003" / "manifest.json").read_text())
    assert ours == ref  # names in keystr form, numpy dtype names, shapes, extra
    jp2, js2, extra, step = jrestore(tmp_path / "port", None, jp, js)
    assert step == 3 and extra == {"data_seed": 0}
    for a, b in zip(jax.tree.leaves({"p": jp2, "s": js2}), jax.tree.leaves({"p": jp, "s": js})):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
    with np.load(tmp_path / "port" / "step_00000003" / "arrays.npz") as a, \
            np.load(tmp_path / "ref" / "step_00000003" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_port_train_resumes_a_reference_run(tmp_path):
    """The reference trains 6 steps (checkpoints every 2, keep 3); the port
    resumes from a copy of its directory without the last checkpoint and
    runs the rest."""
    jcfg, cfg = _cfgs("h2o-danube-1.8b")
    kw = dict(total_steps=6, seq_len=16, global_batch=2, ckpt_every=2, log_every=0, keep_ckpts=3)
    ref_hist = jtrain(jcfg, JLoopConfig(ckpt_dir=str(tmp_path / "ref"), **kw))
    shutil.copytree(tmp_path / "ref", tmp_path / "port",
                    ignore=shutil.ignore_patterns("step_00000005"))
    assert latest_step(tmp_path / "port") == 3
    hist = train(cfg, LoopConfig(ckpt_dir=str(tmp_path / "port"), **kw), device="cpu")
    assert [h["step"] for h in hist] == [4, 5]
    ref_loss = {h["step"]: h["loss"] for h in ref_hist}
    for h in hist:
        np.testing.assert_allclose(h["loss"], ref_loss[h["step"]], rtol=LOOP_LOSS_RTOL)
    opt_t = steps.make_train_step(cfg, device="cpu")[1].init(transformer.param_template(cfg),
                                                             device="meta")
    p, s, _, _ = restore_checkpoint(tmp_path / "port", 5, transformer.param_template(cfg), opt_t,
                                    device="cpu")
    jm = jbuild(jcfg)
    jt = jax.eval_shape(jm.init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    jp, js, _, _ = jrestore(tmp_path / "ref", 5, jt, jax.eval_shape(jopt.make_adamw().init, jt))
    _hold_leaves(lm_params_to_numpy(p), jp, LOOP_PARAM_RTOL, "params")
    _hold_leaves(opt_state_to_numpy(s), js, LOOP_PARAM_RTOL, "state")


# ---------------------------------------------------------------------------
# the LM layouts against the reference's PartitionSpecs
# ---------------------------------------------------------------------------

MESH_AXES = [((2, 4), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
# deepseek: MLA's leaves (wkv_a replicated, w_uk / w_uv heads on model) and
# its latent cache (c_kv / k_rope), a prefix layer beside the period stack
LAYOUT_ARCHS = DENSE_ARCHS + ["deepseek-v2-lite-16b"]
# jamba, xlstm: the Mamba and xLSTM leaves (in_proj, conv, x_proj, a_log; up /
# down projections, w_if, r_gates) and their recurrent caches (h, conv_tail;
# c, n, m)
LAYOUT_ARCHS += ["jamba-1.5-large-398b", "xlstm-125m"]
# whisper: the unstacked encoder layers, dec_pos, each decoder layer's cross
# block and cross cache, encoder_frames; llava: inputs_embeds
LAYOUT_ARCHS += ["whisper-base", "llava-next-mistral-7b"]


def _specs_equal(ours, ref_shardings):
    theirs = [tuple(s.spec) for s in jax.tree.leaves(ref_shardings)]
    mine = tree.leaves(ours)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a == b, (a, b)


@pytest.mark.parametrize("shape,names", MESH_AXES)
@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_param_specs_match_reference(arch, shape, names):
    jmesh, mesh = JAbstractMesh(shape, names), shd.AbstractMesh(shape, names)
    jcfg, cfg = jget(arch), get_config(arch)
    jt = jax.eval_shape(lambda: jtransformer.init_params(jax.random.PRNGKey(0), jcfg))
    _specs_equal(shd.param_specs(mesh, transformer.param_template(cfg)),
                 jshd.param_shardings(jmesh, jt))
    assert shd.logical_summary(mesh, transformer.param_template(cfg)).count("\n") == len(
        jax.tree.leaves(jt)) - 1


@pytest.mark.parametrize("mode", ["auto", "0", "1"])
@pytest.mark.parametrize("shape,names", MESH_AXES)
@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_batch_and_cache_specs_match_reference(arch, shape, names, mode, monkeypatch):
    monkeypatch.setenv("REPRO_KV_SEQ_SHARD", mode)
    jmesh, mesh = JAbstractMesh(shape, names), shd.AbstractMesh(shape, names)
    jcfg, cfg = jget(arch), get_config(arch)
    assert shd.kv_seq_mode() == jshd.kv_seq_mode() == mode
    assert shd.want_kv_seq_shard(cfg.num_kv_heads, mesh) == jshd.want_kv_seq_shard(
        jcfg.num_kv_heads, jmesh)
    for cell in ("train_4k", "decode_32k", "long_500k"):
        ours = make_input_specs(cfg, SHAPES[cell])
        ref = jinput_specs(jcfg, JSHAPES[cell])
        _specs_equal(shd.batch_specs(mesh, ours), jshd.batch_shardings(jmesh, ref))
        if cell == "train_4k":
            _specs_equal(shd.batch_specs(mesh, ours, seq_axis="model"),
                         jshd.batch_shardings(jmesh, ref, seq_axis="model"))
    caches = transformer.cache_specs(cfg, 6, 4096)  # a batch the data axes do not divide
    jcaches = jtransformer.cache_specs(jcfg, 6, 4096)
    for (path, leaf), (jpath, jleaf) in zip(tree.leaves_with_path({"caches": caches}),
                                            jax.tree_util.tree_flatten_with_path(
                                                {"caches": jcaches})[0]):
        assert shd.cache_spec_for(tree.path_str(path), leaf, mesh) == tuple(
            jshd.cache_spec_for(jshd._path_str(jpath), jleaf, jmesh))


def test_constraints_refuse_a_model_axis():
    """constrain is the identity with or without a registered mesh (the
    port's collectives are explicit); a model axis of 2 registers and runs
    deepseek-v2-lite's MLA (item 13j), and an axis that does not divide its
    heads is refused."""
    x = torch.ones(2, 3)
    assert shd.constrain(x, shd.BATCH, None) is x  # no mesh registered
    one = shd.AbstractMesh((2, 1), ("data", "model"))
    two = shd.AbstractMesh((2, 2), ("data", "model"))
    for mesh in (one, two):
        shd.enable_constraints(mesh)
        try:
            assert shd.constrain(x, shd.BATCH, shd.MODEL) is x
        finally:
            shd.enable_constraints(None)
    from repro_torch.distributed import tensor_parallel as tp

    mla = reduce_config(get_config("deepseek-v2-lite-16b"))
    tp.check_supported(mla, two, serving=True)
    with pytest.raises(NotImplementedError, match="not a multiple of it"):
        tp.check_supported(mla, shd.AbstractMesh((1, 3), ("data", "model")))


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_state_specs_match_reference(name):
    jmesh, mesh = JAbstractMesh((2, 4), ("data", "model")), shd.AbstractMesh((2, 4),
                                                                            ("data", "model"))
    jcfg, cfg = jget("h2o-danube-1.8b"), get_config("h2o-danube-1.8b")
    jt = jax.eval_shape(lambda: jtransformer.init_params(jax.random.PRNGKey(0), jcfg))
    jo, opt = jopt.make_optimizer(name), steps.make_train_step(
        reduce_config(cfg), optimizer=name, device="cpu")[1]
    pt = transformer.param_template(cfg)
    _specs_equal(opt.state_specs(mesh, shd.param_specs(mesh, pt), pt),
                 jo.state_shardings(jmesh, jshd.param_shardings(jmesh, jt), jt))
