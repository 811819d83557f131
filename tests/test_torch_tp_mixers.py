"""Tensor parallelism for MLA, Mamba, xLSTM and whisper, and the
sequence-sharded KV layout, on 2 and 4 gloo ranks (the CPU), against the
reference's unsharded steps.

GSPMD's contract is that a layout does not change the math, and the
reference's own sharded path fails on this tree (ROADMAP queue 3, "Traps"),
so every case is held against the reference's unsharded run on the same
weights and inputs. Train cases (reduced configs, f32):
  deepseek   deepseek-v2-lite (MLA: wq / w_uk / w_uv by heads, wkv_a
             replicated; a dense and an MoE layer)
  jamba      jamba-1.5-large (Mamba's d_inner blocks, in_proj's x | z
             gathered; attention; MoE)
  xlstm      xlstm-125m (mLSTM and sLSTM, 4 heads: 2 a rank)
  h2o        h2o-danube-1.8b
  xlstm_h2   xlstm-125m with 2 heads, on 4 ranks: the layout replicates
             the heads (every rank computes every head, its block of
             d_inner for down_proj), w_gates by gates, the sLSTM FFN's 85
             columns replicated
Serve cases (the kv layout REPRO_KV_SEQ_SHARD picks):
  deepseek_seq    the latent cache over the sequence (auto)
  deepseek_cols   over its columns, r and dr (0)
  jamba, xlstm    auto (jamba's kv heads divide the axis: heads)
  h2o_seq         1, a 7-token prompt: the prefill cache falls back to the
                  heads layout and pad_caches moves it to the sequence
                  layout at 12 rows
  whisper         auto (heads), and whisper_seq under 1: the self and cross
                  caches over the sequence
  deepseek_seq4   on 4 ranks: the prompt's blocks (2 rows) and the
                  capacity's (3) differ, so pad_caches moves rows
  xlstm_h2        on 4 ranks, the replicated-heads fallback

The reference trains each train case for 4 steps (global batch 4, 16
tokens), checkpointing after steps 1 and 3. One spawn of 2 ranks on a (1, 2)
("data", "model") mesh and one of 4 on (1, 4), beside each other (one
subprocess a rank, a FileStore), then, per case: resume a copy of the
step-1 checkpoint and train steps 2 and 3 (rank 0's model group gathers the
final checkpoint leaf by leaf); check the init(0) blocks against the
one-rank init's slices; serve the step-1 weights (whisper: the reference's
init), carried across as blocks by convert.lm_params_from_numpy: a prefill
of 8 tokens at batch 2 (h2o_seq: 7; whisper: with 16 encoder frames),
pad_caches(mesh) to 12, and 3 decode steps with given tokens, through
make_serve_steps on the mesh, each call's collectives counted. whisper,
which train() does not feed (it takes token batches only), is held by
loss_fn and its gradients on a batch carrying encoder_frames.

Tolerances, tests/test_torch_tp.py's with their reasons: losses, grad
norms, every parameter leaf and whisper's loss and gradients within 1e-5
relative (sums in another order across ranks and packages); a k bias,
whose gradient is 0 in exact arithmetic, against the tree's largest;
logits and cache blocks within 1e-5 of the largest magnitude of the
reference's. The recurrent cases' (jamba, xlstm, xlstm_h2) grad norms and
parameters within RECURRENT_GRAD_RTOL 5e-4, the bound PR 26 set from
tools/recurrent_grad_margin.py (tests/test_torch_train.py): one f32
rounding of every parameter moves xlstm's gradient leaves by up to 6.3e-5.
The MoE cases' embedding within MOE_EMBED_RTOL 2e-5, test_torch_tp.py's
bound for an AdamW element whose gradient is near zero. Replicated leaves,
losses and every rank's blocks of what it restored or drew bit-equal.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.configs import reduce_config as jreduce
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild
from repro.models import transformer as jtransformer
from repro.optim import optimizer as jopt
from repro.train import LoopConfig as JLoopConfig
from repro.train import restore_checkpoint as jrestore
from repro.train import train as jtrain
from repro_torch import tree
from repro_torch.configs import get_config, reduce_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import transformer
from repro_torch.train import latest_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
RECURRENT_GRAD_RTOL = 5e-4
MOE_EMBED_RTOL = 2e-5
LOOP = dict(total_steps=4, seq_len=16, global_batch=4, ckpt_every=2, log_every=0, keep_ckpts=3)
B, S, CAPACITY, DECODE = 2, 8, 12, 3
SE, T = 16, 16  # whisper's encoder frames; its loss batch's tokens

# case -> (arch, reduce_config keyword changes); jamba keeps its period's
# first 4 layer specs (3 Mamba layers, the attention layer, 2 MoE MLPs)
ARCHS = {
    "deepseek": ("deepseek-v2-lite-16b", {}),
    "jamba": ("jamba-1.5-large-398b", {"specs": 4}),
    "xlstm": ("xlstm-125m", {}),
    "h2o": ("h2o-danube-1.8b", {}),
    "xlstm_h2": ("xlstm-125m", {"n_heads": 2}),
    "whisper": ("whisper-base", {}),
}
RECURRENT = ("jamba", "xlstm", "xlstm_h2")
MOE = ("deepseek", "jamba")
# world -> the train cases its ranks run
TRAIN = {2: ["deepseek", "jamba", "xlstm", "h2o"], 4: ["deepseek", "xlstm_h2"]}
# serve case -> (world, arch case, REPRO_KV_SEQ_SHARD, prompt tokens)
SERVE = {
    "deepseek_seq": (2, "deepseek", "auto", S),
    "deepseek_cols": (2, "deepseek", "0", S),
    "jamba": (2, "jamba", "auto", S),
    "xlstm": (2, "xlstm", "auto", S),
    "h2o_seq": (2, "h2o", "1", 7),
    "whisper": (2, "whisper", "auto", S),
    "whisper_seq": (2, "whisper", "1", S),
    "deepseek_seq4": (4, "deepseek", "auto", S),
    "xlstm_h2": (4, "xlstm_h2", "auto", S),
}


def _cfg(reduce, get, case):
    arch, kw = ARCHS[case]
    kw = dict(kw)
    specs = kw.pop("specs", None)
    cfg = reduce(get(arch), **kw)
    if specs:
        cfg = dataclasses.replace(cfg, period=cfg.period[:specs], num_layers=specs)
    return cfg


_SCRIPT = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
base = sys.argv[1]
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(base, "store%d" % world), world),
                        rank=rank, world_size=world)

from repro_torch import tree
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import costs, steps
from repro_torch.models import build_model, transformer
from repro_torch.train import LoopConfig, restore_checkpoint, train, train_loop

sys.path.insert(0, os.path.join({ROOT!r}, "tests"))
from test_torch_tp_mixers import B, CAPACITY, DECODE, LOOP, SERVE, TRAIN, _cfg

mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
inputs = np.load(os.path.join(base, "inputs.npz"))
last = {{}}
make = train_loop.steps_mod.make_train_step


def recording(*args, **kw):
    step, opt, model = make(*args, **kw)

    def wrapped(params, opt_state, batch, step_t):
        out = step(params, opt_state, batch, step_t)
        last["params"], last["opt"] = out[0], out[1]
        return out

    return wrapped, opt, model


def weights(cfg, case):
    """A case's serving weights as numpy: the reference's step-1 params, or
    (whisper) its init."""
    path = os.path.join(base, "weights_%s.npz" % case)
    if os.path.exists(path):
        w = np.load(path)
        return tree.unflatten(transformer.param_template(cfg),
                              [w["a%d" % i] for i in range(len(w.files))])
    opt_t = steps.make_train_step(cfg, device="cpu")[1].init(transformer.param_template(cfg),
                                                            device="meta")
    p1 = restore_checkpoint(os.path.join(base, "ref_" + case), 1, transformer.param_template(cfg),
                            opt_t, device="cpu")[0]
    return tree.tree_map(lambda t: t.numpy(), p1)


train_loop.steps_mod.make_train_step = recording
out = {{}}
for case in TRAIN[world]:
    cfg = _cfg(reduce_config, get_config, case)
    loop = LoopConfig(ckpt_dir=os.path.join(base, "tp%d_%s" % (world, case)), **LOOP)
    hist = train(cfg, loop, mesh=mesh, device="cpu")
    out[case + "/steps"] = np.array([h["step"] for h in hist])
    out[case + "/loss"] = np.array([h["loss"] for h in hist])
    out[case + "/grad_norm"] = np.array([h["grad_norm"] for h in hist])
    for i, leaf in enumerate(tree.leaves(last["params"])):
        out["%s/p%d" % (case, i)] = leaf.numpy()
    whole = build_model(cfg, "cpu").init(0)
    blocks = build_model(cfg, "cpu", mesh).init(0)
    specs = shd.param_specs(mesh, transformer.param_template(cfg))
    out[case + "/init_blocks_equal"] = np.array(all(
        torch.equal(tp.block(w, s, mesh), b)
        for w, b, s in zip(tree.leaves(whole), tree.leaves(blocks), tree.leaves(specs))))

if world == 2:  # whisper's loss and gradients
    cfg = _cfg(reduce_config, get_config, "whisper")
    params = lm_params_from_numpy(cfg, weights(cfg, "whisper"), "cpu", mesh)
    batch = {{k: torch.from_numpy(inputs["w_" + k]) for k in
              ("encoder_frames", "tokens", "labels", "loss_mask")}}
    loss, grads = steps.loss_and_grads(build_model(cfg, "cpu", mesh), params, batch)
    out["whisper/grad_loss"] = loss.numpy()
    for i, leaf in enumerate(tree.leaves(grads)):
        out["whisper/g%d" % i] = leaf.numpy()

for case, (w, arch_case, kv, s) in SERVE.items():
    if w != world:
        continue
    os.environ["REPRO_KV_SEQ_SHARD"] = kv
    cfg = _cfg(reduce_config, get_config, arch_case)
    params = lm_params_from_numpy(cfg, weights(cfg, arch_case), "cpu", mesh)
    prefill, decode = steps.make_serve_steps(cfg, "cpu", mesh)
    batch = {{"tokens": torch.from_numpy(inputs["prompt"][:, :s])}}
    if cfg.encoder_layers:
        batch["encoder_frames"] = torch.from_numpy(inputs["frames"])
    counts = []
    with torch.no_grad():
        mode = costs.CostMode(mesh)
        with mode:
            logits, caches = prefill(params, batch)
        mode.close()
        counts.append(mode.count_by_dim.get("model", 0))
        out[case + "/prefill_logits"] = logits.numpy()
        for i, leaf in enumerate(tree.leaves(caches)):
            out["%s/pre%d" % (case, i)] = leaf.numpy().copy()  # decode writes in place
        caches = transformer.pad_caches(cfg, caches, CAPACITY, mesh)
        for i in range(DECODE):
            mode = costs.CostMode(mesh)
            with mode:
                tok, logits, caches = decode(params, {{
                    "tokens": torch.from_numpy(inputs["decode"][:, i:i + 1]), "caches": caches,
                    "pos": torch.full((B,), s + i, dtype=torch.int32)}})
            mode.close()
            counts.append(mode.count_by_dim.get("model", 0))
            out["%s/decode_logits%d" % (case, i)] = logits.numpy()
            out["%s/decode_tok%d" % (case, i)] = tok.numpy()
    out[case + "/counts"] = np.array(counts)
    for i, leaf in enumerate(tree.leaves(caches)):
        out["%s/c%d" % (case, i)] = leaf.numpy()
    os.environ.pop("REPRO_KV_SEQ_SHARD")
np.savez(os.path.join(base, "w%d_rank%d.npz" % (world, rank)), **out)
dist.destroy_process_group()
'''


class _Rank:
    """A (1, m) ("data", "model") mesh as seen from model rank r: layouts
    and tensor_parallel.block, no process group."""

    mesh_dim_names = ("data", "model")

    def __init__(self, r, m=2):
        self.r, self.shape = r, (1, m)

    def get_coordinate(self):
        return [0, self.r]


def _block(a, layout, r, m):
    import torch

    return tp.block(torch.from_numpy(np.array(a)), layout, _Rank(r, m)).numpy()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _whisper_batch(cfg):
    rng = np.random.default_rng(1)
    return dict(
        encoder_frames=(0.02 * rng.standard_normal((B, SE, cfg.d_model))).astype(np.float32),
        tokens=rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        labels=rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        loss_mask=(rng.random((B, T)) > 0.3).astype(np.float32))


def _serve_reference(arch_case, s, weights, inputs):
    """The reference's prefill of s prompt tokens, its caches then and after
    pad_caches and the decode steps, and its logits."""
    jcfg = _cfg(jreduce, jget, arch_case)
    prefill, decode = jsteps.make_serve_steps(jcfg)
    batch = {"tokens": inputs["prompt"][:, :s]}
    if jcfg.encoder_layers:
        batch["encoder_frames"] = inputs["frames"]
    logits, caches = prefill(weights, batch)
    pre = [np.asarray(x) for x in jax.tree.leaves(caches)]
    caches = jtransformer.pad_caches(jcfg, caches, CAPACITY)
    dec = []
    for i in range(DECODE):
        _, lg, caches = decode(weights, {"tokens": inputs["decode"][:, i:i + 1], "caches": caches,
                                         "pos": np.full((B,), s + i, np.int32)})
        dec.append(np.asarray(lg))
    return dict(prefill=np.asarray(logits), decode=dec, pre=pre,
                caches=[np.asarray(x) for x in jax.tree.leaves(caches)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs, gradients and serving outputs, and the ranks'
    outputs ({world: [rank outputs]})."""
    base = tmp_path_factory.mktemp("tpm")
    rng = np.random.default_rng(0)
    wcfg = _cfg(jreduce, jget, "whisper")
    inputs = dict(prompt=rng.integers(0, 512, (B, S), dtype=np.int32),
                  decode=rng.integers(0, 512, (B, DECODE), dtype=np.int32),
                  frames=(0.02 * rng.standard_normal((B, SE, wcfg.d_model))).astype(np.float32))
    inputs.update({"w_" + k: v for k, v in _whisper_batch(wcfg).items()})
    np.savez(base / "inputs.npz", **inputs)
    ref, weights = {}, {}
    script = base / "ranks.py"
    script.write_text(textwrap.dedent(_SCRIPT).format(ROOT=ROOT))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    env.pop("REPRO_KV_SEQ_SHARD", None)
    logs, procs = [], []

    def spawn(world):
        """Start a world's ranks."""
        for r in range(world):
            logs.append(base / f"log{world}_{r}.txt")
            with open(logs[-1], "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, str(script), str(base)], cwd=ROOT, stdout=subprocess.DEVNULL,
                    stderr=err, env=dict(env, RANK=str(r), WORLD_SIZE=str(world))))

    for case in sorted(set(TRAIN[2] + TRAIN[4])):
        jcfg = _cfg(jreduce, jget, case)
        hist = jtrain(jcfg, JLoopConfig(ckpt_dir=str(base / f"ref_{case}"), **LOOP))
        for world in TRAIN:
            if case in TRAIN[world]:
                shutil.copytree(base / f"ref_{case}", base / f"tp{world}_{case}",
                                ignore=shutil.ignore_patterns("step_00000003"))
                assert latest_step(base / f"tp{world}_{case}") == 1
        jt = jax.eval_shape(jbuild(jcfg).init, jax.ShapeDtypeStruct((2,), jax.numpy.uint32))
        jot = jax.eval_shape(jopt.make_optimizer("adamw").init, jt)
        weights[case] = jrestore(base / f"ref_{case}", 1, jt, jot)[0]
        ref[case] = dict(hist=hist, params=[np.asarray(x) for x in
                                            jax.tree.leaves(jrestore(base / f"ref_{case}", 3,
                                                                     jt, jot)[0])])
    jm = jbuild(wcfg)
    weights["whisper"] = jm.init(jax.random.PRNGKey(0))
    np.savez(base / "weights_whisper.npz",
             **{f"a{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(weights["whisper"]))})
    spawn(2)  # the ranks run beside the reference's gradients and serving
    spawn(4)
    errs = []
    try:
        batch = {k[2:]: jax.numpy.asarray(v) for k, v in inputs.items() if k.startswith("w_")}
        (jl, _), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(weights["whisper"], batch)
        ref["whisper"] = dict(loss=float(jl), grads=[np.asarray(x) for x in jax.tree.leaves(jg)])
        served = {}  # (arch case, prompt tokens) -> the reference's outputs (layouts aside)
        for case, (_, arch_case, _, s) in SERVE.items():
            if (arch_case, s) not in served:
                served[arch_case, s] = _serve_reference(arch_case, s, weights[arch_case], inputs)
        serve = {case: served[arch_case, s] for case, (_, arch_case, _, s) in SERVE.items()}
        for log, proc in zip(logs, procs):
            if proc.wait(timeout=400):
                errs.append(f"{log.name} exited {proc.returncode}:\n{log.read_text()[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not errs, "\n".join(errs)
    ranks = {w: [dict(np.load(base / f"w{w}_rank{r}.npz")) for r in range(w)] for w in (2, 4)}
    return dict(base=base, ref=ref, serve=serve, ranks=ranks)


def _leaves(out, case, kind):
    n = len([k for k in out if k.startswith(f"{case}/{kind}") and k[len(case) + len(kind) + 1:]
             .isdigit()])
    return [out[f"{case}/{kind}{i}"] for i in range(n)]


def _pspecs(case, m=2):
    cfg = _cfg(reduce_config, get_config, case)
    return cfg, tree.leaves(shd.param_specs(_Rank(0, m), transformer.param_template(cfg)))


def _whole(ranks, case, kind, specs):
    """Every leaf whole from the ranks' blocks (concatenated over its model
    dim)."""
    parts = [_leaves(r, case, kind) for r in ranks]
    out = []
    for i, s in enumerate(specs):
        d = tp.model_dim(s)
        out.append(parts[0][i] if d is None else np.concatenate([p[i] for p in parts], axis=d))
    return out


def _hold_leaves(ours, theirs, names, case, rtol):
    """Every leaf within rtol (the rules above)."""
    scale = max(float(np.max(np.abs(t))) for t in theirs)
    assert len(ours) == len(theirs) == len(names)
    for name, a, b in zip(names, ours, theirs):
        assert a.shape == b.shape, name
        if "['wk']['bias']" in name:
            assert float(np.max(np.abs(a - b))) <= rtol * scale, name
        elif name == "['embed']['embed']" and case in MOE:
            assert _rel(a, b) <= max(rtol, MOE_EMBED_RTOL), (name, _rel(a, b))
        else:
            assert _rel(a, b) <= rtol, (name, _rel(a, b))


TRAIN_CASES = [(w, c) for w, cases in TRAIN.items() for c in cases]


@pytest.mark.parametrize("world,case", TRAIN_CASES)
def test_train_matches_the_reference(runs, world, case):
    """Steps 2 and 3 on a model axis of 2 or 4, resumed from the
    reference's step-1 checkpoint: losses, grad norms and every parameter
    (the ranks' blocks put together) against the reference's unsharded
    run."""
    out = runs["ranks"][world][0]
    ref = {h["step"]: h for h in runs["ref"][case]["hist"]}
    rtol = RECURRENT_GRAD_RTOL if case in RECURRENT else RTOL
    assert list(out[case + "/steps"]) == [2, 3]
    for step, loss, gnorm in zip(out[case + "/steps"], out[case + "/loss"],
                                 out[case + "/grad_norm"]):
        assert _rel(loss, ref[step]["loss"]) <= RTOL
        assert _rel(gnorm, ref[step]["grad_norm"]) <= rtol
    cfg, specs = _pspecs(case, world)
    names = [tree.keystr(p) for p, _ in tree.leaves_with_path(transformer.param_template(cfg))]
    _hold_leaves(_whole(runs["ranks"][world], case, "p", specs), runs["ref"][case]["params"],
                 names, case, rtol)


@pytest.mark.parametrize("world,case", TRAIN_CASES)
def test_replicated_leaves_and_init_blocks(runs, world, case):
    """Replicated leaves and the losses bit-equal across the ranks; every
    rank's init(0) blocks are the one-rank init's slices."""
    _, specs = _pspecs(case, world)
    outs = runs["ranks"][world]
    replicated = [i for i, s in enumerate(specs) if tp.model_dim(s) is None]
    assert replicated and len(replicated) < len(specs)
    first = _leaves(outs[0], case, "p")
    for out in outs:
        leaves = _leaves(out, case, "p")
        assert all(np.array_equal(leaves[i], first[i]) for i in replicated)
        assert np.array_equal(out[case + "/loss"], outs[0][case + "/loss"])
        assert bool(out[case + "/init_blocks_equal"])


@pytest.mark.parametrize("world,case", TRAIN_CASES)
def test_gathered_checkpoint_is_the_blocks(runs, world, case):
    """The final whole-leaf checkpoint (rank 0's model group gathered it)
    restores in the reference, and each rank's blocks are its slices under
    param_specs, bit for bit."""
    ref = runs["ref"][case]
    jcfg = _cfg(jreduce, jget, case)
    jt = jax.eval_shape(jbuild(jcfg).init, jax.ShapeDtypeStruct((2,), jax.numpy.uint32))
    jot = jax.eval_shape(jopt.make_optimizer("adamw").init, jt)
    jp = [np.asarray(x) for x in
          jax.tree.leaves(jrestore(runs["base"] / f"tp{world}_{case}", 3, jt, jot)[0])]
    _, specs = _pspecs(case, world)
    for r, out in enumerate(runs["ranks"][world]):
        for g, w, s in zip(_leaves(out, case, "p"), jp, specs):
            assert np.array_equal(g, _block(w, s, r, world)), s
    assert len(jp) == len(ref["params"])


def test_whisper_loss_and_gradients_match_the_reference(runs):
    """whisper's loss_fn on a batch with encoder frames, and every gradient
    leaf (the ranks' blocks put together: the encoder's layers too), against
    the reference's jax.value_and_grad."""
    ref = runs["ref"]["whisper"]
    outs = runs["ranks"][2]
    for out in outs:
        assert _rel(out["whisper/grad_loss"], ref["loss"]) <= RTOL
    cfg, specs = _pspecs("whisper")
    names = [tree.keystr(p) for p, _ in tree.leaves_with_path(transformer.param_template(cfg))]
    grads = _whole(outs, "whisper", "g", specs)
    _hold_leaves(grads, ref["grads"], names, "whisper", RTOL)
    assert any(n.startswith("['encoder']") and tp.model_dim(s) is not None
               for n, s in zip(names, specs))


def _cache_layouts(case, m, capacity):
    """cache_spec_for's layouts of a serve case's whole caches at
    `capacity` rows (a prefill's: its prompt length), under its kv mode."""
    _, arch_case, _, _ = SERVE[case]
    cfg = _cfg(reduce_config, get_config, arch_case)
    specs = transformer.cache_specs(cfg, B, capacity, enc_seq=SE)
    return [shd.cache_spec_for(tree.path_str(p), s, _Rank(0, m))
            for p, s in tree.leaves_with_path(specs)]


@pytest.mark.parametrize("case", list(SERVE))
def test_prefill_and_decode_match_the_reference(runs, case, monkeypatch):
    """make_serve_steps on the mesh: each rank's vocab block of the prefill
    and decode logits, its greedy token, and its cache blocks after the
    prefill and after pad_caches and the decode steps, against the
    reference's (cache_spec_for's layout of its whole caches: at the
    prompt's length, then at the capacity)."""
    world, arch_case, kv, s = SERVE[case]
    monkeypatch.setenv("REPRO_KV_SEQ_SHARD", kv)
    ref = runs["serve"][case]
    cfg = _cfg(reduce_config, get_config, arch_case)
    before, after = _cache_layouts(case, world, s), _cache_layouts(case, world, CAPACITY)
    for r, out in enumerate(runs["ranks"][world]):
        n = out[case + "/prefill_logits"].shape[-1]
        assert n == cfg.padded_vocab // world
        cut = slice(r * n, (r + 1) * n)
        assert _rel(out[case + "/prefill_logits"], ref["prefill"][..., cut]) <= RTOL
        for i in range(DECODE):
            assert _rel(out[f"{case}/decode_logits{i}"], ref["decode"][i][..., cut]) <= RTOL
            assert np.array_equal(out[f"{case}/decode_tok{i}"],
                                  np.argmax(ref["decode"][i][:, -1], axis=-1))
        for kind, want, layouts in (("pre", ref["pre"], before), ("c", ref["caches"], after)):
            got = _leaves(out, case, kind)
            assert len(got) == len(want) == len(layouts)
            for g, w, lay in zip(got, want, layouts):
                assert _rel(g, _block(w, lay, r, world)) <= RTOL, (kind, lay)


@pytest.mark.parametrize("case,prompt_dim,capacity_dim", [
    ("h2o_seq", 2, 1), ("deepseek_seq", 1, 1), ("deepseek_seq4", 1, 1), ("deepseek_cols", 2, 2),
    ("whisper_seq", 1, 1), ("whisper", 2, 2)])
def test_cache_layouts_follow_the_length(case, prompt_dim, capacity_dim, monkeypatch):
    """The layout of a self cache follows its length: h2o's 7-token prompt
    on 2 ranks falls back to the kv heads, its 12-row cache goes over the
    sequence; MLA's latent cache goes over the sequence under auto (on 4
    ranks 2 prompt rows a rank, then 3: rows move), over r under 0."""
    world, arch_case, kv, s = SERVE[case]
    monkeypatch.setenv("REPRO_KV_SEQ_SHARD", kv)
    before, after = _cache_layouts(case, world, s), _cache_layouts(case, world, CAPACITY)
    # the last leaf is a period's self cache (stacked: its dims after the periods' axis)
    assert tp.model_dim(before[-1]) - 1 == prompt_dim
    assert tp.model_dim(after[-1]) - 1 == capacity_dim


@pytest.mark.parametrize("case", list(SERVE))
def test_collectives_equal_the_dry_run(runs, case, monkeypatch):
    """Each prefill and decode call issues as many collectives on "model" on
    every rank (costs.CostMode), every decode step alike, as many as the dry
    run of the same cell over a fake group of the world's size counts."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun

    world, arch_case, kv, s = SERVE[case]
    monkeypatch.setenv("REPRO_KV_SEQ_SHARD", kv)
    counts = [out[case + "/counts"] for out in runs["ranks"][world]]
    assert all(np.array_equal(c, counts[0]) for c in counts)
    cfg = _cfg(reduce_config, get_config, arch_case)
    with dryrun.fake_world(world):
        mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
        want = [dryrun.lower_step(cfg, ShapeCell("tp", n, B, kind), mesh, "cpu", enc_seq=SE)[
            "collective_counts_by_dim"]["model"] for n, kind in ((s, "prefill"),
                                                                 (CAPACITY, "decode"))]
    assert counts[0].tolist() == want[:1] + want[1:] * DECODE, (counts[0], want)
