"""Tensor parallelism (a "model" axis of 2) for the dense and MoE families on 2
gloo ranks (the CPU), against the reference's unsharded steps.

GSPMD's contract is that a layout does not change the math, and the
reference's own sharded path fails on this tree (ROADMAP queue 3, "Traps"),
so the port's tensor-parallel steps are held against the reference's
unsharded ones on the same inputs and weights. Cases (reduced configs, f32):
  h2o          h2o-danube-1.8b (sliding window, GQA 4 / 4)
  gemma        gemma-7b (tied head, scaled embedding, GeGLU)
  command_r    command-r-plus-104b (parallel block: one all-reduce of the
               attention's and the MLP's partials; layernorm), trained with
               Adafactor and the int8 compressor
  qwen_experts qwen2-moe-a2.7b, 8 experts over "model" (4 a rank), shared
               expert, q / k / v biases
  qwen_ff      the same with 5 experts, which the axis does not divide: each
               rank holds every expert's block of d_ff columns
  kv_split     h2o-danube with 1 kv head: wk / wv's 16 columns split inside
               the head, so k and v are gathered over "model"; its caches
               (REPRO_KV_SEQ_SHARD=0) are each rank's head_dim columns

A second spawn of 4 ranks on a (2, 2) mesh trains h2o the same way, data
and model parallel at once, beside the first.

The reference trains each case for 4 steps (global batch 4, 16 tokens),
checkpointing after steps 1 and 3. One spawn of 2 ranks (one subprocess
each, a FileStore, a (1, 2) ("data", "model") mesh, started once for the
module) then, per case: resumes a copy of the step-1 checkpoint and trains
steps 2 and 3 (the reference's whole-leaf checkpoint sliced into each rank's
blocks; rank 0's model group gathers the final checkpoint leaf by leaf);
checks its init(0) blocks against the one-rank init's slices; and serves
the step-1 weights, carried across by convert.lm_params_from_numpy as
blocks: a prefill of 8 tokens at batch 2, pad_caches to 12, and 3 decode
steps with given tokens, through make_serve_steps on the mesh.

Tolerances: losses, grad norms and every parameter leaf within 1e-5
relative (the data-parallel tests' bound: sums in another order across
ranks and packages); a k bias, whose gradient is 0 in exact arithmetic (it
adds q.b to every logit of a row), against the tree's largest magnitude
(tests/test_torch_encdec.py's rule); the MoE cases' embedding within
MOE_EMBED_RTOL 2e-5: an AdamW element whose gradient is near zero moves by
the normalised step whatever its size, and the port's own one-rank run of
qwen_ff's steps reads 7.8e-6 on that leaf against the reference (element
(505, 8) moved 4.46e-6 in the reference, 5.09e-6 in the port). Logits and
cache blocks within 1e-5 of
the largest magnitude of the reference's. Replicated leaves and every
rank's blocks of what it restored or drew bit-equal.
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
from repro_torch.configs import get_config, list_configs, reduce_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import transformer
from repro_torch.train import latest_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
MOE_EMBED_RTOL = 2e-5
MAX_INT8_FLIPS = 4  # tests/test_torch_train.py's bound on int8 quanta that flip
LOOP = dict(total_steps=4, seq_len=16, global_batch=4, ckpt_every=2, log_every=0, keep_ckpts=3)
B, S, CAPACITY, DECODE = 2, 8, 12, 3

# case -> (arch, config changes, loop changes)
CASES = {
    "h2o": ("h2o-danube-1.8b", {}, {}),
    "gemma": ("gemma-7b", {}, {}),
    "command_r": ("command-r-plus-104b", {}, dict(optimizer="adafactor", grad_compression="int8")),
    "qwen_experts": ("qwen2-moe-a2.7b", {}, {}),
    "qwen_ff": ("qwen2-moe-a2.7b", {"num_experts": 5}, {}),
    "kv_split": ("h2o-danube-1.8b", {"num_kv_heads": 1}, {}),
}


def _cfg(reduce, get, case):
    arch, change, _ = CASES[case]
    cfg = reduce(get(arch))
    if "num_experts" in change:
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **change))
    return dataclasses.replace(cfg, **change)


def _kv_mode(case):
    return "0" if case == "kv_split" else "auto"


_SCRIPT = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
base = sys.argv[1]
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(base, "store%d" % world), world),
                        rank=rank, world_size=world)
grid = world == 4  # a (2, 2) mesh: h2o's training only

from repro_torch import tree
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import costs, steps
from repro_torch.models import build_model, transformer
from repro_torch.train import LoopConfig, restore_checkpoint, train, train_loop

sys.path.insert(0, os.path.join({ROOT!r}, "tests"))
from test_torch_tp import B, CAPACITY, CASES, DECODE, LOOP, S, _cfg, _kv_mode

mesh = init_device_mesh("cpu", (2, 2) if grid else (1, 2), mesh_dim_names=("data", "model"))
inputs = np.load(os.path.join(base, "inputs.npz"))
last = {{}}
make = train_loop.steps_mod.make_train_step


def recording(*args, **kw):
    step, opt, model = make(*args, **kw)

    def wrapped(params, opt_state, batch, step_t):
        out, c = costs.measure(step, params, opt_state, batch, step_t, mesh=mesh)
        last["params"], last["opt"] = out[0], out[1]
        last["reduce"] = c["collectives"]["all-reduce"]["count"]
        last["gather"] = c["collectives"]["all-gather"]["count"]
        return out

    return wrapped, opt, model


train_loop.steps_mod.make_train_step = recording
out = {{}}
for case in ["h2o"] if grid else CASES:
    cfg = _cfg(reduce_config, get_config, case)
    loop = LoopConfig(ckpt_dir=os.path.join(base, ("grid_" if grid else "tp_") + case),
                      **dict(LOOP, **CASES[case][2]))
    hist = train(cfg, loop, mesh=mesh, device="cpu")
    out[case + "/train_reduce"] = np.array(last["reduce"])  # the last step's
    out[case + "/train_gather"] = np.array(last["gather"])
    out[case + "/steps"] = np.array([h["step"] for h in hist])
    out[case + "/loss"] = np.array([h["loss"] for h in hist])
    out[case + "/grad_norm"] = np.array([h["grad_norm"] for h in hist])
    for i, leaf in enumerate(tree.leaves(last["params"])):
        out["%s/p%d" % (case, i)] = leaf.numpy()
    for i, leaf in enumerate(tree.leaves(last["opt"])):
        out["%s/o%d" % (case, i)] = leaf.numpy()
    if grid:
        continue

    whole = build_model(cfg, "cpu").init(0)
    blocks = build_model(cfg, "cpu", mesh).init(0)
    specs = shd.param_specs(mesh, transformer.param_template(cfg))
    out[case + "/init_blocks_equal"] = np.array(all(
        torch.equal(tp.block(w, s, mesh), b)
        for w, b, s in zip(tree.leaves(whole), tree.leaves(blocks), tree.leaves(specs))))

    # serve the step-1 weights
    os.environ["REPRO_KV_SEQ_SHARD"] = _kv_mode(case)
    opt_t = steps.make_train_step(cfg, device="cpu", optimizer=loop.optimizer)[1].init(
        transformer.param_template(cfg), device="meta")
    p1 = restore_checkpoint(os.path.join(base, "ref_" + case), 1, transformer.param_template(cfg),
                            opt_t, device="cpu")[0]
    params = lm_params_from_numpy(cfg, lm_params_to_numpy(p1), "cpu", mesh)
    prefill, decode = steps.make_serve_steps(cfg, "cpu", mesh)
    mode = costs.CostMode(mesh)
    with torch.no_grad(), mode:
        logits, caches = prefill(params, {{"tokens": torch.from_numpy(inputs["prompt"])}})
        caches = transformer.pad_caches(cfg, caches, CAPACITY)
        out[case + "/prefill_logits"] = logits.numpy()
        for i in range(DECODE):
            tok, logits, caches = decode(params, {{
                "tokens": torch.from_numpy(inputs["decode"][:, i:i + 1]), "caches": caches,
                "pos": torch.full((B,), S + i, dtype=torch.int32)}})
            out["%s/decode_logits%d" % (case, i)] = logits.numpy()
            out["%s/decode_tok%d" % (case, i)] = tok.numpy()
    mode.close()
    out[case + "/serve_gather"] = np.array(mode.collectives["all-gather"]["count"])
    for i, leaf in enumerate(tree.leaves(caches)):
        out["%s/c%d" % (case, i)] = leaf.numpy()
    os.environ.pop("REPRO_KV_SEQ_SHARD")
np.savez(os.path.join(base, ("grid%d.npz" if grid else "rank%d.npz") % rank), **out)
dist.destroy_process_group()
'''


class _Rank:
    """A (1, 2) ("data", "model") mesh as seen from model rank r: layouts
    and tensor_parallel.block, no process group."""

    shape = (1, 2)
    mesh_dim_names = ("data", "model")

    def __init__(self, r):
        self.r = r

    def get_coordinate(self):
        return [0, self.r]


def _block(a, layout, r):
    import torch

    return tp.block(torch.from_numpy(np.array(a)), layout, _Rank(r)).numpy()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs and serving outputs, and the 2 ranks' outputs."""
    base = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    inputs = dict(prompt=rng.integers(0, 512, (B, S), dtype=np.int32),
                  decode=rng.integers(0, 512, (B, DECODE), dtype=np.int32))
    np.savez(base / "inputs.npz", **inputs)
    ref = {}
    for case, (_, _, loop_kw) in CASES.items():
        jcfg = _cfg(jreduce, jget, case)
        hist = jtrain(jcfg, JLoopConfig(ckpt_dir=str(base / f"ref_{case}"), **LOOP, **loop_kw))
        shutil.copytree(base / f"ref_{case}", base / f"tp_{case}",
                        ignore=shutil.ignore_patterns("step_00000003"))
        assert latest_step(base / f"tp_{case}") == 1
        jt = jax.eval_shape(jbuild(jcfg).init, jax.ShapeDtypeStruct((2,), jax.numpy.uint32))
        jot = jax.eval_shape(jopt.make_optimizer(loop_kw.get("optimizer") or "adamw").init, jt)
        p1 = jrestore(base / f"ref_{case}", 1, jt, jot)[0]
        p3, o3 = jrestore(base / f"ref_{case}", 3, jt, jot)[:2]
        prefill, decode = jsteps.make_serve_steps(jcfg)
        logits, caches = prefill(p1, {"tokens": inputs["prompt"]})
        caches = jtransformer.pad_caches(jcfg, caches, CAPACITY)
        dec = []
        for i in range(DECODE):
            _, lg, caches = decode(p1, {"tokens": inputs["decode"][:, i:i + 1], "caches": caches,
                                        "pos": np.full((B,), S + i, np.int32)})
            dec.append(np.asarray(lg))
        ref[case] = dict(hist=hist, params=[np.asarray(x) for x in jax.tree.leaves(p3)],
                         opt=[np.asarray(x) for x in jax.tree.leaves(o3)],
                         prefill=np.asarray(logits), decode=dec,
                         caches=[np.asarray(x) for x in jax.tree.leaves(caches)], jt=jt, jot=jot)

    shutil.copytree(base / "ref_h2o", base / "grid_h2o",
                    ignore=shutil.ignore_patterns("step_00000003"))
    script = base / "ranks.py"
    script.write_text(textwrap.dedent(_SCRIPT).format(ROOT=ROOT))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    env.pop("REPRO_KV_SEQ_SHARD", None)
    procs = [subprocess.Popen([sys.executable, str(script), str(base)], cwd=ROOT,
                              env=dict(env, RANK=str(r), WORLD_SIZE=str(world)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for world in (2, 4) for r in range(world)]
    errs = []
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=300)
            if proc.returncode:
                errs.append(f"rank {r} exited {proc.returncode}:\n{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not errs, "\n".join(errs)
    ranks = [dict(np.load(base / f"rank{r}.npz")) for r in range(2)]
    grid = [dict(np.load(base / f"grid{r}.npz")) for r in range(4)]
    return dict(base=base, ref=ref, ranks=ranks, grid=grid)


def _leaves(out, case, kind):
    n = len([k for k in out if k.startswith(f"{case}/{kind}") and k[len(case) + 2:].isdigit()])
    return [out[f"{case}/{kind}{i}"] for i in range(n)]


def _pspecs(case):
    cfg = _cfg(reduce_config, get_config, case)
    return cfg, tree.leaves(shd.param_specs(_Rank(0), transformer.param_template(cfg)))


def _whole(ranks, case, kind, specs):
    """Every leaf whole from the 2 ranks' blocks (concatenated over its
    model dim)."""
    a, b = (_leaves(r, case, kind) for r in ranks)
    out = []
    for x, y, s in zip(a, b, specs):
        d = tp.model_dim(s)
        out.append(x if d is None else np.concatenate([x, y], axis=d))
    return out


def _hold_leaves(ours, theirs, names, case, flips=0):
    """Every leaf within RTOL (the rules above). flips > 0: up to that many
    elements of Adafactor's factored states (vr / vc) may read above it."""
    scale = max(float(np.max(np.abs(t))) for t in theirs)
    for name, a, b in zip(names, ours, theirs):
        if flips and name.endswith(("['vr']", "['vc']")):
            off = int(np.sum(np.abs(a - b) > RTOL * np.max(np.abs(b))))
            assert off <= flips, (name, off)
            flips -= off
        elif "['wk']['bias']" in name:
            assert float(np.max(np.abs(a - b))) <= RTOL * scale, name
        elif name == "['embed']['embed']" and case.startswith("qwen"):
            assert _rel(a, b) <= MOE_EMBED_RTOL, (name, _rel(a, b))
        else:
            assert _rel(a, b) <= RTOL, (name, _rel(a, b))


@pytest.mark.parametrize("case", list(CASES))
def test_train_matches_the_reference(runs, case):
    """Steps 2 and 3 on a model axis of 2, resumed from the reference's
    step-1 checkpoint: losses, grad norms and every parameter (the ranks'
    blocks put together) against the reference's unsharded run."""
    out = runs["ranks"][0]
    ref = {h["step"]: h for h in runs["ref"][case]["hist"]}
    assert list(out[case + "/steps"]) == [2, 3]
    for step, loss, gnorm in zip(out[case + "/steps"], out[case + "/loss"],
                                 out[case + "/grad_norm"]):
        assert _rel(loss, ref[step]["loss"]) <= RTOL
        assert _rel(gnorm, ref[step]["grad_norm"]) <= RTOL
    cfg, specs = _pspecs(case)
    names = [tree.keystr(p) for p, _ in tree.leaves_with_path(transformer.param_template(cfg))]
    _hold_leaves(_whole(runs["ranks"], case, "p", specs), runs["ref"][case]["params"], names, case)


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_leaves_are_bit_identical_across_ranks(runs, case):
    _, specs = _pspecs(case)
    a, b = (_leaves(r, case, "p") for r in runs["ranks"])
    replicated = [i for i, s in enumerate(specs) if tp.model_dim(s) is None]
    assert replicated and len(replicated) < len(specs)
    assert all(np.array_equal(a[i], b[i]) for i in replicated)
    assert all(np.array_equal(r[case + "/loss"], runs["ranks"][0][case + "/loss"])
               for r in runs["ranks"])


@pytest.mark.parametrize("case", list(CASES))
def test_blocks_are_the_layouts_slices(runs, case):
    """Each rank's parameter and optimizer-state blocks are the slices
    param_specs / state_specs give of the final whole-leaf checkpoint
    (which rank 0's model group gathered), bit for bit; each rank's init(0)
    blocks are the one-rank init's slices."""
    from repro_torch.launch import steps
    from repro_torch.train import restore_checkpoint

    cfg, _ = _pspecs(case)
    optimizer = CASES[case][2].get("optimizer")
    opt = steps.make_train_step(cfg, device="cpu", optimizer=optimizer)[1]
    pt = transformer.param_template(cfg)
    params, state = restore_checkpoint(runs["base"] / f"tp_{case}", 3, pt,
                                       opt.init(pt, device="meta"), device="cpu")[:2]
    pspecs = shd.param_specs(_Rank(0), pt)
    ospecs = tree.leaves(opt.state_specs(_Rank(0), pspecs, pt))
    for r, out in enumerate(runs["ranks"]):
        assert bool(out[case + "/init_blocks_equal"])
        for kind, whole, specs in (("p", params, tree.leaves(pspecs)),
                                   ("o", state, ospecs)):
            got = _leaves(out, case, kind)
            assert len(got) == len(specs) == len(tree.leaves(whole))
            for g, w, s in zip(got, tree.leaves(whole), specs):
                assert np.array_equal(g, _block(w.numpy(), s, r)), s


@pytest.mark.parametrize("case", ["h2o", "command_r", "qwen_experts"])
def test_checkpoint_restores_in_the_reference_and_on_one_rank(runs, case):
    """The tensor-parallel run's final checkpoint (whole leaves) restores in
    the reference and in a one-rank port process, each within RTOL of the
    reference's own step-3 parameters and optimizer state (command_r, with
    int8: up to 2 x MAX_INT8_FLIPS elements of its factored states above)."""
    from repro_torch.launch import steps
    from repro_torch.train import restore_checkpoint

    ref = runs["ref"][case]
    jp, jo = jrestore(runs["base"] / f"tp_{case}", 3, ref["jt"], ref["jot"])[:2]
    cfg, _ = _pspecs(case)
    names = [tree.keystr(p) for p, _ in tree.leaves_with_path(transformer.param_template(cfg))]
    _hold_leaves([np.asarray(x) for x in jax.tree.leaves(jp)], ref["params"], names, case)
    optimizer = CASES[case][2].get("optimizer")
    opt = steps.make_train_step(cfg, device="cpu", optimizer=optimizer)[1]
    pt = transformer.param_template(cfg)
    ot = opt.init(pt, device="meta")
    # an int8 quantum that flips between the packages (a gradient element at
    # a rounding boundary of g / scale) moves its row's vr and its column's
    # vc entry; without int8 every state element of this case reads within
    # RTOL
    int8 = CASES[case][2].get("grad_compression") == "int8"
    _hold_leaves([np.asarray(x) for x in jax.tree.leaves(jo)], ref["opt"],
                 [tree.keystr(p) for p, _ in tree.leaves_with_path(ot)], case,
                 flips=2 * MAX_INT8_FLIPS if int8 else 0)
    params = restore_checkpoint(runs["base"] / f"tp_{case}", 3, pt, ot, device="cpu")[0]
    assert all(np.array_equal(a.numpy(), np.asarray(b))
               for a, b in zip(tree.leaves(params), jax.tree.leaves(jp)))


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_the_reference(runs, case, monkeypatch):
    """make_serve_steps on the mesh: each rank's vocab block of the prefill
    and decode logits, its greedy token and its cache blocks against the
    reference's (cache_spec_for's layout of the reference's whole caches)."""
    monkeypatch.setenv("REPRO_KV_SEQ_SHARD", _kv_mode(case))
    ref = runs["ref"][case]
    cfg = _cfg(reduce_config, get_config, case)
    caches = transformer.cache_specs(cfg, B, CAPACITY)
    layouts = [shd.cache_spec_for(tree.path_str(p), s, _Rank(0))
               for p, s in tree.leaves_with_path(caches)]
    assert any(tp.model_dim(s) is not None for s in layouts)
    for r, out in enumerate(runs["ranks"]):
        n = out[case + "/prefill_logits"].shape[-1]
        assert n == cfg.padded_vocab // 2
        cut = slice(r * n, (r + 1) * n)
        assert _rel(out[case + "/prefill_logits"], ref["prefill"][..., cut]) <= RTOL
        for i in range(DECODE):
            assert _rel(out[f"{case}/decode_logits{i}"], ref["decode"][i][..., cut]) <= RTOL
            assert np.array_equal(out[f"{case}/decode_tok{i}"],
                                  np.argmax(ref["decode"][i][:, -1], axis=-1))
        got = _leaves(out, case, "c")
        assert len(got) == len(ref["caches"]) == len(layouts)
        for g, w, s in zip(got, ref["caches"], layouts):
            assert _rel(g, _block(w, s, r)) <= RTOL, s


def test_data_and_model_axes_together(runs):
    """h2o on a (2, 2) mesh (4 ranks): each data rank takes 2 rows, each
    model rank its blocks. Ranks (0, m) and (1, m) hold bit-equal blocks;
    the blocks put together meet the reference's unsharded run; the final
    checkpoint (gathered by rank 0's model group) restores in the
    reference and equals the blocks' slices."""
    cfg, specs = _pspecs("h2o")
    ref = runs["ref"]["h2o"]
    grid = runs["grid"]  # rank = 2 * data + model
    for m in (0, 1):
        a, b = _leaves(grid[m], "h2o", "p"), _leaves(grid[2 + m], "h2o", "p")
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    want = {h["step"]: h["loss"] for h in ref["hist"]}
    for step, loss in zip(grid[0]["h2o/steps"], grid[0]["h2o/loss"]):
        assert _rel(loss, want[step]) <= RTOL
    names = [tree.keystr(p) for p, _ in tree.leaves_with_path(transformer.param_template(cfg))]
    whole = _whole(grid[:2], "h2o", "p", specs)
    _hold_leaves(whole, ref["params"], names, "h2o")
    jp = jrestore(runs["base"] / "grid_h2o", 3, ref["jt"], ref["jot"])[0]
    assert all(np.array_equal(x, np.asarray(y)) for x, y in zip(whole, jax.tree.leaves(jp)))


@pytest.mark.parametrize("case", list(CASES))
def test_only_a_split_head_gathers(runs, case):
    """The model axis all-reduces; it all-gathers only where the kv heads
    do not divide it (k / v in a train step, the head_dim columns of the
    cache in a decode step)."""
    out = runs["ranks"][0]
    assert int(out[case + "/train_reduce"]) > 0
    gathers = int(out[case + "/train_gather"]), int(out[case + "/serve_gather"])
    if case == "kv_split":
        assert gathers[0] > 0 and gathers[1] > 0
    else:
        assert gathers == (0, 0)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "xlstm-125m", "whisper-base",
                                  "jamba-1.5-large-398b"])
def test_other_archs_wait_on_13j(arch):
    """Item 13j is done: MLA, xLSTM, whisper and jamba lay out on a model
    axis of 2, for training and serving (tests/test_torch_tp_mixers.py runs
    them); an axis of 3 divides none of their split widths (heads, d_inner)
    and is refused, and data parallel runs."""
    cfg = reduce_config(get_config(arch))
    tp.check_supported(cfg, shd.AbstractMesh((2, 2), ("data", "model")))
    tp.check_supported(cfg, shd.AbstractMesh((2, 2), ("data", "model")), serving=True)
    with pytest.raises(NotImplementedError, match="not a multiple of it"):
        tp.check_supported(cfg, shd.AbstractMesh((1, 3), ("data", "model")))
    tp.check_supported(cfg, shd.AbstractMesh((4, 1), ("data", "model")))  # data parallel runs


def test_a_sequence_sharded_cache_waits_on_13j(monkeypatch):
    """A KV cache over the sequence serves (item 13j is done), except where
    the axis divides neither the kv heads nor head_dim: a prompt it does not
    divide either would be replicated, a block the port could not tell from
    the rows of a sequence-sharded cache by its shape."""
    cfg = reduce_config(get_config("h2o-danube-1.8b"))
    mesh = shd.AbstractMesh((1, 2), ("data", "model"))
    tp.check_supported(cfg, mesh, serving=True)
    monkeypatch.setenv("REPRO_KV_SEQ_SHARD", "1")
    tp.check_supported(cfg, mesh, serving=True)
    odd = dataclasses.replace(cfg, num_kv_heads=2, head_dim=6)
    four = shd.AbstractMesh((1, 4), ("data", "model"))
    tp.check_supported(odd, four)  # training keeps no cache
    with pytest.raises(NotImplementedError, match="over the sequence"):
        tp.check_supported(odd, four, serving=True)
    monkeypatch.setenv("REPRO_KV_SEQ_SHARD", "0")
    tp.check_supported(odd, four, serving=True)


@pytest.mark.parametrize("arch", sorted(list_configs()))
def test_every_arch_runs_on_model_axes_2_and_8(arch, monkeypatch):
    """tp.check_supported refuses none of the registered archs on model
    axes 2 and 8 (the production mesh's), for training and serving, under
    every KV layout policy."""
    cfg = get_config(arch)
    for mode in ("0", "1", "auto"):
        monkeypatch.setenv("REPRO_KV_SEQ_SHARD", mode)
        for m in (2, 8):
            mesh = shd.AbstractMesh((32 // m, m), ("data", "model"))
            tp.check_supported(cfg, mesh)
            tp.check_supported(cfg, mesh, serving=True)
