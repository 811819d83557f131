"""Data-parallel training of the port on 2 gloo ranks (the CPU), against one
process and against the reference's unsharded train.

The reference trains reduced h2o-danube (f32) for 4 steps, global batch 4,
checkpointing after steps 1 and 3. Every port run below resumes from a
copy of its step-1 checkpoint, so all start from the same weights and
state, and runs steps 2 and 3 (the reference's AdamW, global batch 4):
  - one process, no mesh;
  - 2 ranks (one subprocess each, a FileStore, started once for the module)
    on a (2, 1) ("data", "model") mesh, then on a 1-D ("data",) mesh: each
    rank takes 2 rows, weights its loss and gradients by its mask share and
    sums them over the data group.
The (2, 1) mesh also runs steps 2 and 3 with microbatch 1 (each rank's 2
rows are 2 microbatches; a rank weighted by its share of the rows), held
against the reference's unsharded run with microbatch 1 resumed from the
same checkpoint: the mean of the 4 microbatches' means. The ranks also train
a global batch of 3 from init (which the data axis does not divide:
replicated, the gradients averaged), held against one process's run of it,
and ask for a (1, 2) mesh and for a global batch of 12 with microbatch 4
(6 rows a rank, not whole microbatches), each refused before any
collective.

Tolerances: every rank's parameters bit-identical (one all-reduce result,
one update rule); losses and final parameters within 1e-5 relative per leaf
of the one-process run and of the reference (f32 sums of two half batches
in place of one, and across packages).
"""

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
from repro.models import build_model as jbuild
from repro.optim import optimizer as jopt
from repro.train import LoopConfig as JLoopConfig
from repro.train import restore_checkpoint as jrestore
from repro.train import train as jtrain
from repro_torch import tree
from repro_torch.configs import get_config, reduce_config
from repro_torch.train import LoopConfig, latest_step, train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
ARCH = "h2o-danube-1.8b"
LOOP = dict(total_steps=4, seq_len=16, global_batch=4, ckpt_every=2, log_every=0, keep_ckpts=3)
REPLICATED = dict(global_batch=3, total_steps=3, ckpt_every=0)  # from init, no checkpoint
MICRO = dict(microbatch=1)
PARTIAL = dict(global_batch=12, microbatch=4)

_SCRIPT = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out_dir = sys.argv[1]
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                        rank=rank, world_size=world)

from repro_torch import tree
from repro_torch.configs import get_config, reduce_config
from repro_torch.train import LoopConfig, train, train_loop

LOOP = {LOOP}
cfg = reduce_config(get_config({ARCH!r}))
last = {{}}
make = train_loop.steps_mod.make_train_step
# every rank's final parameters (only rank 0 writes checkpoints)


def recording(*args, **kw):
    step, opt, model = make(*args, **kw)

    def wrapped(params, opt_state, batch, step_t):
        out = step(params, opt_state, batch, step_t)
        last["params"] = out[0]
        return out

    return wrapped, opt, model


train_loop.steps_mod.make_train_step = recording
out = {{}}
for tag, shape, names, extra in (
    ("dp2x1", (2, 1), ("data", "model"), {{}}),
    ("dp2", (2,), ("data",), {{}}),
    ("replicated", (2, 1), ("data", "model"), {REPLICATED}),
    ("dp_mb", (2, 1), ("data", "model"), {MICRO}),
):
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    loop = LoopConfig(ckpt_dir=os.path.join(out_dir, tag), **dict(LOOP, **extra))
    hist = train(cfg, loop, mesh=mesh, device="cpu")
    out[tag + "/steps"] = np.array([h["step"] for h in hist])
    out[tag + "/loss"] = np.array([h["loss"] for h in hist])
    out[tag + "/batch"] = np.array(train_loop.DataParallel(mesh, loop.global_batch).batch_slice.indices(99)
                                   if loop.global_batch % 2 == 0 else [-1])
    for i, leaf in enumerate(tree.leaves(last["params"])):
        out["%s/p%d" % (tag, i)] = leaf.detach().numpy()

for tag, shape, extra, exc_type in (("tp", (1, 2), {{}}, NotImplementedError),
                                    ("partial", (2, 1), {PARTIAL}, ValueError)):
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    before = train_loop.COLLECTIVES["all_reduce"]
    try:
        train(cfg, LoopConfig(ckpt_dir=os.path.join(out_dir, tag), **dict(LOOP, **extra)),
              mesh=mesh, device="cpu")
        out[tag + "/refused"] = np.array("")
    except exc_type as exc:
        out[tag + "/refused"] = np.array(str(exc))
    out[tag + "/collectives"] = np.array(train_loop.COLLECTIVES["all_reduce"] - before)
np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **out)
dist.destroy_process_group()
'''


def _params_at(ckpt_dir, step, cfg):
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.train import restore_checkpoint

    t = transformer.param_template(cfg)
    opt_t = steps.make_train_step(cfg, device="cpu")[1].init(t, device="meta")
    return restore_checkpoint(ckpt_dir, step, t, opt_t, device="cpu")[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run, one port process and the 2 ranks' outputs."""
    base = tmp_path_factory.mktemp("dp")
    jcfg, cfg = jreduce(jget(ARCH)), reduce_config(get_config(ARCH))
    ref_hist = jtrain(jcfg, JLoopConfig(ckpt_dir=str(base / "ref"), **LOOP))
    for tag in ("single", "dp2x1", "dp2", "dp_mb", "ref_mb"):
        shutil.copytree(base / "ref", base / tag, ignore=shutil.ignore_patterns("step_00000003"))
        assert latest_step(base / tag) == 1
    ref_mb_hist = jtrain(jcfg, JLoopConfig(ckpt_dir=str(base / "ref_mb"), **LOOP, **MICRO))
    single = train(cfg, LoopConfig(ckpt_dir=str(base / "single"), **LOOP), device="cpu")
    single3 = train(cfg, LoopConfig(ckpt_dir=str(base / "single3"), **dict(LOOP, **REPLICATED)),
                    device="cpu")

    script = base / "ranks.py"
    script.write_text(textwrap.dedent(_SCRIPT).format(LOOP=repr(LOOP), ARCH=ARCH,
                                                          REPLICATED=repr(REPLICATED),
                                                          MICRO=repr(MICRO),
                                                          PARTIAL=repr(PARTIAL)))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), WORLD_SIZE="2",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(base)], cwd=ROOT,
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    errs = []
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=240)
            if proc.returncode:
                errs.append(f"rank {r} exited {proc.returncode}:\n{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not errs, "\n".join(errs)
    ranks = [dict(np.load(base / f"rank{r}.npz")) for r in range(2)]

    jt = jax.eval_shape(jbuild(jcfg).init, jax.ShapeDtypeStruct((2,), jax.numpy.uint32))
    jot = jax.eval_shape(jopt.make_adamw().init, jt)
    ref_params, ref_mb_params = (jrestore(base / d, 3, jt, jot)[0] for d in ("ref", "ref_mb"))
    return dict(base=base, cfg=cfg, ref_hist=ref_hist, single=single, single3=single3, ranks=ranks,
                ref_params=[np.asarray(x) for x in jax.tree.leaves(ref_params)],
                ref_mb_hist=ref_mb_hist,
                ref_mb_params=[np.asarray(x) for x in jax.tree.leaves(ref_mb_params)],
                single_params=[t.numpy() for t in tree.leaves(_params_at(base / "single", 3, cfg))])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _rank_params(out, tag):
    n = len([k for k in out if k.startswith(tag + "/p")])
    return [out[f"{tag}/p{i}"] for i in range(n)]


@pytest.mark.parametrize("tag", ["dp2x1", "dp2", "replicated", "dp_mb"])
def test_every_rank_holds_the_same_parameters(runs, tag):
    a, b = (_rank_params(r, tag) for r in runs["ranks"])
    assert len(a) == len(b) > 0
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(runs["ranks"][0][tag + "/loss"], runs["ranks"][1][tag + "/loss"])


@pytest.mark.parametrize("tag", ["dp2x1", "dp2"])
def test_data_parallel_matches_one_process_and_the_reference(runs, tag):
    out = runs["ranks"][0]
    assert list(out[tag + "/steps"]) == [2, 3]
    assert [tuple(r[tag + "/batch"][:2]) for r in runs["ranks"]] == [(0, 2), (2, 4)]
    single = {h["step"]: h["loss"] for h in runs["single"]}
    ref = {h["step"]: h["loss"] for h in runs["ref_hist"]}
    for step, loss in zip(out[tag + "/steps"], out[tag + "/loss"]):
        np.testing.assert_allclose(loss, single[step], rtol=RTOL)
        np.testing.assert_allclose(loss, ref[step], rtol=RTOL)
    params = _rank_params(out, tag)
    for ours, one, theirs in zip(params, runs["single_params"], runs["ref_params"]):
        assert _rel(ours, one) <= RTOL and _rel(ours, theirs) <= RTOL
    # rank 0 wrote the final checkpoint: the parameters it trained
    final = [t.numpy() for t in tree.leaves(_params_at(runs["base"] / tag, 3, runs["cfg"]))]
    assert all(np.array_equal(x, y) for x, y in zip(final, params))


def test_microbatched_data_parallel_matches_the_reference(runs):
    """Microbatch 1 on 2 ranks against the reference's unsharded run with
    microbatch 1: every microbatch trained, each weighted 1/4."""
    out = runs["ranks"][0]
    assert list(out["dp_mb/steps"]) == [2, 3]
    ref = {h["step"]: h["loss"] for h in runs["ref_mb_hist"]}
    for step, loss in zip(out["dp_mb/steps"], out["dp_mb/loss"]):
        np.testing.assert_allclose(loss, ref[step], rtol=RTOL)
    for ours, theirs in zip(_rank_params(out, "dp_mb"), runs["ref_mb_params"]):
        assert _rel(ours, theirs) <= RTOL


def test_a_batch_the_axis_does_not_divide_is_replicated_and_trains(runs):
    """Every rank runs the whole batch of 3 from init(0); the average of two
    equal gradients is each of them, so the run is one process's."""
    out = runs["ranks"][0]
    assert list(out["replicated/steps"]) == [0, 1, 2]
    assert np.isfinite(out["replicated/loss"]).all()
    np.testing.assert_allclose(out["replicated/loss"], [h["loss"] for h in runs["single3"]],
                               rtol=RTOL)


@pytest.mark.parametrize("tag,message", [
    ("tp", "item 13b (tensor-parallel training)"),
    ("partial", "gives each 6 rows, not a multiple of microbatch 4"),
])
def test_refused_before_any_collective(runs, tag, message):
    """A model axis of 2, and a global batch of 12 with microbatch 4 on 2
    ranks (the reference trains its 3 microbatches; a rank's 6 rows are not
    whole microbatches)."""
    for out in runs["ranks"]:
        assert message in str(out[tag + "/refused"])
        assert int(out[tag + "/collectives"]) == 0


def test_model_axis_refused_without_a_process_group():
    """DataParallel refuses from the mesh's sizes alone."""
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.train.train_loop import DataParallel

    with pytest.raises(NotImplementedError, match="item 13b"):
        DataParallel(AbstractMesh((2, 2), ("data", "model")), 4)
    with pytest.raises(ValueError, match="not a multiple of microbatch 4"):
        DataParallel(AbstractMesh((2, 1), ("data", "model")), 12, microbatch=4)


def test_a_bf16_gradient_is_weighted_in_f32():
    """A rank's weight (here 1/3, a data axis of 3) scales a bf16 gradient in
    f32 and rounds once: in bf16 the weight itself would round to 0.33398,
    scaling every element about 0.2 % high."""
    import torch

    from repro_torch.train.train_loop import DataParallel

    g = torch.Generator().manual_seed(0)
    t = torch.randn(4096, generator=g).to(torch.bfloat16)
    want = (t.float() * (1.0 / 3.0)).to(torch.bfloat16)
    weight = torch.tensor(1.0, dtype=torch.float32) / 3.0
    DataParallel._reduce(None, t, [], weight=weight)  # no group: the weighting alone
    assert torch.equal(t, want)
    assert not torch.equal(want, t * weight.to(torch.bfloat16))
